"""Seconds from the process's start to set-up's ``load_scene``, on the
harness's clock: the interpreter, the imports, the CUDA context and the check
of the configuration's files (over several GPUs: from the starting process's
start, torchrun and the process group with it, to rank 0's load).  The part
of ``setup_s`` that no span of the program covers."""


def read(r):
    return r.get("before_load_s")
