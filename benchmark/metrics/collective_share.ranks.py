"""NCCL kernels' device time over rank 0's profiled window, in %; nothing
in a cell of one process."""


def read(r):
    if r.get("ranks", 1) < 2 or not r.get("window_s"):
        return None
    return 100.0 * r["nccl_s"] / r["window_s"]
