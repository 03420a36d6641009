#!/usr/bin/env python3
"""Time builds of the CUDA traversal kernels against each other on one GPU,
on the ray sets of chip_smoke.py (primary, incoherent, and the real
wavefronts of bounces 0, 2 and 5 of one rendered chunk of the bench scene).

    python3 tools/torch_kernel_variants.py \\
        --variant new=simplepath_tpu_torch/csrc/traverse.cu \\
        --variant old=some/other/checkout/simplepath_tpu_torch/csrc/traverse.cu

A variant is ``name=source[:nvcc flag[,flag...]]``: any source with the C
interface of csrc/traverse.cu (``sp_closest`` / ``sp_anyhit``), so an earlier
revision of the file can stand beside the present one.  Every variant is
built with the package's nvcc flags at this process's BVH topology
(``-DSP_W`` / ``-DSP_K``, set by SIMPLEPATH_BVH_WIDTH / _LEAF; a source
without the parameters ignores them) plus its own into
``simplepath_tpu_torch/build/variants/``, held against the plain PyTorch
versions on every ray set (exact ``valid`` / ``idx`` / ``occluded``, equal
t / beta / gamma), and timed with CUDA events in rounds that run the
variants forwards, then backwards, so that none always runs first.

Prints one JSON object per line: ``card``, one ``build`` per variant (what
ptxas reports), one ``time`` per kernel and ray set with each variant's best
and median milliseconds per launch.  Needs one CUDA device; imports nothing
of JAX.  The render path never uses these builds.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DEFAULT_VARIANTS = ["new=simplepath_tpu_torch/csrc/traverse.cu"]


def launcher(lib, kernel: str, records, rays):
    """A closure that launches ``kernel`` of ``lib`` on the rays into its own
    output buffers, and the buffers."""
    ro, rd, t_min, t_max = rays
    n, dev = ro.shape[0], ro.device
    f32 = lambda: torch.empty(n, dtype=torch.float32, device=dev)
    t, beta, gamma = f32(), f32(), f32()
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    flag = torch.empty(n, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ins = [x.data_ptr() for x in (records, ro, rd, t_min, t_max)]

    if kernel == "closest":
        outs = (t, idx, beta, gamma, flag)

        def launch():
            err = lib.sp_closest(*ins, n, t.data_ptr(), idx.data_ptr(),
                                 beta.data_ptr(), gamma.data_ptr(),
                                 flag.data_ptr(), stream)
            if err:
                raise RuntimeError(f"sp_closest: cudaError {err}")
    else:
        outs = (flag,)

        def launch():
            err = lib.sp_anyhit(*ins, n, flag.data_ptr(), stream)
            if err:
                raise RuntimeError(f"sp_anyhit: cudaError {err}")
    return launch, outs


def disagreements(kernel: str, outs, ref) -> int:
    """Values of a variant's outputs that differ from the plain version's."""
    if kernel == "anyhit":
        return int((outs[0].bool() != ref).sum())
    t, idx, beta, gamma, flag = outs
    rt, ridx, rbeta, rgamma, rvalid = ref
    valid = flag.bool()
    bad = int((valid != rvalid).sum()) + int((idx != ridx).sum())
    h = valid & rvalid
    for a, b in ((t, rt), (beta, rbeta), (gamma, rgamma)):
        bad += int((a[h] != b[h]).sum())
    return bad + int((~torch.isinf(t[~valid])).sum())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=None,
                    help="name=source[:flag,flag]; default: "
                         + DEFAULT_VARIANTS[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--launches", type=int, default=50,
                    help="launches per timing")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1

    import chip_smoke as cs
    import simplepath_tpu_torch as sp
    from simplepath_tpu_torch.render import cuda_traverse as ct

    print(json.dumps({"card": cs.nvidia_smi_line()}), flush=True)
    libs = {}
    for spec in args.variant or DEFAULT_VARIANTS:
        name, _, rest = spec.partition("=")
        source, _, flags = rest.partition(":")
        out = os.path.join(ct.BUILD_DIR, "variants", f"libsp_traverse_{name}.so")
        log = ct._compile_source(os.path.join(ROOT, source), out,
                                tuple(f for f in flags.split(",") if f),
                                verbose=True)
        libs[name] = ct._bind_library(out)
        print(json.dumps({"build": name, "source": source, "flags": flags,
                          "ptxas": log.splitlines()}), flush=True)

    scene = sp.load_scene(cs.SCENE)
    records = scene.bvh.records
    sets = cs.kernel_ray_sets(scene)
    order = list(libs)
    for kernel in ("closest", "anyhit"):
        plain = ct.closest_plain if kernel == "closest" else ct.anyhit_plain
        for case, rays in sets[kernel].items():
            ref = plain(records, *rays)
            runs = {}
            for name, lib in libs.items():
                launch, outs = launcher(lib, kernel, records, rays)
                launch()
                torch.cuda.synchronize()
                bad = disagreements(kernel, outs, ref)
                if bad:
                    raise AssertionError(f"variant {name}: {kernel} differs "
                                         f"from its plain version on {case} "
                                         f"rays in {bad} values")
                runs[name] = launch
            ms = {name: [] for name in libs}
            for r in range(args.rounds):
                for name in (order if r % 2 == 0 else order[::-1]):
                    ms[name].append(cs.time_cuda(runs[name], args.launches))
            print(json.dumps({"time": kernel, "case": case,
                              "n": int(rays[0].shape[0]),
                              "ms_best": {k: min(v) for k, v in ms.items()},
                              "ms_median": {k: statistics.median(v)
                                            for k, v in ms.items()}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
