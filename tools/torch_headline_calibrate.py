#!/usr/bin/env python3
"""The headline golden tier with the port on the GPU — the counterpart of
tools/headline_calibrate.py and of tests/test_golden_parity.py's
test_headline_spp_matched.

    python3 tools/torch_headline_calibrate.py [--force]

Renders scenes/headline_parity.sp (the bench's four 81,920-triangle blobs
and its 0.01-roughness plane, 512x512, depth 10) at the golden's 512 spp
with keys 3 and 1003 through ``render_image_sharded``, in 32-spp passes
with ``spp_offset`` (absolute sample indices: the same film as one
uninterrupted render).  After every pass the running sum and the samples
done go to chip_smoke_out/golden/headline/ours_k<key>_512spp.ckpt.npz, so a
run that was cut resumes from its last pass; a finished render is kept
there as .npy and read back unless --force.

Prints the three metric rows of tools/headline_calibrate.py (ours against
ours: the port's own noise floor; the golden against key 3 and against key
1003), applies test_headline_spp_matched's gates to key 3 (1.5x the
committed calibration floor, the mean within 1 %), and writes its receipt
to chip_smoke_out/golden/headline.json (HEADLINE.json stays the TPU's).
Exits 1 when a gate fails.  Needs one CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import datetime
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

OUT = os.path.join(cs.OUT_DIR, "golden")
CACHE = os.path.join(OUT, "headline")
KEYS = (("k3", 3), ("k1003", 1003))
STEP = 32                       # spp a pass, as the headline test renders


def render_full(scene, spp: int, seed: int, ckpt_path: str,
                step: int = STEP) -> tuple:
    """The frame in ``step``-spp passes, the running sum checkpointed after
    each → (image float32, seconds of each pass run now)."""
    from simplepath_tpu_torch.core.rng import prng_key
    from simplepath_tpu_torch.parallel.mesh import render_image_sharded

    st = scene.static
    img = np.zeros((st.height, st.width, 3), np.float64)
    s_start = 0
    if os.path.exists(ckpt_path):
        d = np.load(ckpt_path)
        img, s_start = d["img"], int(d["s0"])
        print(f"  resuming from pass {s_start}", flush=True)
    key = prng_key(seed, scene.device)
    seconds = []
    for s0 in range(s_start, spp, step):
        cnt = min(step, spp - s0)   # a last short pass is weighted by cnt
        t0 = time.time()
        part = render_image_sharded(scene, cnt, key, spp_offset=s0,
                                    device=scene.device)
        img += part.cpu().numpy().astype(np.float64) * (cnt / spp)
        seconds.append(time.time() - t0)
        np.savez(ckpt_path, img=img, s0=s0 + cnt)
        print(f"  pass {s0:4d}+{cnt}: {seconds[-1]:.1f}s", flush=True)
    return img.astype(np.float32), seconds


def main() -> int:
    force = "--force" in sys.argv[1:]
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import simplepath_tpu_torch as sp
    from simplepath_tpu_torch.io.pfm import read_pfm

    card = cs.nvidia_smi_line()
    print(f"card: {card}", flush=True)
    info = cs.golden_json("manifest.json")["g_headline"]
    spp = info["spp"]
    scene = sp.load_scene(os.path.join(ROOT, info["scene"]))
    print(f"scene loaded: {scene.static.num_triangles} triangles, "
          f"{scene.static.width}x{scene.static.height}", flush=True)

    os.makedirs(CACHE, exist_ok=True)
    imgs, passes = {}, {}
    for name, seed in KEYS:
        path = os.path.join(CACHE, f"ours_{name}_{spp}spp.npy")
        ckpt = os.path.join(CACHE, f"ours_{name}_{spp}spp.ckpt.npz")
        if force:
            for f in (path, ckpt):
                if os.path.exists(f):
                    os.remove(f)
        if os.path.exists(path):
            imgs[name] = np.load(path)
            print(f"loaded {path}", flush=True)
            continue
        print(f"rendering {name} (seed {seed}) @ {spp}spp ...", flush=True)
        imgs[name], passes[name] = render_full(scene, spp, seed, ckpt)
        np.save(path, imgs[name])
        os.remove(ckpt)

    ref = read_pfm(os.path.join(cs.GOLDEN, "g_headline.pfm"))
    rows = [cs.headline_metrics(imgs["k3"], imgs["k1003"],
                                "ours_vs_ours (self-noise floor)"),
            cs.headline_metrics(ref, imgs["k3"], "ref_vs_ours_k3"),
            cs.headline_metrics(ref, imgs["k1003"], "ref_vs_ours_k1003")]
    for row in rows:
        print(json.dumps(row), flush=True)

    floor = next(c for c in cs.golden_json("headline_cache/calibration.json")
                 if c["label"].startswith("ours_vs_ours"))
    gates = cs.headline_gates(rows[1], floor)
    failed = cs.failed_gates(gates)
    receipt = {
        "scene": info["scene"], "spp": spp, "size": list(ref.shape[:2]),
        "card": card, "device": torch.cuda.get_device_name(0),
        "date": datetime.datetime.now().isoformat(timespec="seconds"),
        "metrics": {k: v for k, (v, _, _) in gates.items()},
        "gates": {k: g for k, (_, g, _) in gates.items()},
        "failed": failed, "floor": floor, "port_floor": rows[0],
        "port_floor_over_floor": {k: rows[0][k] / floor[k] for k in (
            "rel_mean", "p50", "p90", "p99", "blur_p99", "firefly_sym_p99")},
        "rows": rows, "pass_s": passes}
    with open(os.path.join(OUT, "headline.json"), "w") as f:
        json.dump(receipt, f, indent=1)
    print(json.dumps({k: receipt[k] for k in (
        "metrics", "gates", "failed", "port_floor_over_floor")}), flush=True)
    print(f"wrote {os.path.join(OUT, 'headline.json')}", flush=True)
    if failed:
        print("headline gates failed: " + ", ".join(failed), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
