#!/usr/bin/env python3
"""The matched-spp golden tier's self-noise floors, measured with the port
on the GPU — the counterpart of tools/calibrate_floors.py.

    python3 tools/torch_calibrate_floors.py [scene ...]

Renders each scene of tests/golden/matched_floors.json (or the ones named)
twice at its golden's spp on the card, through ``render_image`` under keys
101 and 202 (independent of each other and of the golden tests' key 17).
Two such renders are independent Monte-Carlo estimates of one integral by
one estimator, so their error percentiles (chip_smoke.matched_metrics, the
matched tier's comparison) are the port's own noise floor.  Prints, a scene
a line, the port's floor beside the committed one and their ratio — near 1
where the port's estimator on the card has the JAX package's variance — and
writes the floors to chip_smoke_out/golden/matched_floors.json.  It never
writes under tests/.  Needs one CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

OUT = os.path.join(cs.OUT_DIR, "golden", "matched_floors.json")
KEYS = (101, 202)


def main(argv: list) -> int:
    committed = cs.golden_json("matched_floors.json")
    manifest = cs.golden_json("manifest.json")
    names = argv or sorted(committed)
    unknown = set(names) - set(committed)
    if unknown:
        raise SystemExit(f"not calibratable scenes: {sorted(unknown)} "
                         f"(choose from {sorted(committed)})")
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1

    print(f"card: {cs.nvidia_smi_line()}", flush=True)
    floors = {}
    for name in names:
        spp = manifest[name]["spp"]
        imgs, seconds = [], []
        for key in KEYS:
            img, s, _ = cs.golden_render(name, spp, key)
            imgs.append(img)
            seconds.append(s)
        floors[name] = cs.matched_metrics(*imgs)
        print(json.dumps({
            "scene": name, "spp": spp, "keys": list(KEYS),
            "render_s": seconds, "floor": floors[name],
            "committed": committed[name],
            "ratio": {k: v / committed[name][k]
                      for k, v in floors[name].items()}}), flush=True)

    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(floors, f, indent=1)
        f.write("\n")
    for k in ("rel_mean", "p90", "p99"):
        r = [floors[n][k] / committed[n][k] for n in names]
        print(f"{k}: port floor / committed floor {min(r):.3f}-{max(r):.3f} "
              f"over {len(r)} scenes", flush=True)
    print(f"wrote {OUT} ({len(floors)} scenes)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
