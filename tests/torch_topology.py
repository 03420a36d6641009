"""Run a part of tests/test_torch_traverse.py in a subprocess at a BVH
topology other than the default, for the tests/test_torch_topology_*.py
files.

The knobs (SIMPLEPATH_BVH_WIDTH, SIMPLEPATH_BVH_LEAF) are read when both
packages are imported, so each setting needs a process of its own, as
tests/test_topology_env.py runs the JAX package's.  The selection is the
plain versions and the scene-level queries against the JAX package on
g_blob, split in three parts so that each file stays well under a minute:
the per-ray XLA traversal ``_bvh_closest`` / ``_bvh_any`` with the stack
caps, the interpreted Pallas ``packet_closest`` / ``packet_anyhit``, and
``scene_intersect_batch`` / ``scene_intersect_p_batch``.  Tolerances are
that file's: valid and idx exact, t rtol 1e-5, beta/gamma rtol 1e-4,
occlusion exact.
"""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAVERSE = os.path.join(ROOT, "tests", "test_torch_traverse.py")
KNOBS = ("SIMPLEPATH_BVH_WIDTH", "SIMPLEPATH_BVH_LEAF")
W16 = {"SIMPLEPATH_BVH_WIDTH": "16"}       # wide nodes, the 63-pair network
K24 = {"SIMPLEPATH_BVH_LEAF": "24"}        # two-row leaves
K29 = {"SIMPLEPATH_BVH_LEAF": "29"}        # three-row leaves, three-float meta
W16_K29 = {**W16, **K29}                   # both at once
# part -> (-k expression, the number of tests it selects)
PARTS = {"bvh": ("bvh_closest or bvh_any or stack_limit", 9),
         "packet": ("packet", 2),
         "scene": ("scene_intersect_batch or scene_intersect_p_batch", 6)}
TIMEOUT_S = 400


def run_part(knobs: dict, part: str) -> None:
    """Run ``part`` of test_torch_traverse.py with ``knobs`` set (and every
    other knob at its default); fail unless all of its tests pass."""
    expr, count = PARTS[part]
    env = {k: v for k, v in os.environ.items() if k not in KNOBS}
    env.update(knobs)
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", TRAVERSE, "-k", expr],
        env=env, capture_output=True, text=True, timeout=TIMEOUT_S, cwd=ROOT)
    tail = out.stdout[-3000:] + out.stderr[-2000:]
    assert out.returncode == 0, tail
    summary = out.stdout.strip().splitlines()[-1]
    passed = re.search(r"(\d+) passed", summary)
    assert passed and int(passed.group(1)) == count, tail
    assert not re.search(r"failed|error|skipped|xfail", summary), tail
