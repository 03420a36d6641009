"""The port's traversal at SIMPLEPATH_BVH_LEAF=29: 29-triangle leaves over
three record rows (9*29+3 = 264 floats), the leaf meta at a float offset
that is not a multiple of 4 (read as three floats), four leaf slots a lane
at W=8.

Checks the plain versions against the JAX package's per-ray XLA traversal
(``_bvh_closest`` / ``_bvh_any``) on g_blob, and the pack-time stack cap
against the JAX package's, in a subprocess (tests/torch_topology.py).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_topology import K29, run_part  # noqa: E402


def test_k29_bvh_matches_the_jax_package():
    run_part(K29, "bvh")
