"""The port's traversal at SIMPLEPATH_BVH_WIDTH=16 and SIMPLEPATH_BVH_LEAF=29:
16-wide nodes with three-row leaves (two leaf slots a lane).

Checks the scene-level queries (``scene_intersect_batch`` /
``scene_intersect_p_batch``) against the JAX package's, on g_blob,
g_glossy and g_mesh_ply, in a subprocess (tests/torch_topology.py).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_topology import W16_K29, run_part  # noqa: E402


def test_w16_k29_scene_matches_the_jax_package():
    run_part(W16_K29, "scene")
