"""The port's traversal at SIMPLEPATH_BVH_LEAF=24: 24-triangle leaves over two record rows.

Checks the scene-level queries (``scene_intersect_batch`` /
``scene_intersect_p_batch``) against the JAX package's, on g_blob,
g_glossy and g_mesh_ply, in a subprocess (tests/torch_topology.py).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_topology import K24, run_part  # noqa: E402


def test_k24_scene_matches_the_jax_package():
    run_part(K24, "scene")
