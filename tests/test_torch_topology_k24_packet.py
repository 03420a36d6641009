"""The port's traversal at SIMPLEPATH_BVH_LEAF=24: 24-triangle leaves over two record rows.

Checks the plain versions against the JAX package's Pallas kernels
(``packet_closest`` / ``packet_anyhit``, interpreted) on g_blob, in a subprocess (tests/torch_topology.py).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_topology import K24, run_part  # noqa: E402


def test_k24_packet_matches_the_jax_package():
    run_part(K24, "packet")
