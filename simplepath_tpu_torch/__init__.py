"""simplepath_tpu_torch: the PyTorch/CUDA port of the simplepath_tpu path
tracer, for one NVIDIA Hopper GPU.

Same layout and names as the JAX package (``core``, ``scene``, ``render``,
``parallel``, ``io``, ``native``) so each module's counterpart is easy to
find; PyTorch idiom inside: plain functions over batched tensors
(``[N,3]``, ``[N]``), a ``Scene`` dataclass of tensors with ``.to(device)``,
an explicit ``device`` argument and a Python bounce loop.  The two BVH
traversal kernels are hand-written CUDA C++ (``csrc/traverse.cu``), built
with ``nvcc`` at first use and bound through ctypes
(``render/cuda_traverse.py``).

The package imports ``torch`` and ``numpy`` only — never ``jax`` and nothing
of ``simplepath_tpu``.
"""

from . import device as _device  # pins IEEE float32 (no TF32) at import
from .device import resolve_device
from .scene.build import build_scene, load_scene
from .scene.parser import parse_sp
from .render.film import render_image, render_rays

__version__ = "0.1.0"
__all__ = ["build_scene", "load_scene", "parse_sp", "render_image",
           "render_rays", "resolve_device"]
