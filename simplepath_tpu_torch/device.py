"""Device rule and float32 pinning for the port.

Every entry point of the package takes ``device=None`` meaning ``"cuda"``.
With no CUDA device that raises: the port never silently carries on on the
CPU.  Tests (and anyone who really wants the plain PyTorch path) pass
``device="cpu"`` explicitly.

IEEE float32 is pinned once, here, at import: TF32 is switched off for
matrix products and cuDNN, so the hit arithmetic of the CUDA kernels and of
their plain PyTorch versions stays identical (the JAX package keeps the same
property across its two traversal paths).
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` → the current CUDA device (raises when there is none);
    anything else → ``torch.device(device)`` as asked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "simplepath_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' explicitly to run the plain "
                "PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device "
                           "is available")
    return dev
