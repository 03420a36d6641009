"""Carry a scene built by the JAX package over to the port.

``scene_from_numpy`` takes numpy only — the static config as a dict and the
scene's arrays keyed by field path — so this module imports nothing of JAX.
The caller (a test, a migration script) does the JAX side:

    static_fields = dataclasses.asdict(jax_scene.static)
    arrays = {"triangles.v0x": np.asarray(jax_scene.triangles.v0x), ...,
              "bvh.records": ..., "camera.eye": ...}

Field paths are ``"<group>.<field>"`` with the group and field names of
``scene/types.py`` (identical in both packages).  A group the JAX scene does
not have (``bvh`` or ``env`` is None there) is simply absent from ``arrays``.
``params_from_numpy`` / ``params_to_numpy`` carry ``diff.grad``'s parameter
dict the same way, so both packages can be handed identical parameters.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import resolve_device
from .scene.build import finalize_scene
from .scene.types import (BVHArrays, CameraArrays, EnvLightArrays,
                          MaterialArrays, PlaneArrays, Scene, SceneStatic,
                          SphereArrays, SphereLightArrays, TriangleArrays)

__all__ = ["scene_from_numpy", "params_from_numpy", "params_to_numpy"]

_GROUPS = {"spheres": SphereArrays, "planes": PlaneArrays,
           "triangles": TriangleArrays, "bvh": BVHArrays,
           "materials": MaterialArrays, "sphere_lights": SphereLightArrays,
           "env": EnvLightArrays, "camera": CameraArrays}
_OPTIONAL = {"bvh", "env"}


def _group(cls, name: str, arrays: dict):
    fields = [f.name for f in dataclasses.fields(cls) if f.name != "rho_table"]
    present = [f for f in fields if f"{name}.{f}" in arrays]
    if not present and name in _OPTIONAL:
        return None
    missing = sorted(set(fields) - set(present))
    if missing:
        raise KeyError(f"arrays lack {name}.{missing[0]} "
                       f"(and {len(missing) - 1} more)")
    return cls(**{f: torch.from_numpy(np.array(arrays[f"{name}.{f}"]))
                  for f in fields})


def scene_from_numpy(static_fields: dict, arrays: dict, device=None) -> Scene:
    """The port's ``Scene`` from the JAX package's scene, handed over as
    ``dataclasses.asdict(scene.static)`` plus its arrays as numpy, keyed by
    field path.  The materials' rho table is built here, once.  ``device=
    None`` means CUDA and raises without one."""
    device = resolve_device(device)
    static = SceneStatic(**static_fields)
    if static.geom_shards:
        raise NotImplementedError(
            "geometry-sharded scenes are ported in a later slice of "
            "simplepath_tpu_torch")
    groups = {name: _group(cls, name, arrays) for name, cls in _GROUPS.items()}
    return finalize_scene(Scene(static=static, **groups), device)


def params_from_numpy(arrays: dict, device=None) -> dict:
    """A parameter dict of ``diff.grad`` from numpy arrays keyed as the JAX
    package's ``get_params`` keys them (float32, on ``device``; None means
    CUDA and raises without one)."""
    device = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, np.float32)).to(device)
            for k, v in arrays.items()}


def params_to_numpy(params: dict) -> dict:
    """A parameter (or gradient) dict as numpy arrays, detached."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
