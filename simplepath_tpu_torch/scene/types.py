"""The scene as dataclasses of SoA tensors.

Counterpart of ``simplepath_tpu/scene/types.py``: every Hitable / Material /
Light hierarchy of the C++ reference becomes a table of parameters plus an
integer type tag; virtual dispatch becomes branchless selects over those
tags.  Field names, shapes and dtypes are the JAX package's (float32 /
int32), so a scene converts field by field (``convert.py``).

Static shape/config data (counts, depths, integrator choice) lives in the
hashable ``SceneStatic``.  ``Scene.to(device)`` moves every tensor.  A
geometry-sharded scene also carries the layout of its forest over the ranks
(``Scene.geom_mesh``), as a JAX array carries its sharding.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

__all__ = [
    "SphereArrays", "PlaneArrays", "TriangleArrays", "BVHArrays",
    "MaterialArrays", "SphereLightArrays", "EnvLightArrays", "CameraArrays",
    "SceneStatic", "Scene",
    "MAT_LAMBERTIAN", "MAT_GLOSSY",
    "ENV_NONE", "ENV_CONST", "ENV_IBL",
    "INTEGRATORS",
]

MAT_LAMBERTIAN = 0
MAT_GLOSSY = 1

ENV_NONE = 0
ENV_CONST = 1
ENV_IBL = 2

# IntegratorType names of the scene DSL (the parser validates against this
# list)
INTEGRATORS = (
    "mandelbrot",
    "brute_force",
    "brute_force_iterative",
    "brute_force_iterative_rr",
    "iterative_rrnee",
    "direct_lighting",
    "whitted",
    "brute_force_iterative_dynamic_rr",
)


def _tensor_dataclass(cls):
    """Frozen dataclass of tensors with a ``.to_device(device)`` that maps
    over its fields (None fields pass through).  Not ``.to``: the camera has
    a field of that name."""
    cls = dataclasses.dataclass(frozen=True)(cls)

    def to_device(self, device):
        return type(self)(**{
            f.name: (None if getattr(self, f.name) is None
                     else getattr(self, f.name).to(device))
            for f in dataclasses.fields(self)})

    cls.to_device = to_device
    return cls


@_tensor_dataclass
class SphereArrays:
    """Unit spheres + affine transforms."""
    o2w_l: Any   # [S,3,3]
    o2w_t: Any   # [S,3]
    w2o_l: Any   # [S,3,3]
    w2o_t: Any   # [S,3]
    material_id: Any  # [S] int32


@_tensor_dataclass
class PlaneArrays:
    """y=0 planes + affine transforms."""
    o2w_l: Any
    o2w_t: Any
    w2o_l: Any
    w2o_t: Any
    material_id: Any


@_tensor_dataclass
class TriangleArrays:
    """World-space baked triangle soup, stored as PER-COMPONENT 1-D tensors
    (the JAX package's layout, kept so scenes convert field by field).  Hot
    paths gather components and stack AFTER the gather (``gather_row``); the
    stacked row properties are for host-side use and small brute-force
    scenes."""
    v0x: Any  # [T] vertex components
    v0y: Any
    v0z: Any
    v1x: Any
    v1y: Any
    v1z: Any
    v2x: Any
    v2y: Any
    v2z: Any
    n0x: Any  # [T] shading-normal components
    n0y: Any
    n0z: Any
    n1x: Any
    n1y: Any
    n1z: Any
    n2x: Any
    n2y: Any
    n2z: Any
    material_id: Any  # [T] int32

    @classmethod
    def from_rows(cls, v0, v1, v2, n0, n1, n2, material_id):
        """Build from [T,3] numpy row arrays."""
        comps = {}
        for name, arr in (("v0", v0), ("v1", v1), ("v2", v2),
                          ("n0", n0), ("n1", n1), ("n2", n2)):
            arr = np.asarray(arr, np.float32)
            for k, ax in enumerate("xyz"):
                comps[f"{name}{ax}"] = torch.from_numpy(
                    np.ascontiguousarray(arr[:, k]))
        mid = torch.from_numpy(np.ascontiguousarray(material_id, np.int32))
        return cls(material_id=mid, **comps)

    def _stack(self, name):
        return torch.stack([getattr(self, name + ax) for ax in "xyz"], dim=-1)

    @property
    def v0(self):
        return self._stack("v0")

    @property
    def v1(self):
        return self._stack("v1")

    @property
    def v2(self):
        return self._stack("v2")

    @property
    def n0(self):
        return self._stack("n0")

    @property
    def n1(self):
        return self._stack("n1")

    @property
    def n2(self):
        return self._stack("n2")

    def gather_row(self, name: str, idx):
        """Stacked [..,3] of table ``name`` at ``idx`` (gathers the 1-D
        component tensors first)."""
        return torch.stack([getattr(self, name + ax)[idx] for ax in "xyz"],
                           dim=-1)


@_tensor_dataclass
class BVHArrays:
    """Flattened wide BVH over the triangles, as a unified record table:
    one 512-byte f32 row per node (internal OR leaf) so every traversal step
    is a single wide row fetch.  See ``scene/bvh.py`` for the row format."""
    records: Any    # [M,128] f32 (refs/indices stored as exact f32 values)


@_tensor_dataclass
class MaterialArrays:
    """Flattened material table.

    The DSL's closed material algebra is:
      lambertian | glossy(=Beckmann microfacet + lambertian, one-sample MIS)
      optionally wrapped in a clearcoat layer.
    One record per material: base_type tags the base; has_clearcoat gates the
    layer.  ``rho_table`` is the microfacet lobe's directional-albedo table
    (``render.materials.build_rho_tables``).  ``render_rays`` builds it
    anew from the materials on every call, as the JAX package does, so a
    replaced material never renders with a stale table; a built scene
    carries None ("not built yet").
    """
    base_type: Any      # [M] int32
    albedo: Any         # [M,3] lambertian diffuse color
    roughness: Any      # [M] beckmann roughness (glossy only)
    ior: Any            # [M] microfacet fresnel ior (glossy only)
    has_clearcoat: Any  # [M] int32 0/1
    cc_ior: Any         # [M]
    cc_color: Any       # [M,3]
    rho_table: Any = None  # [M, RHO_TABLE_SIZE] or None


@_tensor_dataclass
class SphereLightArrays:
    """Sphere area lights."""
    o2w_l: Any
    o2w_t: Any
    w2o_l: Any
    w2o_t: Any
    radiance: Any  # [L,3]


@_tensor_dataclass
class EnvLightArrays:
    """Environment light.  For ENV_CONST only ``radiance`` is meaningful and
    the image/CDF fields are dummies; for ENV_IBL they hold the radiance
    image and the sampling tables of its luminance (``core.distribution``:
    conditional rows, marginal over the rows)."""
    radiance: Any      # [3]
    image: Any         # [H,W,3] or dummy [1,1,3]
    l2w: Any           # [3,3]
    w2l: Any           # [3,3]
    cdf_cond_f: Any    # [nv,nu]
    cdf_cond: Any      # [nv,nu+1]
    cdf_cond_int: Any  # [nv]
    cdf_marg_f: Any    # [nv]
    cdf_marg: Any      # [nv+1]
    cdf_marg_int: Any  # []


@_tensor_dataclass
class CameraArrays:
    """User-level perspective-camera parameters; the raster→world bake
    happens in ``render.camera.camera_vectors``."""
    eye: Any    # [3] camera origin ("origin:" in the .sp DSL)
    to: Any     # [3] look-at point
    up: Any     # [3] up vector
    fov: Any    # [] vertical field of view, degrees
    wh: Any     # [2] film (width, height) as f32


@dataclasses.dataclass(frozen=True)
class SceneStatic:
    """Hashable static scene config."""
    width: int
    height: int
    max_depth: int
    russian_roulette_depth: int
    integrator: str          # one of INTEGRATORS, resolved w/ CLI precedence
    num_spheres: int
    num_planes: int
    num_triangles: int
    num_sphere_lights: int
    env_kind: int            # ENV_NONE / ENV_CONST / ENV_IBL
    num_materials: int
    has_bvh: bool
    output_file_name: str = "image.pfm"
    # reverse-mode rendering (diff/grad.py): every bounce runs under
    # torch.utils.checkpoint, and the coherence sort is off
    differentiable: bool = False
    # D > 0: the BVH is a forest of D sub-BVHs (parallel/geom_shard.py),
    # bvh.records [shards on this process, M, 128]
    geom_shards: int = 0


@dataclasses.dataclass(frozen=True)
class Scene:
    """The full scene: static config + tensor tables."""
    static: SceneStatic
    spheres: SphereArrays
    planes: PlaneArrays
    triangles: TriangleArrays
    bvh: BVHArrays | None
    materials: MaterialArrays
    sphere_lights: SphereLightArrays
    env: EnvLightArrays | None
    camera: CameraArrays
    # where the shards of a geometry-sharded scene live
    # (parallel.geom_shard.GeomMesh); None: every shard on this process
    geom_mesh: Any = None

    def to(self, device) -> "Scene":
        return Scene(
            static=self.static, geom_mesh=self.geom_mesh,
            **{f.name: (None if getattr(self, f.name) is None
                        else getattr(self, f.name).to_device(device))
               for f in dataclasses.fields(self)
               if f.name not in ("static", "geom_mesh")})

    @property
    def device(self) -> torch.device:
        return self.camera.eye.device
