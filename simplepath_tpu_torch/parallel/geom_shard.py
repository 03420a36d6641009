"""Geometry sharding: the BVH record table split into a forest of D
sub-BVHs, each query run once per shard and the shards' answers combined.

Counterpart of ``simplepath_tpu/parallel/geom_shard.py``.  The triangle
soup is cut into D spatially coherent slices (Morton order of the
centroids), each slice gets its own sub-BVH, and the packed record tables
are zero-padded and stacked to ``[D, M, 128]``.  Each shard's leaves index
its contiguous slice of the globally reordered triangle table
(``pack_records(base_offset=...)``), so a combined hit carries an ordinary
triangle index and shading, NEE and autodiff downstream are unchanged.

Where the shards live is a :class:`GeomMesh`: one process may hold all D
(the 1-D layout on one device: D launches a query, then the combine), or
the shards are spread over ranks, each rank keeping only its own, as each
JAX process keeps only its addressable shards.  With ``n_rays > 1`` the
ranks form an ``n_rays x (world / n_rays)`` grid (rays x geom): the ranks of
one row hold the whole forest between them and render the same block of
each pixel chunk, so the combine is a collective over that row only, and
the film of a chunk is gathered over a column.

The combine (:func:`sharded_closest`, :func:`sharded_anyhit`) calls the
same wrappers as the unsharded path, ``cuda_traverse.closest`` / ``anyhit``,
on each local shard: the CUDA kernels on CUDA tensors, their plain versions
on CPU tensors.  Closest hit: the least t wins and the lowest shard index
breaks a tie on equal t (the JAX package's ``pmin`` over ``axis_index``);
any-hit: the OR over shards.

Usage (one process, four shards on its device):

    mesh = make_geom_mesh(4)
    scene = shard_scene_geometry(load_scene(path, use_bvh=False), mesh)
    img = render_image_geom_sharded(scene, spp, key)
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch import Tensor

from ..device import resolve_device
from ..render import cuda_traverse
from ..scene.types import BVHArrays, Scene, TriangleArrays
from .mesh import RayMesh, all_reduce
from .multihost import render_image_multihost

__all__ = ["GeomMesh", "make_geom_mesh", "shard_scene_geometry",
           "sharded_closest", "sharded_anyhit", "render_image_geom_sharded"]


@dataclasses.dataclass(frozen=True)
class GeomMesh:
    """Where the D shards of a forest live.  This process renders ray block
    ``ray_index`` of ``n_rays`` and holds the shards ``shards`` (global
    indices, ascending).  ``group`` is the process group of the ranks that
    combine a query with it, its ray block (None: this process holds every
    shard); ``ray_group`` holds one rank of each ray block, this process's
    column of the grid (None: one ray block)."""
    n_geom: int
    n_rays: int
    ray_index: int
    shards: tuple
    group: Any = None
    ray_group: Any = None

    def ray_mesh(self, device=None) -> RayMesh:
        """The ray blocks as a :class:`~.mesh.RayMesh` on ``device``: what
        ``multihost.train_step_multihost`` splits a batch over, so that the
        ranks of one ray block take the same pixels (their gradients are
        equal, and the all-reduce runs over the ray blocks only)."""
        return RayMesh(self.ray_index, self.n_rays, self.ray_group,
                       resolve_device(device))


def make_geom_mesh(n_geom: int, n_rays: int = 1,
                   timeout: datetime.timedelta | None = None) -> GeomMesh:
    """The layout of an ``n_geom``-shard forest over the ranks of the
    default process group (one process when none is initialised).

    ``n_rays`` ray blocks split the world into rows of ``world / n_rays``
    ranks; the ``n_geom`` shards divide evenly over the ranks of a row, a
    rank holding a contiguous run of them.  Every rank must call this with
    the same arguments: on a grid of several rows and columns it creates a
    process group for each row and each column, with ``timeout``."""
    if n_geom < 1 or n_rays < 1:
        raise ValueError(f"need n_geom >= 1 and n_rays >= 1, got {n_geom}, "
                         f"{n_rays}")
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    if world % n_rays:
        raise ValueError(f"{n_rays} ray blocks do not divide {world} ranks")
    cols = world // n_rays
    if n_geom % cols:
        raise ValueError(f"{n_geom} shards do not divide over the {cols} "
                         "ranks of a ray block")
    per = n_geom // cols
    row, col = divmod(rank, cols)
    kw = {} if timeout is None else {"timeout": timeout}
    # every rank creates every group, in the same order: the rows, then
    # the columns; a group of the whole world is the default group
    group = ray_group = None
    if cols > 1:
        group = dist.group.WORLD
    if n_rays > 1:
        ray_group = dist.group.WORLD
    if cols > 1 and n_rays > 1:
        for r in range(n_rays):
            g = dist.new_group(list(range(r * cols, (r + 1) * cols)), **kw)
            group = g if r == row else group
        for c in range(cols):
            g = dist.new_group(list(range(c, world, cols)), **kw)
            ray_group = g if c == col else ray_group
    return GeomMesh(n_geom=n_geom, n_rays=n_rays, ray_index=row,
                    shards=tuple(range(col * per, (col + 1) * per)),
                    group=group, ray_group=ray_group)


def _local_mesh(n_geom: int) -> GeomMesh:
    return GeomMesh(n_geom=n_geom, n_rays=1, ray_index=0,
                    shards=tuple(range(n_geom)))


def scene_geom_mesh(scene: Scene) -> GeomMesh:
    """The layout of a geometry-sharded scene's forest: the scene's own, or
    every shard on this process (a forest carried over from the JAX package
    by ``convert.scene_from_numpy``)."""
    if not scene.static.geom_shards:
        raise ValueError("the scene is not geometry-sharded: build its "
                         "forest with shard_scene_geometry")
    return scene.geom_mesh or _local_mesh(scene.static.geom_shards)


# ------------------------------------------------------------- the forest

def _part1by2_64(a: np.ndarray) -> np.ndarray:
    """Spread the low 21 bits with two zero bits between each (u64)."""
    a = np.asarray(a, np.uint64) & np.uint64(0x1FFFFF)
    a = (a | (a << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    a = (a | (a << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    a = (a | (a << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    a = (a | (a << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    a = (a | (a << np.uint64(2))) & np.uint64(0x1249249249249249)
    return a


def _morton_slices(v0, v1, v2, n_shards: int) -> list[np.ndarray]:
    """Partition triangle indices into n_shards spatially coherent,
    near-equal contiguous runs: 3-D Morton order (21 bits an axis) of the
    quantized centroids, a stable argsort, then ``np.array_split``."""
    c = ((v0 + v1 + v2) / 3.0).astype(np.float64)
    lo, hi = c.min(0), c.max(0)
    q = np.clip((c - lo) / np.maximum(hi - lo, 1e-30) * ((1 << 21) - 1),
                0, (1 << 21) - 1).astype(np.uint64)
    key = ((_part1by2_64(q[:, 0]) << np.uint64(2))
           | (_part1by2_64(q[:, 1]) << np.uint64(1)) | _part1by2_64(q[:, 2]))
    order = np.argsort(key, kind="stable")
    return np.array_split(order, n_shards)


def _forest_cache_key(D: int, tables) -> str:
    """Hash of the forest's inputs: every table in full (positions and
    normals, which ride the cache in the reordered shading tables) and the
    shard count, salted with the package name, the builder version and the
    topology as ``scene.cache.geometry_cache_key`` salts its key."""
    from ..scene.bvh import LEAF_SIZE, RECORD_WIDTH, WIDTH
    from ..scene.cache import CACHE_VERSION
    h = hashlib.sha1()
    h.update(f"simplepath_tpu_torch:forest:v{CACHE_VERSION}:{LEAF_SIZE}:"
             f"{WIDTH}:{RECORD_WIDTH}:{D}:".encode())
    for arr in tables:
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def _build_forest(v0, v1, v2, n0, n1, n2, mid, D: int) -> dict:
    from ..scene.bvh import build_nodes, pack_records
    recs, global_order = [], []
    off = 0
    for sl in _morton_slices(v0, v1, v2, D):
        sv0, sv1, sv2 = v0[sl], v1[sl], v2[sl]
        lo = np.minimum(np.minimum(sv0, sv1), sv2)
        hi = np.maximum(np.maximum(sv0, sv1), sv2)
        nodes, order = build_nodes(lo, hi)
        recs.append(pack_records(nodes, sv0[order], sv1[order], sv2[order],
                                 base_offset=off))
        global_order.append(sl[order])
        off += len(sl)
    M = max(r.shape[0] for r in recs)
    stacked = np.zeros((D, M, recs[0].shape[1]), np.float32)
    for d, r in enumerate(recs):
        stacked[d, :r.shape[0]] = r
    order = np.concatenate(global_order)
    return dict(records=stacked, v0=v0[order], v1=v1[order], v2=v2[order],
                n0=n0[order], n1=n1[order], n2=n2[order],
                material_id=mid[order])


def shard_scene_geometry(scene: Scene, mesh: GeomMesh,
                         cache_dir: str | None = None) -> Scene:
    """Host-side forest build → the scene with ``bvh.records`` of
    ``[len(mesh.shards), M, 128]`` (this process's shards of the
    ``[D, M, 128]`` stack, on the scene's device), ``static.geom_shards =
    D`` and triangle tables reordered globally so that each shard's leaves
    index a contiguous slice.  Every rank builds the same forest (the build
    is deterministic) and keeps its own shards.

    The scene may be loaded with ``use_bvh=False``: an existing BVH order
    is discarded.  Raises ``ValueError`` with fewer triangles than shards.
    With ``cache_dir`` the forest (Morton sort and D sub-BVH builds) is
    kept in that directory's ``.spcache/`` under a hash of the triangle
    content and D (``scene.cache``: the port's own entries; meshes below
    ``CACHE_MIN_TRIS`` are not cached)."""
    from ..scene import cache

    D = mesh.n_geom
    tri = scene.triangles
    n_tris = int(tri.v0x.shape[0])
    if n_tris < D:
        raise ValueError(
            f"geometry sharding needs at least one triangle per shard: "
            f"scene has {n_tris} triangle(s), requested {D} shard(s)")
    rows = lambda name: tri._stack(name).cpu().numpy()
    tables = [rows(n) for n in ("v0", "v1", "v2", "n0", "n1", "n2")]
    tables.append(tri.material_id.cpu().numpy())

    key = forest = None
    if cache_dir is not None:
        key = _forest_cache_key(D, tables)
        forest = cache.load_geometry(cache_dir, key)
    if forest is None:
        forest = _build_forest(*tables, D)
        if key is not None:
            cache.save_geometry(cache_dir, key, forest)

    dev = scene.device
    records = torch.from_numpy(forest["records"][list(mesh.shards)]).to(dev)
    triangles = TriangleArrays.from_rows(
        forest["v0"], forest["v1"], forest["v2"], forest["n0"], forest["n1"],
        forest["n2"], forest["material_id"]).to_device(dev)
    static = dataclasses.replace(scene.static, has_bvh=True, geom_shards=D)
    return dataclasses.replace(scene, static=static, triangles=triangles,
                               bvh=BVHArrays(records=records), geom_mesh=mesh)


# ------------------------------------------------------------ the combine

def _check_forest(records: Tensor, mesh: GeomMesh) -> None:
    if records.dim() != 3 or records.shape[0] != len(mesh.shards):
        raise ValueError(
            f"a forest of {mesh.n_geom} shard(s), {len(mesh.shards)} on this "
            f"process, needs records [{len(mesh.shards)}, M, 128]; got "
            f"{tuple(records.shape)}")


def _t_order(t: Tensor) -> Tensor:
    """int64 keys that order like the float32 ``t`` (-0.0 as +0.0)."""
    b = (t + 0.0).view(torch.int32)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b).to(torch.int64)


def _t_from_order(k: Tensor) -> Tensor:
    b = k.to(torch.int32)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b).view(torch.float32)


def sharded_closest(records: Tensor, ro: Tensor, rd: Tensor, t_min: Tensor,
                    t_max: Tensor, mesh: GeomMesh | None = None):
    """Closest triangle hit over the forest → (t, idx, beta, gamma, valid),
    the outputs of ``cuda_traverse.closest``.

    ``records``: this process's shards, ``[len(mesh.shards), M, 128]``
    (``mesh=None``: every shard, on this process).  Each shard's closest
    hit comes from ``cuda_traverse.closest``; a miss counts as t = +inf.
    The least t wins, the lowest global shard index breaks a tie, and t,
    idx, beta and gamma come from the winner; ``valid`` is true where any
    shard hit, and a miss is t = +inf, idx = -1, beta = gamma = 0.  Across
    ranks: one all-reduce MIN of the (t, shard) key, then one all-reduce
    SUM of the winner's fields (exact: every other rank adds zeros)."""
    mesh = mesh or _local_mesh(records.shape[0])
    _check_forest(records, mesh)
    keys, fields = [], []
    for i, shard in enumerate(mesh.shards):
        t, fi, beta, gamma, valid = cuda_traverse.closest(
            records[i], ro, rd, t_min, t_max)
        t = torch.where(valid, t, float("inf"))
        keys.append((_t_order(t) << 32) | shard)
        fields.append(torch.stack([fi.to(torch.float64), beta.to(torch.float64),
                                   gamma.to(torch.float64)]))
    best, at = torch.stack(keys).min(dim=0)
    picked = torch.stack(fields).gather(
        0, at.view(1, 1, -1).expand(1, 3, -1))[0]
    if mesh.group is not None:
        won = all_reduce(best.clone(), dist.ReduceOp.MIN, mesh.group)
        picked = torch.where(best == won, picked, 0.0)
        picked = all_reduce(picked, dist.ReduceOp.SUM, mesh.group)
        best = won
    t = _t_from_order(best >> 32)
    valid = t != float("inf")
    idx = torch.where(valid, picked[0].to(torch.int32), -1)
    beta = torch.where(valid, picked[1].to(torch.float32), 0.0)
    gamma = torch.where(valid, picked[2].to(torch.float32), 0.0)
    return t, idx, beta, gamma, valid


def sharded_anyhit(records: Tensor, ro: Tensor, rd: Tensor, t_min: Tensor,
                   t_max: Tensor, mesh: GeomMesh | None = None) -> Tensor:
    """Occlusion over the forest: the OR of ``cuda_traverse.anyhit`` over
    the shards (across ranks, one all-reduce MAX)."""
    mesh = mesh or _local_mesh(records.shape[0])
    _check_forest(records, mesh)
    occ = torch.zeros(ro.shape[0], dtype=torch.bool, device=ro.device)
    for i in range(len(mesh.shards)):
        occ = occ | cuda_traverse.anyhit(records[i], ro, rd, t_min, t_max)
    if mesh.group is not None:
        occ = all_reduce(occ.to(torch.uint8), dist.ReduceOp.MAX,
                         mesh.group).to(torch.bool)
    return occ


# ------------------------------------------------------------- the frame

def render_image_geom_sharded(scene: Scene, spp: int, key: Tensor,
                              mesh: GeomMesh | None = None,
                              integrator: str | None = None,
                              chunk_rays: int = 1 << 16,
                              spp_offset: int = 0, device=None) -> Tensor:
    """Full-frame render of a geometry-sharded scene → [H, W, 3] on every
    rank (on its device).

    The traversal sends every query of a geometry-sharded scene through the
    combine, so the frame is ``multihost.render_image_multihost`` over the
    forest's ray blocks: with one ray block every rank renders every chunk,
    with several each renders its block of each chunk of ``chunk_rays``
    pixels (rounded up to a multiple of the ray blocks) and the chunk's film
    is all-gathered.  ``mesh`` defaults to the scene's own
    (``shard_scene_geometry``); another raises.  Every rank passes the same
    scene and key and receives the whole film.  ``device=None`` means CUDA
    and raises without one."""
    own = scene_geom_mesh(scene)
    if mesh is not None and mesh != own:
        raise ValueError("the scene's forest was sharded for another mesh")
    per_rank = -(-chunk_rays // own.n_rays)
    return render_image_multihost(scene, spp, key, integrator,
                                  mesh=own.ray_mesh(device),
                                  chunk_rays=per_rank, spp_offset=spp_offset)
