"""Work over several ranks or shards: ray sharding (``mesh``,
``multihost``) and geometry sharding over a BVH forest (``geom_shard``)."""

from .geom_shard import (GeomMesh, make_geom_mesh, render_image_geom_sharded,
                         shard_scene_geometry, sharded_anyhit,
                         sharded_closest)
from .mesh import (RayMesh, make_ray_mesh, render_image_sharded,
                   replicate_scene, shard_pixels, warmup_render)
from .multihost import (init_distributed, render_image_multihost,
                        train_step_multihost)

__all__ = ["GeomMesh", "RayMesh", "init_distributed", "make_geom_mesh",
           "make_ray_mesh", "render_image_geom_sharded",
           "render_image_multihost", "render_image_sharded",
           "replicate_scene", "shard_pixels", "shard_scene_geometry",
           "sharded_anyhit", "sharded_closest", "train_step_multihost",
           "warmup_render"]
