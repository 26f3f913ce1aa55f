"""Multi-rank training and rendering over `torch.distributed`; port of
`mtgs_tpu/parallel/`.

JAX expresses these as `shard_map` over a `jax.sharding.Mesh` in one
process; the port runs one process per rank (`mesh.launch`, or any
launcher that initialises the default process group), a mesh axis being a
process group (`mesh.make_mesh`):

  * data_parallel.py — cameras split over the `data` axis, parameters
    replicated, gradients and densify statistics reduced, one identical
    update on every rank;
  * tile_parallel.py — one view's rasterization split over a tile axis
    (`rasterize(mesh=...)`: the band, ownership, layered and classic
    sharded pipelines);
  * mesh2d.py — cameras x tiles on a 2D mesh;
  * collectives.py — the collectives, with JAX's transposes.
"""

from mtgs_torch.parallel.mesh import make_mesh
from mtgs_torch.parallel.data_parallel import make_dp_train_step
