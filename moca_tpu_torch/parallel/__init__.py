from moca_tpu_torch.parallel.mesh import (  # noqa: F401
    initialize_distributed, make_mesh, make_sharded_unet_apply, shard_rows,
)
