from ctseg_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    batch_sharding,
    make_mesh,
    make_spatial_mesh,
    replicated,
)
