from stablediffusion_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    MeshSpec,
    data_sharding,
    make_mesh,
    maybe_initialize_distributed,
    replicated,
    shard_batch,
)
