from gpe_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh, batch_pspecs, shard_batch, make_parallel_loss, make_parallel_step,
    initialize_multihost, make_ensemble_step, shard_ensemble,
)
