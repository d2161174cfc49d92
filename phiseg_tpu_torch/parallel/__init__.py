from phiseg_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    init_distributed,
    init_distributed_from_env,
    make_mesh,
    make_sharded_sample_fn,
    resolve_device,
    shard_array,
    shard_host_batch,
    shard_train_step,
    spawn_ranks,
)
