from yolort_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    data_parallel_infer,
    data_parallel_train_step,
    make_mesh,
    replicate,
    shard_batch,
)
