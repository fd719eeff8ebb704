"""Sharded steps on ``torch.distributed`` (port of ``miso_tpu/parallel``):
``sharding.py`` (the mesh, the data-parallel and submap-parallel steps, the
alignment's pair axis), ``pretrain.py`` (scene-parallel decoder
pretraining), ``spatial.py`` (a grid split into x-slabs) and
``distributed.py`` (process-group start-up)."""
from miso_tpu_torch.parallel.sharding import (  # noqa: F401
    make_mesh,
    shard_batch,
    replicate,
    data_parallel_train_step,
    submap_parallel_fusion_step,
)
