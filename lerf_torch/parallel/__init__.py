"""Parallelism over a device mesh: spatially sharded resampling and
data-parallel training (the port of ``lerf_tpu.parallel``).

One process drives a :class:`~.mesh.Mesh` of ``torch.device``s, one shard
each, a device possibly repeated (``["cuda:0"] * 4``: four shards on one
card, a stream each); the spatial functions (:mod:`.spatial`) compute a
window of output rows a shard, and the predictors' ``mesh=`` and the
trainer's ``data_axis`` split a batch across the shards.
"""

from .mesh import (
    DATA_AXIS,
    Mesh,
    RowShards,
    all_gather_rows,
    exchange_halos,
    make_mesh,
    maybe_init_distributed,
    replicate,
    row_ranges,
    shard_batch,
)
from .spatial import (
    imdn_stages_sharded,
    imdn_stages_sharded_exchange,
    lut_stages_sharded,
    sharded_dynamic_sr_pipeline,
    sharded_devgeo_warp_pipeline,
    sharded_dynamic_warp_pipeline,
    sharded_imdn_sr_pipeline,
    sharded_imdn_warp_pipeline,
    sharded_lut_sr_pipeline,
    sharded_lut_warp_pipeline,
    sharded_net_sr_pipeline,
    srnet_stages_sharded,
    steering_gaussian_resize_rings_sharded,
    steering_gaussian_resize_sharded,
    steering_gaussian_warp_rings_sharded,
    steering_gaussian_warp_sharded,
)


def batch_sharding(mesh: Mesh, axis: str = DATA_AXIS):
    """lerf_tpu's sharding of the batch axis: here the split itself —
    :func:`shard_batch` places a batch by it."""
    return lambda batch: shard_batch(batch, mesh, axis)


def replicated(mesh: Mesh):
    """lerf_tpu's replicated sharding: here the placement itself —
    :func:`replicate` places a tree by it."""
    return lambda tree: replicate(tree, mesh)


__all__ = ["DATA_AXIS", "make_mesh", "batch_sharding", "replicated",
           "shard_batch", "replicate",
           "steering_gaussian_resize_sharded",
           "steering_gaussian_warp_sharded",
           "lut_stages_sharded", "sharded_lut_sr_pipeline",
           "sharded_lut_warp_pipeline",
           "steering_gaussian_warp_rings_sharded",
           "sharded_dynamic_warp_pipeline",
           "sharded_devgeo_warp_pipeline",
           "steering_gaussian_resize_rings_sharded",
           "sharded_dynamic_sr_pipeline",
           "srnet_stages_sharded", "sharded_net_sr_pipeline",
           "imdn_stages_sharded", "imdn_stages_sharded_exchange",
           "sharded_imdn_sr_pipeline",
           "sharded_imdn_warp_pipeline",
           "Mesh", "RowShards", "all_gather_rows", "exchange_halos",
           "maybe_init_distributed", "row_ranges"]
