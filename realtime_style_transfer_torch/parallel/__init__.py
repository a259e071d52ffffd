"""Data parallelism over a ``torch.distributed`` group: the port of
``realtime_style_transfer_tpu/parallel`` on its data axis (``spatial=1``)."""

from . import distributed  # noqa: F401
from .infer import DistributedStylizer, FusedStreamStylizer  # noqa: F401
from .mesh import (  # noqa: F401
    DATA_AXIS,
    SPATIAL_AXIS,
    Mesh,
    batch_sharding,
    make_mesh,
    replicate,
    replicated,
    shard_batch,
)
from .train import DistributedTrainer  # noqa: F401
