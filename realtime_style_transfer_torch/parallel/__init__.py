"""The ``(data, spatial)`` mesh over a ``torch.distributed`` group: the port
of ``realtime_style_transfer_tpu/parallel``."""

from . import distributed  # noqa: F401
from .infer import DistributedStylizer, FusedStreamStylizer  # noqa: F401
from .mesh import (  # noqa: F401
    DATA_AXIS,
    SPATIAL_AXIS,
    Mesh,
    batch_sharding,
    frame_rows,
    make_mesh,
    replicate,
    replicated,
    shard_batch,
)
from .spatial import RowShard, row_split  # noqa: F401
from .train import DistributedTrainer  # noqa: F401
