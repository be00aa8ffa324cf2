from .mesh import (
    DATA_AXIS,
    SEQ_AXIS,
    Mesh,
    active_mesh,
    constrain_targets_seq,
    has_seq_axis,
    make_mesh,
    seq_shard,
    shard_batch,
    use_mesh,
)

__all__ = [
    "DATA_AXIS",
    "SEQ_AXIS",
    "Mesh",
    "make_mesh",
    "shard_batch",
    "constrain_targets_seq",
    "has_seq_axis",
    "seq_shard",
    "use_mesh",
    "active_mesh",
]
