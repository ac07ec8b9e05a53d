# Fleet serving on one card: S camera streams through one staged plan
# (multistream); error-feedback int8 gradient compression over a
# torch.distributed group is in ``compression``.  The JAX package's mesh
# path (sharding, pipeline, serve_attention, ctx) has no counterpart
# yet: one card has no device mesh to shard over.
from repro_torch.distributed import multistream

__all__ = ["multistream"]
