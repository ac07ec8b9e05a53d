# Fleet serving on one card: S camera streams through one staged plan
# (multistream).  The JAX package's mesh path (sharding) has no
# counterpart here: one card has no device mesh to shard streams over.
from repro_torch.distributed import multistream

__all__ = ["multistream"]
