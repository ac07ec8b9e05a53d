# The mesh path: logical-axis sharding rules onto DTensor placements
# (``sharding``), the activation and decode-shard contexts (``ctx``),
# sequence-sharded decode attention (``serve_attention``) and the GPipe
# pipeline (``pipeline``).  Fleet serving of S camera streams through
# one staged plan is ``multistream``; error-feedback int8 gradient
# compression over a torch.distributed group is ``compression``.  The
# package imports only ``ctx`` and ``sharding`` eagerly (as the JAX
# package does), since the model layers import ``ctx``.
from repro_torch.distributed import ctx, sharding

__all__ = ["ctx", "sharding"]
