from repro_torch.models.config import (BlockKind, BranchSpec, ModelConfig,
                                       ShapeCell, SHAPE_CELLS, shape_cell,
                                       reduce_for_smoke,
                                       supports_long_context)
from repro_torch.models import layers, model

__all__ = ["BlockKind", "BranchSpec", "ModelConfig", "ShapeCell",
           "SHAPE_CELLS", "shape_cell", "reduce_for_smoke",
           "supports_long_context", "layers", "model"]
