from repro_torch.optim.optimizers import (Optimizer, adamw, apply_updates,
                                          chain, clip_by_global_norm,
                                          scale_by_schedule, sgd_momentum)
from repro_torch.optim.schedules import (constant, cosine_decay,
                                         exponential_decay, linear_warmup,
                                         warmup_cosine)

__all__ = ["Optimizer", "adamw", "apply_updates", "sgd_momentum",
           "clip_by_global_norm", "chain", "scale_by_schedule", "constant",
           "cosine_decay", "linear_warmup", "warmup_cosine",
           "exponential_decay"]
