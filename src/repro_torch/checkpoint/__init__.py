from repro_torch.checkpoint import manager

__all__ = ["manager"]
