from repro_torch.train import filter_train

__all__ = ["filter_train"]
