from repro_torch.train import filter_train, losses, step

__all__ = ["filter_train", "losses", "step"]
