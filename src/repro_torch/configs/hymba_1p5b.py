"""Hymba-1.5B [arXiv:2411.13676; hf] — hybrid parallel attention + Mamba heads.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Sub-quadratic at long context: Mamba branch is O(T); the attention branch
uses a sliding window (Hymba's global/local scheme -> local here), so this
arch RUNS long_500k.  Paper-technique branch attaches at layer 6 (~1/5 of
the stack, mirroring VGG19 k=5/19 and Darknet k=8/19 ratios).
"""
from repro_torch.models.config import BlockKind, BranchSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="hybrid", block=BlockKind.HYBRID,
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
        d_ff=5504, vocab_size=32001, ssm_state=16, ssm_expand=2,
        sliding_window=1024, max_seq_len=524288,
        rope_theta=10000.0, remat="selective",
        branch=BranchSpec(layer=6, grid=56, n_classes=8, kind="od",
                          head_dim=256),
    )
