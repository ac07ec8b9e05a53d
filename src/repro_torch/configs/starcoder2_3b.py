"""StarCoder2-3B [arXiv:2402.19173; hf] — GQA + RoPE, LayerNorm, plain MLP.

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.
Full attention -> long_500k SKIPPED.
"""
from repro_torch.models.config import Activation, BranchSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b", family="dense",
        n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, head_dim=128,
        d_ff=12288, vocab_size=49152, qkv_bias=True,
        layernorm=True, glu=False, activation=Activation.GELU,
        rope_theta=1e5, max_seq_len=32768, remat="selective",
        branch=BranchSpec(layer=6, grid=56, n_classes=8, kind="od",
                          head_dim=256),
    )
