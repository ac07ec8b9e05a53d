"""DeepSeek-Coder-33B [arXiv:2401.14196; hf] — llama-arch dense GQA.

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256.
Full attention -> long_500k SKIPPED.
"""
from repro_torch.models.config import BranchSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b", family="dense",
        n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
        d_ff=19200, vocab_size=32256,
        rope_theta=100000.0, max_seq_len=32768, remat="full",
        branch=BranchSpec(layer=12, grid=56, n_classes=8, kind="od",
                          head_dim=256),
    )
