"""RWKV-6 "Finch" 3B [arXiv:2404.05892; hf] — attention-free, data-dependent
decay linear recurrence.

32L d_model=2560 d_ff=8960 vocab=65536, head size 64 (40 rwkv heads).
O(T) state recurrence -> RUNS long_500k (with the chunked TPU kernel).
"""
from repro_torch.models.config import BlockKind, BranchSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b", family="ssm", block=BlockKind.RWKV6,
        n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
        d_ff=8960, vocab_size=65536, rwkv_head_dim=64,
        use_rope=False, max_seq_len=524288, remat="selective",
        branch=BranchSpec(layer=6, grid=56, n_classes=8, kind="ic",
                          head_dim=256),
    )
