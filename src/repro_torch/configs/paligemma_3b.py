"""PaliGemma-3B [arXiv:2407.07726; hf] — SigLIP + Gemma prefix-VLM.

Gemma backbone: 18L d_model=2048 8H (MQA kv=1, head_dim 256) d_ff=16384
(GeGLU) vocab=257216.  The SigLIP tower is a STUB: input_specs() provides
256 precomputed patch embeddings; attention is bidirectional on the image
prefix + causal on the text suffix (prefix-LM).
Full attention -> long_500k SKIPPED.

This is the most literal carrier of the paper's technique: the patch grid
IS the CAM spatial grid (16x16 patches), so IC/OD filter branches localise
objects on actual image coordinates.
"""
from repro_torch.models.config import Activation, BranchSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b", family="vlm",
        n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
        d_ff=16384, vocab_size=257216, vlm_prefix=256,
        activation=Activation.GELU, scale_embed=True,
        rope_theta=10000.0, max_seq_len=32768, remat="selective",
        branch=BranchSpec(layer=4, grid=16, n_classes=8, kind="od",
                          head_dim=256),
    )
