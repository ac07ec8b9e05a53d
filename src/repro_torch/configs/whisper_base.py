"""Whisper-base [arXiv:2212.04356; unverified] — encoder-decoder audio.

6L enc + 6L dec, d_model=512 8H d_ff=2048 vocab=51865.  The conv frontend
is a STUB: input_specs() provides precomputed 1500-frame embeddings (30 s
of audio after the conv downsampler).  Decode shapes exercise the decoder
serve_step with cross-attention to the fixed encoder memory.
Full attention enc-dec -> long_500k SKIPPED.
"""
from repro_torch.models.config import Activation, BranchSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", family="audio", enc_dec=True,
        n_layers=6, n_enc_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
        head_dim=64, d_ff=2048, vocab_size=51865, enc_len=1500,
        layernorm=True, glu=False, activation=Activation.GELU,
        use_rope=False, learned_pos=True, max_seq_len=32768, remat="none",
        branch=BranchSpec(layer=2, grid=38, n_classes=8, kind="ic",
                          head_dim=256),
    )
