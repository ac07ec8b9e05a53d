"""Measure two faults of the JAX package's attention that the port copies.

1. **Ring prefill.**  A sliding-window model's ring cache keeps only the
   last ``window`` prompt rows at prefill and then attends the whole
   prompt over those rows alone (``models/layers.py`` ``attention_block``),
   so a prompt longer than the window gives other last logits than the
   cache-less forward.  Measured on ``tests/test_models.py``'s BASE
   config (3 layers, d_model 64, float32) with ``sliding_window=8``, for
   the attention and the hybrid block, at prompts of 8 (inside the
   window) and 16 tokens.
2. **Prefix past a macro block.**  ``flash_attention_xla`` bounds a q
   macro block's keys by the causal diagonal (``hi``) and ignores the
   prefix-LM's bidirectional prefix, so where the prefix reaches past a
   block's last key chunk, that block misses prefix keys.  Measured on
   q (2, 96, 4, 16), k / v (2, 96, 1, 16), 4 macro blocks, chunks of 32,
   at prefixes of 16 (inside the first block's reach) and 40.

For each case it prints one JSON line: the reference's largest deviation
from the function it should compute, the largest value beside it, and
the port's largest deviation from the reference (the port follows it).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference_faults_probe.py

Needs both packages (jax and torch); runs in about a minute on a CPU.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import layers as RL
from repro.models import model as RM
from repro.models import serve as RSV
from repro.models.config import BlockKind as RBlock
from repro.models.config import ModelConfig as RConfig
from repro_torch.interop import params_from_numpy
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import serve as TSV
from repro_torch.models.config import BlockKind, ModelConfig

# tests/test_models.py's BASE, with the window the probe needs
BASE = dict(n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=128, dtype="float32", max_seq_len=128,
            attn_impl="xla_naive", scan_layers=True, sliding_window=8)


def _tree(x):
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    return np.asarray(x)


def ring_prefill(block: str, prompt_len: int) -> dict:
    rc = RConfig(name=block, block=RBlock(block), ssm_state=8, **BASE)
    tc = ModelConfig(name=block, block=BlockKind(block), ssm_state=8, **BASE)
    rp = RM.init_params(jax.random.PRNGKey(0), rc)
    tp = params_from_numpy(_tree(rp), "cpu")
    toks = np.random.default_rng(1).integers(0, 128, (2, prompt_len))
    cache = RSV.init_cache(rc, 2, prompt_len + 8)
    got, _, _ = RSV.prefill(rp, rc, jnp.asarray(toks), cache=cache)
    want = RM.forward(rp, rc, jnp.asarray(toks)).logits[:, -1]
    port, _, _ = TSV.prefill(tp, tc, torch.as_tensor(toks),
                             cache=TSV.init_cache(tc, 2, prompt_len + 8,
                                                  device="cpu"))
    return {"fault": "ring prefill", "block": block, "window": 8,
            "prompt": prompt_len,
            "ref_vs_cacheless": float(jnp.abs(got - want).max()),
            "max_abs_logit": float(jnp.abs(want).max()),
            "port_vs_ref": float(np.abs(port.numpy() - np.asarray(got))
                                 .max())}


def prefix_chunks(prefix: int) -> dict:
    rng = np.random.default_rng(2)
    q = rng.normal(0, 1, (2, 96, 4, 16)).astype(np.float32)
    k, v = (rng.normal(0, 1, (2, 96, 1, 16)).astype(np.float32)
            for _ in range(2))
    kw = dict(prefix_len=prefix, chunk=32, n_macro=4)
    got = RL.flash_attention_xla(q, k, v, **kw)
    want = RL.naive_attention(q, k, v, prefix_len=prefix)
    port = TL.flash_attention_xla(*(torch.as_tensor(a) for a in (q, k, v)),
                                  **kw)
    return {"fault": "prefix past a macro block", "prefix": prefix,
            "macro_block_rows": 24, "chunk": 32,
            "ref_vs_naive": float(jnp.abs(got - want).max()),
            "max_abs_out": float(jnp.abs(want).max()),
            "port_vs_ref": float(np.abs(port.numpy() - np.asarray(got))
                                 .max())}


def main() -> None:
    for block in ("attn", "hybrid"):
        for prompt_len in (8, 16):
            print(json.dumps(ring_prefill(block, prompt_len)), flush=True)
    for prefix in (16, 40):
        print(json.dumps(prefix_chunks(prefix)), flush=True)


if __name__ == "__main__":
    main()
