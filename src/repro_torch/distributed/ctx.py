"""Activation-sharding context (the JAX package's ``distributed/ctx.py``).

Models stay mesh-agnostic; the sharded steps install a sharder so that
intermediate activations are laid out batch -> ("pod", "data") without
threading mesh objects through model code.  JAX installs it at trace
time; here it is installed around the eager run, and ``constrain`` is a
``redistribute`` of a DTensor to the batch placement (the identity on a
plain tensor, and always the identity with no sharder installed).

``decode_shard`` routes single-token cached attention through the
sequence-sharded path (``distributed.serve_attention``) while it is
installed.  Both are thread-local.
"""
from __future__ import annotations

import contextlib
import sys
import threading
from typing import Callable, Optional

import torch

_state = threading.local()


def _get() -> Optional[Callable]:
    return getattr(_state, "sharder", None)


@contextlib.contextmanager
def activation_sharder(fn: Callable[[torch.Tensor, str], torch.Tensor]):
    prev = _get()
    _state.sharder = fn
    try:
        yield
    finally:
        _state.sharder = prev


def constrain(x: torch.Tensor, kind: str = "act") -> torch.Tensor:
    fn = _get()
    return fn(x, kind) if fn is not None else x


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor.  No DTensor exists before its module
    is imported, so a one-card run pays a dict lookup, not an import."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


# --- sequence-sharded decode attention (serving fast path) ----------------

def _get_ds() -> Optional[dict]:
    return getattr(_state, "decode_shard", None)


@contextlib.contextmanager
def decode_shard(mesh, seq_axis: str = "model"):
    """Route single-token cached attention through the sequence-sharded
    path (``repro_torch.distributed.serve_attention``) while installed.
    The batch split is the cache's own placement (JAX's ``batch_axes``
    has no counterpart)."""
    prev = _get_ds()
    _state.decode_shard = {"mesh": mesh, "seq_axis": seq_axis}
    try:
        yield
    finally:
        _state.decode_shard = prev


def get_decode_shard() -> Optional[dict]:
    return _get_ds()
