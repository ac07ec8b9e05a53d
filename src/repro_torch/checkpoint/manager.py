"""Checkpointing: atomic, async, layout-free (the JAX package's
``checkpoint/manager.py``).

Format: one directory per step, ``step_<012d>/``, holding

    meta.json         — step, tree structure, each leaf's shape and dtype
    arr_<i>.npy       — one file per leaf, in sorted-key order

Leaves are numbered in sorted-key order, the order of JAX's tree
flattening, so for the same float32 state the port's ``arr_<i>.npy``
line up with the reference's file for file.  The reference writes its
metadata with msgpack; the port writes JSON (no msgpack dependency).
bfloat16 leaves, which numpy cannot hold, are stored as their 16-bit
patterns (``int16`` files named ``bfloat16`` in ``meta.json``) and
restored bit for bit.

- **atomicity**: written to ``<dir>/.tmp-<step>`` then renamed, so a
  crash mid-save never corrupts the latest checkpoint;
- **async**: ``save_async`` takes the snapshot when it is called (a
  device tensor's copy into pinned host memory is enqueued on the
  current stream, so later writes to it come after) and writes on a
  background thread once the copies are done, so training overlaps the
  copy and the disk write;
- **restore onto a device**: arrays are stored as plain tensors;
  ``restore`` places them on the device asked for (the reference's
  resharding restore on one card), in the target's dtypes;
- **retention**: the ``keep_n`` newest checkpoints are kept;
- **preemption**: ``PreemptionHandler`` turns SIGTERM into a final
  synchronous save at the next step boundary.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import threading
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

META = "meta.json"


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in sorted-key order (JAX's dict flattening)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def _unflatten(tree: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(tree)


def _host_copy(x: Any) -> Any:
    """A host copy of one leaf (never a view of a CPU tensor the caller
    may change).  A CUDA tensor is copied into pinned memory on the
    current stream without blocking: stream order puts the copy before
    any later write to the tensor."""
    if not isinstance(x, torch.Tensor):
        return np.array(x)
    x = x.detach()
    if x.device.type != "cuda":
        return x.to("cpu", copy=True)
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return host.copy_(x, non_blocking=True)


def _numpy(x: Any) -> np.ndarray:
    if isinstance(x, np.ndarray):
        return x
    return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()


def _snapshot(tree: Any):
    """Host copies of every leaf, in sorted-key order: (paths, copies,
    dtype names (``bfloat16`` for a bf16 leaf), the CUDA event after the
    last device copy or None)."""
    flat = _flatten(tree)
    host = [_host_copy(x) for _, x in flat]
    done = None
    if any(isinstance(x, torch.Tensor) and x.device.type == "cuda"
           for _, x in flat):
        done = torch.cuda.Event()
        done.record()
    dtypes = [str(x.dtype).replace("torch.", "") for x in host]
    return [p for p, _ in flat], host, dtypes, done


def save(path: str, tree: Any, step: int, keep_n: int = 3) -> str:
    """Synchronous atomic save.  Returns the final checkpoint dir."""
    return _write(path, *_snapshot(tree), step, keep_n)


def save_async(path: str, tree: Any, step: int, keep_n: int = 3
               ) -> threading.Thread:
    """Snapshot now (device tensors: copies enqueued on the current
    stream, which the writer waits for); write on a daemon thread."""
    snap = _snapshot(tree)
    t = threading.Thread(target=_write, args=(path, *snap, step, keep_n),
                         daemon=True)
    t.start()
    return t


def _write(path: str, paths: List[str], host: List[Any],
           dtypes: List[str], done: Optional[Any], step: int,
           keep_n: int) -> str:
    if done is not None:
        done.synchronize()
    host = [_numpy(x) for x in host]
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f".tmp-{step}")
    final = os.path.join(path, f"step_{step:012d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    meta = {"step": step, "treedef": paths,
            "leaves": [{"shape": list(a.shape), "dtype": d}
                       for a, d in zip(host, dtypes)]}
    for i, a in enumerate(host):
        np.save(os.path.join(tmp, f"arr_{i}.npy"), a)
    with open(os.path.join(tmp, META), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(path, keep_n)
    return final


def _gc(path: str, keep_n: int):
    steps = sorted(all_steps(path))
    for s in steps[:-keep_n] if keep_n > 0 else []:
        shutil.rmtree(os.path.join(path, f"step_{s:012d}"),
                      ignore_errors=True)


def all_steps(path: str) -> List[int]:
    if not os.path.isdir(path):
        return []
    out = []
    for d in os.listdir(path):
        if d.startswith("step_") and os.path.exists(
                os.path.join(path, d, META)):
            out.append(int(d[len("step_"):]))
    return sorted(out)


def latest_step(path: str) -> Optional[int]:
    steps = all_steps(path)
    return steps[-1] if steps else None


def restore(path: str, target: Any, step: Optional[int] = None,
            device: DeviceLike = None) -> Tuple[Any, int]:
    """Load a checkpoint into the structure of ``target`` (a tree of
    tensors: on any device, ``meta`` included, which gives the structure
    without memory).  Each leaf is placed on ``device`` (default CUDA) in
    its target's dtype.  Raises ``ValueError`` when the checkpoint's
    leaves do not match the target's count or shapes."""
    dev = resolve_device(device)
    step = latest_step(path) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {path}")
    d = os.path.join(path, f"step_{step:012d}")
    with open(os.path.join(d, META)) as f:
        meta = json.load(f)
    flat = _flatten(target)
    if len(flat) != len(meta["leaves"]):
        raise ValueError(f"leaf count mismatch: ckpt {len(meta['leaves'])} "
                         f"vs {len(flat)}")
    loaded = []
    for i, ((_, like), info) in enumerate(zip(flat, meta["leaves"])):
        a = np.load(os.path.join(d, f"arr_{i}.npy"))
        if list(a.shape) != list(info["shape"]) or \
                list(a.shape) != list(like.shape):
            raise ValueError(f"leaf {i}: checkpoint shape {list(a.shape)}, "
                             f"target {list(like.shape)}")
        t = torch.from_numpy(a)
        if info["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        loaded.append(t.to(device=dev, dtype=like.dtype))
    return _unflatten(target, loaded), step


class PreemptionHandler:
    """SIGTERM -> request a final checkpoint at a step boundary."""

    def __init__(self):
        self.requested = False
        self._installed = False

    def install(self):
        if self._installed:
            return
        try:
            signal.signal(signal.SIGTERM, self._handler)
        except ValueError:            # not the main thread (tests)
            pass
        self._installed = True

    def _handler(self, signum, frame):
        self.requested = True

    def maybe_save(self, path: str, tree: Any, step: int) -> bool:
        if self.requested:
            save(path, tree, step)
            return True
        return False


class CheckpointManager:
    """Policy wrapper: save every N steps (async), restore-or-init."""

    def __init__(self, path: str, every: int = 100, keep_n: int = 3,
                 async_save: bool = True):
        self.path = path
        self.every = every
        self.keep_n = keep_n
        self.async_save = async_save
        self.preempt = PreemptionHandler()
        self._pending: Optional[threading.Thread] = None

    def restore_or_init(self, init_fn: Callable[[DeviceLike], Any],
                        device: DeviceLike = None) -> Tuple[Any, int]:
        """``init_fn(device)`` builds a fresh tree on a device.  With a
        checkpoint, it runs once on ``meta`` for the structure and the
        latest step is restored onto ``device``; else it runs on
        ``device`` and the step is -1."""
        if latest_step(self.path) is not None:
            return restore(self.path, init_fn("meta"), device=device)
        return init_fn(device), -1

    def step(self, tree: Any, step: int):
        if self.preempt.maybe_save(self.path, tree, step):
            return
        if step % self.every == 0:
            self.wait()
            if self.async_save:
                self._pending = save_async(self.path, tree, step,
                                           self.keep_n)
            else:
                save(self.path, tree, step, self.keep_n)

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None
