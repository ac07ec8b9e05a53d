"""Registry-owned cache of built staged-plan steps (epoch survival).

Every (stage, prefix, bucket, body) step a ``StagedQueryPlan`` executes
is an eager closure with the plan's incidence program, the stage's slot
payload, and the already-known slot set baked in as constants (the JAX
package jit-compiles the same steps; here PyTorch runs them eagerly, so
a "compiled" step is a built closure and ``StageReport.steps_compiled``
counts closures built).  The cache lives outside the plan, with the same
lifetime as the registry's other epoch-surviving state (``SlotStats``,
the ``CanonicalLeafTable``), so a ``QueryRegistry`` epoch bump does not
rebuild every step.

Entries are keyed by *content signatures*, never by object identity or
stage position:

- the **plan signature** — a digest of the levelized NNF incidence
  program over the *distinct* canonical query trees, the distinct root
  columns, and the leaf-table width;
- the **stage signature** — a digest of the stage's canonical leaf
  content: kind, permuted payload arrays, and the slot columns they
  scatter into;
- the **prefix signature** — a digest of the *set* of slot columns
  already known when the step runs (order-free);
- the bucket size and the evaluation body.

Because the signature covers everything baked into a step, a hit can
never serve a step whose stage content changed, and a rebuild whose
signatures didn't move reuses every step verbatim.  The cache is bounded
(LRU) and counts hits / misses / evictions.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np


def content_digest(*parts: Any) -> str:
    """Stable digest of heterogeneous step-key material.

    numpy arrays hash by dtype/shape/bytes (the baked payloads), bytes
    pass through, everything else by ``repr`` — deterministic within a
    process, which is the cache's lifetime (compiled steps cannot
    outlive the process anyway)."""
    h = hashlib.blake2b(digest_size=16)
    for p in parts:
        if isinstance(p, np.ndarray):
            h.update(str(p.dtype).encode())
            h.update(str(p.shape).encode())
            h.update(np.ascontiguousarray(p).tobytes())
        elif isinstance(p, bytes):
            h.update(p)
        else:
            h.update(repr(p).encode())
        h.update(b"\x1f")                      # unit separator: ("a","b")
    return h.hexdigest()                       # never collides with ("ab",)


class StepCache:
    """Bounded LRU of compiled steps, keyed by content signature.

    One instance is typically owned by a ``QueryRegistry`` and threaded
    into every engine the registry's factories build
    (``MultiQueryCascade(step_cache=...)``), so compiled steps
    survive epoch-lazy engine rebuilds exactly as the statistics
    ledgers do.  A ``StagedQueryPlan`` built without one falls back to
    a private instance — the pre-refactor per-plan behaviour.

    ``capacity`` bounds compiled-program memory over a long-running
    stream: the key space is exponential in the stage count in the
    worst case (every undecided pattern is a distinct prefix, times
    power-of-two bucket sizes, times resident plan signatures), but
    real traffic revisits a handful of signatures — evicting the
    coldest entry costs one re-trace if it ever recurs.
    """

    def __init__(self, capacity: int = 64):
        if capacity < 1:
            raise ValueError(f"StepCache capacity must be >= 1, "
                             f"got {capacity}")
        self.capacity = capacity
        self._entries: "OrderedDict[Tuple, Callable]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.puts = 0

    def get(self, key: Tuple) -> Optional[Callable]:
        """The cached step for ``key``, refreshed to most-recently-used;
        None on miss.  Counts every lookup."""
        step = self._entries.get(key)
        if step is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return step

    def put(self, key: Tuple, step: Callable) -> None:
        self._entries[key] = step
        self._entries.move_to_end(key)
        self.puts += 1
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)        # evict coldest
            self.evictions += 1

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Tuple) -> bool:
        return key in self._entries                  # no counter side effect

    def keys(self) -> Iterable[Tuple]:
        return self._entries.keys()

    def clear(self) -> None:
        self._entries.clear()

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.hits + self.misses, 1)

    def snapshot(self) -> Dict[str, float]:
        """Counters for benches/observability (cumulative)."""
        return {"entries": len(self._entries), "capacity": self.capacity,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "puts": self.puts,
                "hit_rate": self.hit_rate}

    def __repr__(self) -> str:
        return (f"StepCache(entries={len(self._entries)}/{self.capacity}, "
                f"hits={self.hits}, misses={self.misses}, "
                f"evictions={self.evictions})")
