"""Op-level cost of one step: FLOPs, bytes, collectives and memory.

The one-card counterpart of the JAX package's ``launch/jaxpr_cost.py``
(walking a step's jaxpr) and of ``launch/hlo_analysis.py``'s collective
inventory.  ``OpCost`` is a ``TorchDispatchMode``: every aten op the step
runs, forward and backward, passes through it once per execution, so
Python loops over layers, key chunks and scan steps are counted once per
trip and trip counts are exact by construction (what ``analyze_jaxpr``
gets by multiplying ``scan`` bodies).  Run a step under it on ``meta``
tensors and nothing is allocated or computed; on real tensors it counts
the same ops.

The counts follow the reference's definitions:

- ``flops``: ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` 2 x output
  elements x contracted size (``_dot_flops``; the bias of ``addmm`` /
  ``baddbmm`` is one more elementwise add), convolutions as
  ``_conv_flops``, reductions their input elements, the cheap
  elementwise ops of ``ELEMENTWISE`` their output elements times the
  number of reference primitives each stands for (``silu`` is
  ``logistic`` and ``mul``), ``sort`` / ``topk`` n log2 n;
- ``dot_flops``: the matrix-product share alone, by input dtype;
- ``bytes``: operand plus result bytes of every op that is not a view
  (views count 0): the unfused ceiling.  An indexed write in place
  (``index_copy_``, ``index_put_``, ``scatter_``) counts the values it
  writes, not the whole buffer it writes into: the port's caches are
  written in place (``models/serve.py``), where the reference's
  functional ``dynamic_update_slice`` counts its whole operand and
  result;
- ``bytes_heavy``: the same for the ops of ``HEAVY``, matmuls,
  convolutions, gathers, scatters, indexing, ``slice_scatter``, sort,
  and a ``copy_`` into a storage of ``cache``: the fused estimate;
- ``collectives``: each ``c10d.*`` / ``_c10d_functional.*`` collective
  as a ``Collective(op, bytes, group_size, axis)`` with the reference's
  ring wire model and ``summarize``; on one card the list is empty
  unless the step itself calls ``torch.distributed``.  ``axis`` names
  the mesh dimension whose group it runs over (``OpCost(mesh=)``).
  ``ops`` counts every aten op by name (the reference's ``count_op``
  over HLO text).

**Per rank under a sharding plan.**  A step whose tensors are DTensors
(``train/step.jit_step_for_cell``, on a mesh of torch's fake process
group in ``launch.dryrun``) is counted as one rank runs it: the mode
declines each DTensor op (``NotImplemented``), DTensor runs it on the
rank's local chunks, and those local ops and the collectives that
redistribute them come through the mode and are counted.  So FLOPs and
bytes are the rank's own, and so are the memory counts: a DTensor
argument or output is its local tensor.  Work that DTensor replicates
is counted on every rank.  The shape inference DTensor runs on fake
tensors is not counted.

Memory is tracked in the same pass by the storages' lifetimes (this
module's own tracker, not ``MemTracker``): the arguments' storages are
live from the start, each new storage an op returns is added, and a
weak reference to it takes it off when it is freed.  ``peak_bytes`` is
the most bytes live at once.  It counts what a step allocates, not the
caching allocator's rounding or a library's workspace.
"""
from __future__ import annotations

import dataclasses
import math
import sys
import weakref
from collections import Counter, defaultdict
from typing import Any, Dict, Iterable, List

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.distributed.ctx import is_dtensor

# aten op (its name without the in-place "_") -> the reference primitives
# of ``jaxpr_cost.CHEAP_ELEMENTWISE`` it stands for; each costs one FLOP
# per output element
ELEMENTWISE: Dict[str, tuple] = {
    "add": ("add",), "sub": ("sub",), "rsub": ("sub",), "mul": ("mul",),
    "div": ("div",), "reciprocal": ("div",), "maximum": ("max",),
    "minimum": ("min",), "clamp_min": ("max",), "clamp_max": ("min",),
    "clamp": ("clamp",), "relu": ("max",), "neg": ("neg",),
    "abs": ("abs",), "exp": ("exp",), "expm1": ("exp",), "log": ("log",),
    "log1p": ("log",), "tanh": ("tanh",), "sigmoid": ("logistic",),
    "rsqrt": ("rsqrt",), "sqrt": ("sqrt",), "pow": ("integer_pow",),
    "bitwise_and": ("and",), "bitwise_or": ("or",),
    "bitwise_not": ("not",), "bitwise_xor": ("xor",),
    "logical_and": ("and",), "logical_or": ("or",), "logical_not": ("not",),
    "where": ("select_n",), "masked_fill": ("select_n",),
    "threshold_backward": ("select_n",), "ge": ("ge",), "gt": ("gt",),
    "le": ("le",), "lt": ("lt",), "eq": ("eq",), "ne": ("ne",),
    "sign": ("sign",), "floor": ("floor",), "ceil": ("ceil",),
    "round": ("round",), "erf": ("erf",), "erfinv": ("erf_inv",),
    "remainder": ("rem",), "fmod": ("rem",), "cos": ("cos",),
    "sin": ("sin",), "isfinite": ("is_finite",),
    "_to_copy": ("convert_element_type",), "cumsum": ("cumsum",),
    "cumprod": ("cumprod",), "cummax": ("cummax",),
    "logcumsumexp": ("cumlogsumexp",),
    "silu": ("logistic", "mul"),
    "silu_backward": ("logistic", "sub", "mul", "add", "mul"),
    "sigmoid_backward": ("sub", "mul", "mul"),
    "tanh_backward": ("mul", "sub", "mul"),
    "softplus": ("exp", "log", "max"),
    "softplus_backward": ("logistic", "mul"),
    "gelu": ("mul", "mul", "add", "mul", "tanh", "add", "mul", "mul"),
    "lerp": ("sub", "mul", "add"), "addcmul": ("mul", "mul", "add"),
    "addcdiv": ("div", "mul", "add"),
    # softmax as the reference writes it: max, sub, exp, sum, div (or log)
    "_softmax": ("max", "sub", "exp", "add", "div"),
    "_log_softmax": ("max", "sub", "exp", "add", "sub"),
    "_softmax_backward_data": ("mul", "add", "sub", "mul"),
    "_log_softmax_backward_data": ("exp", "add", "mul", "sub"),
}

# reductions: one FLOP per input element (``reduce_*`` and ``argmax``)
REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "argmax",
              "argmin", "any", "all", "logsumexp", "linalg_vector_norm",
              "norm"}
DOTS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "dot", "mv"}
CONVS = {"convolution", "convolution_backward"}
SORTS = {"sort", "topk"}
# the reference's HEAVY_OPS: dot_general, conv, gather, scatter(-add),
# dynamic_(update_)slice, take, sort
HEAVY = DOTS | CONVS | {
    "gather", "scatter", "scatter_add", "scatter_reduce", "index",
    "index_select", "index_add", "index_copy", "index_put",
    "_index_put_impl", "index_fill", "slice_scatter", "select_scatter",
    "embedding", "embedding_dense_backward", "sort"}
# an indexed write in place -> the argument that holds the values written
INDEXED_WRITES = {"index_copy": 3, "index_put": 2, "_index_put_impl": 2,
                  "scatter_add": 3, "index_add": 3}
BIASED_DOTS = {"addmm", "baddbmm", "addbmm"}
# views that the schema does not mark as aliasing
VIEW_LIKE = {"_unsafe_view"}

# functional-collective ops whose result is their input's tensor on a
# device; on ``meta`` they return a new tensor, which takes the input's
# place in the live bytes rather than adding to them
ALIASING = {"_wrap_tensor_autograd", "wait_tensor"}

# c10d / _c10d_functional op -> the HLO collective name of the reference
COLLECTIVE_NAMES = {
    "allreduce": "all-reduce", "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allgather": "all-gather", "_allgather_base": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "allgather_into_tensor_coalesced": "all-gather",
    "reduce_scatter": "reduce-scatter",
    "_reduce_scatter_base": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "alltoall": "all-to-all", "alltoall_base": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv": "collective-permute",
    "broadcast": "broadcast",
}


@dataclasses.dataclass
class Collective:
    """One execution of a collective: its result bytes and the group's
    size (``hlo_analysis.Collective``; a collective run n times is n
    entries, so there is no loop multiplicity)."""

    op: str
    bytes: float
    group_size: int
    axis: str = ""

    @property
    def wire_bytes(self) -> float:
        """Bytes one member sends, ring algorithms (S = group size)."""
        s = max(self.group_size, 1)
        if self.op == "all-reduce":
            w = 2 * self.bytes * (s - 1) / s
        elif self.op in ("all-gather", "all-to-all"):
            w = self.bytes * (s - 1) / s
        elif self.op == "reduce-scatter":
            w = self.bytes * (s - 1)
        else:
            w = self.bytes
        return w


def summarize(colls: List[Collective], by_axis: bool = False
              ) -> Dict[str, Dict[str, float]]:
    """Per op (``by_axis``: per op and mesh axis, keyed "op over axis"):
    count, operand bytes and wire bytes, and their total."""
    agg: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"count": 0, "operand_bytes": 0.0, "wire_bytes": 0.0})
    for c in colls:
        a = agg[f"{c.op} over {c.axis or '?'}" if by_axis else c.op]
        a["count"] += 1
        a["operand_bytes"] += c.bytes
        a["wire_bytes"] += c.wire_bytes
    total = {"count": sum(a["count"] for a in agg.values()),
             "operand_bytes": sum(a["operand_bytes"] for a in agg.values()),
             "wire_bytes": sum(a["wire_bytes"] for a in agg.values())}
    agg["total"] = total
    return dict(agg)


def tensors(x) -> List[torch.Tensor]:
    """The tensors of a tree, a DTensor as its local tensor."""
    return [t._local_tensor if is_dtensor(t) else t for t in tree_leaves(x)
            if isinstance(t, torch.Tensor)]


def _declined(types) -> bool:
    """Whether an op is a DTensor op (run on local chunks instead)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and any(issubclass(t, mod.DTensor) for t in types)


def _nbytes(t: torch.Tensor) -> float:
    return float(t.numel() * t.element_size())


def storage_bytes(ts: Iterable[torch.Tensor]) -> int:
    """Bytes of the distinct storages under ``ts``."""
    seen: Dict[int, int] = {}
    for t in ts:
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _group(func, args):
    """The process group a collective runs over, or None."""
    import torch.distributed as dist
    for a in args:
        if isinstance(a, torch.ScriptObject):
            return dist.ProcessGroup.unbox(a)
    if func.namespace == "_c10d_functional":
        from torch.distributed.distributed_c10d import _resolve_process_group
        name = next(a for a in reversed(args) if isinstance(a, str))
        return _resolve_process_group(name)
    return None


def mesh_groups(mesh) -> Dict[str, str]:
    """{process group name: mesh dimension name} of a ``DeviceMesh``."""
    if mesh is None:
        return {}
    return {mesh.get_group(n).group_name: n for n in mesh.mesh_dim_names}


class OpCost(TorchDispatchMode):
    """Count the ops run under it (see the module docstring).

    ``arguments``: the tensors live before the step (state, inputs,
    cache), counted into ``argument_bytes`` and the live bytes;
    ``cache``: the tensors a ``copy_`` into counts as heavy; ``mesh``:
    the ``DeviceMesh`` whose dimensions name the collectives' axes."""

    def __init__(self, arguments: Any = None, cache: Any = None,
                 mesh: Any = None):
        super().__init__()
        self._axes = mesh_groups(mesh)
        self.flops = 0.0
        self.dot_flops: Dict[str, float] = defaultdict(float)
        self.bytes = 0.0
        self.bytes_heavy = 0.0
        self.ops: Counter = Counter()
        self.collectives: List[Collective] = []
        self._cache = {t.untyped_storage()._cdata for t in tensors(cache)}
        self._live: Dict[int, Any] = {}
        self.live_bytes = self.peak_bytes = 0
        for t in tensors(arguments):
            self._track(t)
        self.argument_bytes = self.live_bytes

    # -- memory ---------------------------------------------------------

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()

        def freed(_ref, key=key, n=n):
            if self._live.pop(key, None) is not None:
                self.live_bytes -= n

        self._live[key] = weakref.ref(st, freed)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def new_bytes(self, outputs: Any, arguments: Any) -> int:
        """Bytes of ``outputs``' storages that ``arguments`` do not hold
        (the cache a step writes in place is counted once, as an
        argument)."""
        held = {t.untyped_storage()._cdata for t in tensors(arguments)}
        return storage_bytes(t for t in tensors(outputs)
                              if t.untyped_storage()._cdata not in held)

    # -- ops ------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _declined(types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor) for t in tree_leaves((args, out))):
            return out                      # DTensor's shape inference
        name = func._schema.name.split("::")[-1]
        self.ops[name] += 1
        in_place = name.endswith("_")
        base = name[:-1] if in_place else name
        if func.namespace in ("c10d", "_c10d_functional"):
            op = COLLECTIVE_NAMES.get(base)
            if op is not None:              # result bytes, as in HLO
                size = sum(_nbytes(t) for t in tensors(out)
                           or tensors(args))
                g = _group(func, args)
                self.collectives.append(Collective(
                    op, size, 1 if g is None else g.size(),
                    "" if g is None else self._axes.get(g.group_name, "")))
        if not (func.is_view or base in VIEW_LIKE):
            self._count(base, in_place, args, kwargs, out)
        if base in ALIASING:
            for a, b in zip(tensors(args), tensors(out)):
                self._replace(a, b)
        for t in tensors(out):
            self._track(t)
        return out

    def _replace(self, old: torch.Tensor, new: torch.Tensor) -> None:
        """``new`` stands for ``old``: the bytes of ``old`` leave the live
        count when ``new`` has a storage of its own."""
        a, b = old.untyped_storage()._cdata, new.untyped_storage()._cdata
        if a != b and a in self._live and b not in self._live:
            self._live.pop(a)
            self.live_bytes -= old.untyped_storage().nbytes()

    def _count(self, base: str, in_place: bool, args, kwargs, out) -> None:
        ins = tensors((args, kwargs))
        outs = tensors(out)
        if in_place and base in INDEXED_WRITES:
            # self is read and written only where the values go
            b = sum(_nbytes(t) for t in ins[1:]) + _nbytes(
                args[INDEXED_WRITES[base]])
        else:
            b = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        self.bytes += b
        if base in HEAVY or (base == "copy" and ins[0].untyped_storage(
                )._cdata in self._cache):
            self.bytes_heavy += b
        if base in CONVS:
            self.flops += _conv_flops(base, args, out)
        if not outs:
            return
        o = outs[0]
        if base in DOTS:
            a = args[1] if base in BIASED_DOTS else args[0]
            f = 2.0 * o.numel() * a.shape[-1]
            if base == "addbmm":
                f *= a.shape[0]
            self.dot_flops[str(a.dtype).replace("torch.", "")] += f
            self.flops += f
            if base in BIASED_DOTS:
                self.flops += o.numel()
        elif base in REDUCTIONS:
            self.flops += ins[0].numel()
            if base == "mean":
                self.flops += o.numel()
        elif base in ELEMENTWISE:
            self.flops += o.numel() * len(ELEMENTWISE[base])
        elif base in SORTS:
            n = float(ins[0].numel())
            self.flops += n * max(math.log2(max(n, 2.0)), 1.0)

    # -- results --------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        return {"flops": self.flops, "dot_flops": dict(self.dot_flops),
                "bytes": self.bytes, "bytes_heavy": self.bytes_heavy,
                "argument_bytes": self.argument_bytes,
                "peak_bytes": self.peak_bytes,
                "collectives": summarize(self.collectives),
                "collectives_by_axis": summarize(self.collectives,
                                                 by_axis=True),
                "ops": dict(self.ops)}


def _conv_flops(base: str, args, out) -> float:
    """2 x output elements x (kernel elements / output channels) for the
    forward; each gradient of the backward as the convolution it is."""
    if base == "convolution":
        w = args[1]
        return 2.0 * out.numel() * w.numel() / max(w.shape[0], 1)
    grad_out, _, w = args[:3]
    groups = args[-2] if isinstance(args[-2], int) else 1
    f = 0.0
    gi, gw = out[0], out[1]
    if gi is not None:
        f += 2.0 * gi.numel() * w.numel() / max(w.shape[1] * groups, 1)
    if gw is not None:
        f += 2.0 * gw.numel() * grad_out.numel() / max(grad_out.shape[1], 1)
    return f


def count(fn, *args, cache: Any = None, mesh: Any = None
          ) -> "tuple[Any, OpCost]":
    """Run ``fn(*args)`` under an ``OpCost`` whose arguments are
    ``args``; returns (its result, the cost)."""
    cost = OpCost(args, cache=cache, mesh=mesh)
    with cost:
        out = fn(*args)
    return out, cost
