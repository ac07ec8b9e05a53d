"""Logical-axis sharding rules (MaxText-style) -> DTensor placements.

The JAX package's ``distributed/sharding.py``.  Every parameter / cache
initializer exposes a parallel ``*_axes`` tree of logical axis names;
this module maps them to physical mesh axes with divisibility-checked
fallback to replication (MQA kv_heads=1 cannot shard 16 ways — it
replicates instead of erroring).

Default layout (the rule table is the reference's, unchanged):

  batch/frames        -> ("pod", "data")       data parallel across pods
  vocab/heads/mlp/experts -> "model"           tensor + expert parallel
  embed (weight d_model)  -> "data"            FSDP/ZeRO-3: params+optimizer
                                               sharded over the data axis
  decode kv cache seq -> "model"               long caches sharded along seq
  decode cache batch  -> ("pod", "data")

Alternative layouts are expressed as rule overrides (see
``make_rules(overrides=...)``).

A *spec* is the ``PartitionSpec``'s twin: a tuple with one entry per
tensor dimension (trailing ``None`` trimmed), each ``None``, a mesh axis
name or a tuple of mesh axis names.  ``spec_for`` / ``tree_specs`` /
``batch_specs`` return specs and need only ``mesh.axis_names`` and
``mesh.devices.shape`` (or a ``DeviceMesh``'s ``mesh_dim_names`` and
``shape``), so they run on the CPU for any mesh shape.  ``placements``
turns a spec into DTensor ``Shard(d)`` / ``Replicate()`` per mesh
dimension, and ``tree_shardings`` places a tree of tensors with
``distribute_tensor``.

The reference's ``shard_map`` version shim becomes ``ShardMap``: over a
one-axis mesh, a step runs on the calling rank's contiguous block of the
leading axis (shard_map's "the body sees the local block"), and what
crosses ranks goes through the wrap's host collectives on a gloo group
beside the mesh (``gather``, ``psum``, ``all``, ``max``, ``broadcast``).
The fleet engine (``distributed.multistream``) shards its streams with
it.  The port's other per-shard bodies (``serve_attention``,
``pipeline``) run on each rank's local tensors with explicit
``torch.distributed`` collectives.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]

DEFAULT_RULES: Dict[str, Axis] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": "data",                 # FSDP axis for weight d_model dims
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "experts_router": None,
    "expert_embed": "data",          # FSDP like "embed"; override to None
    #                                  to replicate expert d_model (MoE perf)
    "heads_d": "model",              # rwkv square mixing matrices (out dim)
    "inner": "model",                # mamba d_inner
    "inner2": "model",
    "layers": None,
    "cache_batch": ("pod", "data"),
    "cache_seq": "model",
    "cache_kv": None,
    "stream": "stream",              # fleet serving: leading camera-stream
    #                                  axis of stacked per-stream batches
    #                                  (distributed.multistream)
}


def make_rules(overrides: Optional[Mapping[str, Axis]] = None
               ) -> Dict[str, Axis]:
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)
    return rules


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of anything with
    ``axis_names`` and ``devices.shape`` (a JAX mesh, a stand-in)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


_mesh_axes = mesh_axes          # the reference's name


def _resolve_axis(ax: Axis, dim: int, mesh_axes: Dict[str, int]) -> Axis:
    """Divisibility-checked physical axis (or partial tuple prefix)."""
    if ax is None:
        return None
    axes = (ax,) if isinstance(ax, str) else tuple(ax)
    axes = tuple(a for a in axes if a in mesh_axes)
    if not axes:
        return None
    size = math.prod(mesh_axes[a] for a in axes)
    if size and dim % size == 0:
        return axes if len(axes) > 1 else axes[0]
    # try shrinking the tuple (e.g. batch=1 cannot shard at all)
    for end in range(len(axes) - 1, 0, -1):
        size = math.prod(mesh_axes[a] for a in axes[:end])
        if dim % size == 0:
            return axes[:end] if end > 1 else axes[0]
    return None


def spec_for(logical: Sequence[Union[str, None]], shape: Sequence[int],
             mesh, rules: Mapping[str, Axis]) -> Spec:
    """One spec from logical axis names + the actual shape."""
    ma = mesh_axes(mesh)
    used: set = set()
    out: List[Axis] = []
    for name, dim in zip(logical, shape):
        ax = _resolve_axis(rules.get(name) if name else None, dim, ma)
        # a mesh axis may appear at most once in a spec
        if ax is not None:
            axs = (ax,) if isinstance(ax, str) else ax
            if any(a in used for a in axs):
                ax = None
            else:
                used.update(axs)
        out.append(ax)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _is_axes_leaf(x) -> bool:
    """A logical-axes tuple, or a spec (whose entries may be tuples of
    mesh axes, as ("pod", "data") for the batch)."""
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) or (
            isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def map_axes(fn, axes_tree: Any, *trees: Any) -> Any:
    """``fn(axes, *leaves)`` over a logical-axes tree and trees of the
    same dict structure (an axes tuple is a leaf)."""
    if _is_axes_leaf(axes_tree):
        return fn(axes_tree, *trees)
    return {k: map_axes(fn, axes_tree[k], *(t[k] for t in trees))
            for k in axes_tree}


def tree_specs(axes_tree: Any, shape_tree: Any, mesh,
               rules: Optional[Mapping[str, Axis]] = None) -> Any:
    """Map a logical-axes tree + matching shape tree -> spec tree.  A
    shape leaf is anything with ``.shape`` (a tensor, a meta tensor) or
    a tuple of ints."""
    rules = rules or DEFAULT_RULES

    def one(ax, leaf):
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)
        assert len(ax) == len(shape), (ax, shape)
        return spec_for(ax, shape, mesh, rules)

    return map_axes(one, axes_tree, shape_tree)


def batch_specs(kind: str, mesh, rules: Optional[Mapping[str, Axis]] = None,
                batch: int = 0) -> Spec:
    """Spec for a (batch, ...) input array."""
    rules = rules or DEFAULT_RULES
    ma = mesh_axes(mesh)
    ax = _resolve_axis(rules["batch"], batch, ma) if batch else rules["batch"]
    return (ax,)


# --------------------------------------------------------------------------
# Specs -> DTensor placements
# --------------------------------------------------------------------------

def placements(spec: Spec, mesh) -> Tuple[Any, ...]:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dimension that dimension ``d`` is split over, ``Replicate()``
    on the others.  A tensor dimension split over several mesh axes is
    split in mesh order (pod-major for ("pod", "data")), which is the
    spec's order under the rule table; another order raises.  An axis of
    one rank splits nothing, and its placement is ``Replicate()`` (the
    same layout; DTensor then has no split to carry through views)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out: List[Any] = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axs = (ax,) if isinstance(ax, str) else tuple(ax)
        idx = [names.index(a) for a in axs]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axs} are not in the "
                             f"mesh's order {tuple(names)}")
        for i in idx:
            if mesh.size(i) > 1:
                out[i] = Shard(d)
    return tuple(out)


def distribute(t: torch.Tensor, mesh, spec: Spec):
    """Place a tensor that every rank holds whole and identical (drawn
    from one seed) as a DTensor: each rank keeps its own chunk, nothing
    is sent (``src_data_rank=None``).  Where nothing splits it, the
    tensor itself is the chunk (no copy: a 48 GiB cache stays where it
    is on a one-rank mesh)."""
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor
    pl = placements(spec, mesh)
    if not any(isinstance(p, Shard) for p in pl):
        return DTensor.from_local(t, mesh, pl, run_check=False)
    return distribute_tensor(t, mesh, pl, src_data_rank=None)


def from_local(t: torch.Tensor, mesh, spec: Spec):
    """The DTensor whose chunk on this rank is ``t`` (chunks even, laid
    out by ``spec``), without a copy: for tensors each rank builds as its
    own chunk, such as a cache slice too large to hold whole."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, mesh, placements(spec, mesh),
                              run_check=False)


def tree_shardings(axes_tree: Any, tree: Any, mesh,
                   rules: Optional[Mapping[str, Axis]] = None) -> Any:
    """Place a tree of whole tensors by its logical axes: a tree of
    DTensors (``distribute``) in the same structure."""
    specs = tree_specs(axes_tree, tree, mesh, rules)
    return map_axes(lambda s, t: distribute(t, mesh, s), specs, tree)


def local_offset(dt, dim: int) -> int:
    """Global index of the first element along ``dim`` of this rank's
    chunk of the DTensor ``dt`` (even chunks: the plan only shards
    dimensions the mesh axes divide)."""
    from torch.distributed.tensor import Shard
    mesh = dt.device_mesh
    coord = mesh.get_coordinate()
    n, pos = 1, 0
    for i, p in enumerate(dt.placements):
        if isinstance(p, Shard) and p.dim == dim:
            pos = pos * mesh.size(i) + coord[i]
            n *= mesh.size(i)
    return pos * (dt.shape[dim] // n)


def stream_mesh(n_devices: Optional[int] = None, device=None):
    """One-axis ``("stream",)`` mesh over the process group's ranks, for
    sharding stacked per-stream batches.  ``n_devices`` must equal the
    world size (a ``DeviceMesh`` covers the group it is built on)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"asked for {n} devices, have {world} ranks")
    return make_mesh((n,), ("stream",), device=device)


# --------------------------------------------------------------------------
# shard_map over a one-axis mesh: each rank's block of the leading axis
# --------------------------------------------------------------------------

# a gloo group over each mesh's ranks, for the host collectives of
# ``ShardMap``; the mesh is held beside its group so its id stays unique
_CONTROL: Dict[int, Tuple[Any, Any]] = {}


def control_group(mesh):
    """A gloo group over ``mesh``'s ranks, for decisions taken on the host
    (made once per mesh, by every rank of the process group together).
    The mesh's own group serves when it is gloo; beside an NCCL mesh a
    gloo group is made, since the data it carries is on the host."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("a mesh's collectives need an initialised "
                           "process group (launch.mesh.init_distributed)")
    hit = _CONTROL.get(id(mesh))
    if hit is not None and hit[0] is mesh:
        return hit[1]
    group = mesh.get_group() if mesh.ndim == 1 else None
    if group is None or dist.get_backend(group) != "gloo":
        group = dist.new_group(mesh.mesh.flatten().tolist(), backend="gloo")
    _CONTROL[id(mesh)] = (mesh, group)
    return group


class MeshHost:
    """Host collectives over a mesh's ranks (``control_group(mesh)``):
    ``gather`` (every rank's block of a host array, in rank order),
    ``psum``, ``all``, ``max`` and ``broadcast`` (rank 0's object)."""

    def __init__(self, mesh):
        self.group = control_group(mesh)
        self.mesh = mesh
        self.world = mesh.size()

    def gather(self, a: np.ndarray) -> np.ndarray:
        """The ranks' equal-shaped blocks ``a`` stacked along axis 0 in
        rank order, on every rank."""
        import torch.distributed as dist
        a = np.ascontiguousarray(a)
        t = torch.from_numpy(a.view(np.uint8) if a.dtype == bool else a)
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t, group=self.group)
        out = torch.cat(parts).numpy()
        return out.view(bool) if a.dtype == bool else out

    def psum(self, a: np.ndarray) -> np.ndarray:
        """The sum of every rank's ``a``, on every rank."""
        import torch.distributed as dist
        t = torch.from_numpy(np.array(a))
        dist.all_reduce(t, group=self.group)
        return t.numpy()

    def all(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is True on every rank."""
        return bool(self.gather(np.array([bool(flag)])).all())

    def max(self, value: float) -> float:
        """The largest of the ranks' ``value``, on every rank."""
        return float(self.gather(np.array([float(value)])).max())

    def broadcast(self, obj: Any) -> Any:
        """Rank 0's ``obj`` on every rank."""
        import torch.distributed as dist
        box = [obj]
        dist.broadcast_object_list(
            box, src=dist.get_global_rank(self.group, 0), group=self.group)
        return box[0]


class ShardMap(MeshHost):
    """The reference's ``shard_map`` over a one-axis mesh, in torch's
    idiom.  ``ShardMap(mesh, spec)(fn)`` is ``fn`` run on the calling
    rank's contiguous block of the leading axis: each rank holds only its
    own block (the counterpart of a stream-axis ``NamedSharding``), so
    the body runs on it as it is, and its outputs are the rank's blocks
    of the global results.  ``spec`` must split dimension 0 over the
    mesh's axis (``spec_for`` gives ``()`` where the length does not
    divide, and the caller then replicates instead of wrapping).  What
    the reference reads off a sharded global array goes through the
    ``MeshHost`` collectives on host arrays."""

    def __init__(self, mesh, spec: Spec):
        if mesh.ndim != 1 or not spec or spec[0] != mesh.mesh_dim_names[0]:
            raise ValueError(f"ShardMap splits dimension 0 of a one-axis "
                             f"mesh; got spec {spec} on the mesh "
                             f"{tuple(mesh.mesh_dim_names)}")
        super().__init__(mesh)
        self.spec = tuple(spec)
        self.rank = mesh.get_local_rank()

    def __call__(self, fn):
        return fn

    def block(self, n: int) -> slice:
        """This rank's contiguous block of a leading axis of ``n``."""
        if n % self.world:
            raise ValueError(f"{n} rows do not split over {self.world} "
                             f"ranks")
        k = n // self.world
        return slice(self.rank * k, (self.rank + 1) * k)

    def signature(self) -> Tuple:
        """A content digest of the mesh: its ranks, axis names, shape and
        the spec (the reference's device ids, axis names, shape and
        spec), so rebuilt engines over the same mesh share steps."""
        return ("mesh", tuple(self.mesh.mesh.flatten().tolist()),
                tuple(self.mesh.mesh_dim_names), tuple(self.mesh.shape),
                repr(self.spec))
