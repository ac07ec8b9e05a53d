"""Pipeline parallelism (GPipe-style) over a mesh axis (the JAX package's
``distributed/pipeline.py``).

The layer stack (params stacked on the leading L axis) is split into
``n_stages`` contiguous stages, one per rank of the pipeline mesh axis.
A microbatched schedule streams activations stage to stage: each of the
``n_micro + n_stages - 1`` ticks runs the stage on its buffer, then
every stage sends its output to the next and receives the previous
one's, in one ``batch_isend_irecv`` (paired blocking sends would
deadlock).  Stage 0 feeds the next microbatch in; the last stage stores
microbatch ``t - (n_stages - 1)``; a final ``all_reduce(SUM)`` over the
axis replicates the outputs, as JAX's ``psum`` does.

Bubble fraction = (S-1)/(M+S-1) for S stages, M microbatches.

The gloo backend carries no send / recv of CUDA tensors, so on a gloo
group the activations cross through pinned host buffers; NCCL sends
them from the card.  The choice follows from the group's backend.  The
schedule is a forward pass: it runs under ``torch.no_grad()``.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizers import tree_map


def _through_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


@torch.no_grad()
def pipeline_forward(stack: Any, x: torch.Tensor, cfg: ModelConfig, *,
                     group, n_stages: int, n_micro: int,
                     positions=None) -> torch.Tensor:
    """On each rank of ``group``: run the full layer stack across the
    pipeline stages.  ``stack`` holds this stage's layer slice
    (L/n_stages layers); ``x`` is (n_micro, mb, S, D), of which only
    stage 0's content matters.  Returns the final activations, the same
    on every stage."""
    stage = dist.get_rank(group)
    total = n_micro + n_stages - 1     # schedule ticks
    prev = dist.get_global_rank(group, stage - 1) if stage > 0 else None
    nxt = (dist.get_global_rank(group, stage + 1)
           if stage < n_stages - 1 else None)
    host = _through_host(x, group)
    recv = torch.empty_like(x[0])
    if host:
        send_h = torch.empty(x[0].shape, dtype=x.dtype, pin_memory=True)
        recv_h = torch.empty(x[0].shape, dtype=x.dtype, pin_memory=True)
    buf = x[0]
    outs = torch.zeros_like(x)
    for t in range(total):
        y, _, _ = M.run_layers(stack, buf, cfg, positions=positions)
        # the last stage stores finished microbatch t - (n_stages - 1)
        done = t - (n_stages - 1)
        if stage == n_stages - 1 and done >= 0:
            outs[done] = y
        if t == total - 1:
            break
        # pass to the next stage, take the previous stage's output
        ops = []
        if nxt is not None:
            if host:
                send_h.copy_(y)
            ops.append(dist.P2POp(dist.isend, send_h if host else
                                  y.contiguous(), nxt, group))
        if prev is not None:
            ops.append(dist.P2POp(dist.irecv, recv_h if host else recv,
                                  prev, group))
        for req in dist.batch_isend_irecv(ops) if ops else ():
            req.wait()
        if stage == 0:                 # stage 0 feeds the next microbatch
            buf = x[min(t + 1, n_micro - 1)]
        else:
            if host:
                recv.copy_(recv_h)
            buf = recv                 # consumed before the next receive
    # only the last stage stored results; the sum replicates them
    dist.all_reduce(outs, op=dist.ReduceOp.SUM, group=group)
    return outs


def stage_slice(stack: Any, stage: int, n_stages: int) -> Any:
    """Stage ``stage``'s contiguous L/n_stages layers of a stacked tree:
    a DTensor split on the layer axis gives its local chunk, a whole
    tensor its slice."""
    from torch.distributed.tensor import DTensor

    def one(a):
        if isinstance(a, DTensor):
            return a.to_local()
        n = a.shape[0] // n_stages
        return a[stage * n:(stage + 1) * n]
    return tree_map(one, stack)


def make_pipelined_forward(cfg: ModelConfig, mesh, *,
                           pipe_axis: str = "pod", n_micro: int = 4):
    """Pipeline the trunk over ``pipe_axis``.

    Returns fn(stack, x) -> activations (n_micro, mb, S, D), the same on
    every rank; ``stack`` is the stacked layer tree, whole on every rank
    or DTensors split on the layer axis over ``pipe_axis`` (contiguous
    stage slices); ``x`` is (n_micro, mb, S, D), whole on every rank."""
    names = list(mesh.mesh_dim_names)
    n_stages = mesh.size(names.index(pipe_axis))
    assert cfg.n_layers % n_stages == 0
    group = mesh.get_group(pipe_axis)

    def fn(stack, x):
        from torch.distributed.tensor import DTensor
        if isinstance(x, DTensor):
            x = x.full_tensor()
        local = stage_slice(stack, dist.get_rank(group), n_stages)
        return pipeline_forward(local, x, cfg, group=group,
                                n_stages=n_stages, n_micro=n_micro)

    return fn
