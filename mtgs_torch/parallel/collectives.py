"""Collectives over a mesh axis's process group, with JAX's transposes.

The sharded bodies of the JAX package call `lax.psum`, `pmean`, `pmax`,
`all_gather` and `all_to_all` under `shard_map`, and JAX's transposes fix
their gradients. The port runs one process per rank, so these are
`torch.autograd.Function`s whose backward is that transpose:

* `all_gather` (concatenate every rank's block on dim 0) transposes to a
  sum over the group followed by this rank's slice (JAX's psum_scatter);
* `all_to_all` (block j of dim 0 to rank j) transposes to the reverse
  `all_to_all`, which is the same exchange;
* `replicated` marks inputs that every rank holds alike: forward the
  identity, backward the mean of the cotangents over the group. That is
  the psum with which JAX transposes a replicated `shard_map` input,
  divided by the group's size, because in the port every rank computes
  the loss itself: each replica seeds the backward once, which JAX's 2D
  step divides out with one pmean (`mtgs_tpu/parallel/mesh2d.py:60-65`).
  The result is the same gradient, alike on every rank.

`psum`, `pmean` and `pmax` reduce values that need no gradient (the
data-parallel step's gradients and metrics, the capacity signals), many
tensors in one collective. Every reduction's result is the same bits on
every rank of the group (one all-reduce; sums over received blocks in
rank order).

Backends. The caller names the process group's backend. NCCL takes CUDA
tensors. gloo works on host memory: each collective here copies a CUDA
tensor to the host, runs on the host and copies the result back,
explicitly, whichever collectives a torch build's gloo accepts on CUDA
tensors. The kernels and all other work stay on the card.
`torch.distributed.nn.functional` is not used: its backward differs by
backend (its all_gather's reduce-scatter is an all_to_all on gloo).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return dist.get_world_size(group)


def _host(x: torch.Tensor, group) -> torch.Tensor:
    """The tensor a collective runs on: gloo's is on the host (a copy of a
    CUDA tensor); any other backend's is `x` itself, contiguous."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return x.detach().contiguous().to("cpu", copy=True)
    return x.detach().contiguous()


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    y = _host(x, group)
    if y is x:
        y = y.clone()
    dist.all_reduce(y, op=op, group=group)
    return y.to(x.device)


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's x concatenated along dim 0, in rank order."""
    y = _host(x, group)
    parts = [torch.empty_like(y) for _ in range(group_size(group))]
    dist.all_gather(parts, y, group=group)
    return torch.cat(parts).to(x.device)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x [n, ...]: block j goes to rank j; the result's block j came from rank j."""
    n = group_size(group)
    if x.shape[0] != n:
        raise ValueError(f"all_to_all over {n} ranks needs a leading dim of {n}, got "
                         f"{tuple(x.shape)}")
    y = _host(x, group)
    out = torch.empty_like(y)
    dist.all_to_all_single(out, y, group=group)
    return out.to(x.device)


def _psum_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """x [n * m, ...] -> [m, ...]: the sum over ranks of each rank's block
    `rank` (one all_to_all, then the received blocks summed in rank order)."""
    n = group_size(group)
    if x.shape[0] % n:
        raise ValueError(f"psum_scatter over {n} ranks: dim 0 of {tuple(x.shape)} "
                         f"does not divide")
    blocks = _all_to_all(x.reshape(n, x.shape[0] // n, *x.shape[1:]), group)
    return blocks.sum(dim=0)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return _psum_scatter(g, ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        ctx.meta = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        # an unused output's cotangent is zero (every rank reduces the same buffer)
        gs = [torch.zeros(s, dtype=d, device=v) if g is None else g
              for g, (s, d, v) in zip(gs, ctx.meta)]
        return (None, *pmean(gs, ctx.group))


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's x concatenated along dim 0 (JAX `all_gather(tiled=True)`);
    backward: the cotangent summed over the ranks, this rank's block of it."""
    return _AllGather.apply(x, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x [n, ...]: block j to rank j (JAX `all_to_all(split_axis=0,
    concat_axis=0)`); backward: the reverse exchange."""
    return _AllToAll.apply(x, group)


def replicated(*xs: torch.Tensor, group) -> tuple:
    """The inputs, unchanged; in the backward each one's cotangent is
    averaged over the group (module docstring). Use on tensors that every
    rank of the group computed alike and that feed work split over it."""
    return _Replicated.apply(group, *xs)


def _reduce_many(xs: Sequence[torch.Tensor], op, group) -> List[torch.Tensor]:
    """One all-reduce of all of xs (flattened into one buffer per dtype)."""
    xs = list(xs)
    out: List[torch.Tensor] = [None] * len(xs)
    by_dtype = {}
    for i, x in enumerate(xs):
        by_dtype.setdefault(x.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([xs[i].detach().reshape(-1) for i in idx])
        red = _all_reduce(flat, op, group)
        o = 0
        for i in idx:
            k = xs[i].numel()
            out[i] = red[o:o + k].reshape(xs[i].shape)
            o += k
    return out


def psum(xs: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Each tensor summed over the group (no gradient)."""
    return _reduce_many(xs, dist.ReduceOp.SUM, group)


def pmean(xs: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Each tensor's mean over the group (no gradient): the sum, divided by
    the group's size."""
    n = group_size(group)
    return [s / n for s in psum(xs, group)]


def pmax(xs: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Each tensor's maximum over the group (no gradient)."""
    return _reduce_many(xs, dist.ReduceOp.MAX, group)
