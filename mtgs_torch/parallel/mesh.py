"""Process meshes over `torch.distributed`, and a launcher of ranks.

Port of `mtgs_tpu/parallel/mesh.py`. JAX runs one process over a `Mesh`
of devices and writes each sharded body once under `shard_map`; the port
runs one process per rank. A mesh axis becomes a process group, JAX's
`lax.axis_index` the rank's coordinate on it, and a `shard_map` body what
each rank runs (`parallel/collectives.py` holds the collectives).

`launch` starts the ranks of a world: torch needs processes to reach the
same entry points that a JAX mesh reaches inside one process. It is what
the tests and `chip_smoke.py` use; a user's own launcher (torchrun, a
cluster scheduler) serves as well, since `make_mesh` only needs an
initialised default process group.
"""

from __future__ import annotations

import datetime
import math
import multiprocessing
import queue
import socket
import time
import traceback
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

import mtgs_torch  # noqa: F401  (the TF32 pins take effect in every rank that imports this)


class Mesh:
    """Named axes over the ranks of the default process group, laid out
    row-major (the last axis fastest), as `np.arange(world).reshape(sizes)`.

    `shape` maps each axis name to its size (JAX's `mesh.shape`);
    `group(axis)` is the process group of this rank's line along `axis`,
    `index(axis)` this rank's coordinate on it (JAX's `lax.axis_index`).
    """

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str],
                 groups: Dict[str, object], coords: Dict[str, int]):
        self.shape = dict(zip(axis_names, (int(s) for s in axis_sizes)))
        self._groups = groups
        self._coords = coords

    def group(self, axis: str):
        return self._groups[axis]

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self._coords[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {dist.get_rank()} at {self._coords})"


def make_mesh(axis_sizes: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data",)) -> Mesh:
    """A Mesh over the ranks of the initialised default process group.

    Defaults to a 1-D "data" mesh over every rank. Every rank must call it
    with the same arguments: each axis's process groups are created on
    every rank in the same order (`torch.distributed.new_group`), with the
    default group's backend.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed process group "
                           "(init_process_group, or mtgs_torch.parallel.mesh.launch)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if axis_sizes is None:
        axis_sizes = (world,)
    axis_sizes = tuple(int(s) for s in axis_sizes)
    if len(axis_sizes) != len(axis_names):
        raise ValueError(f"{len(axis_sizes)} axis sizes for {len(axis_names)} names")
    if math.prod(axis_sizes) != world:
        raise ValueError(f"mesh {axis_sizes} does not cover the world of {world} ranks")
    grid = np.arange(world).reshape(axis_sizes)
    at = tuple(int(c) for c in np.argwhere(grid == rank)[0])
    groups, coords = {}, {}
    for a, name in enumerate(axis_names):
        coords[name] = at[a]
        if axis_sizes[a] == world:
            groups[name] = dist.group.WORLD
            continue
        lines = np.moveaxis(grid, a, -1).reshape(-1, axis_sizes[a])
        for line in lines:  # every rank creates every group, in the same order
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[name] = g
    return Mesh(axis_sizes, axis_names, groups, coords)


# ------------------------------------------------------------------ launch

def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_device(device: str, rank: int) -> torch.device:
    """The device rank `rank` runs on: `device` itself ("cpu", "cuda:0": every
    rank on it), or with "cuda:rank" the rank's own card."""
    return torch.device(f"cuda:{rank}" if device == "cuda:rank" else device)


def _rank_main(fn, rank, world, backend, device, port, timeout, args, results):
    try:
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{port}", world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(rank, world, dev, *args)
        finally:
            dist.destroy_process_group()
        results.put(("ok", rank, out))
    except BaseException:  # reported to the parent, which fails the world
        results.put(("error", rank, traceback.format_exc()))
        raise


def launch(fn: Callable, world: int, *, backend: str, device: str = "cuda:0",
           timeout: float = 300.0, args: tuple = ()) -> list:
    """Run `fn(rank, world, device, *args)` in `world` new processes joined
    in one torch.distributed group; return the ranks' results in rank order.

    The caller names the backend ("nccl" where every rank has a card of its
    own, "gloo" otherwise) and the device (`rank_device`); nothing falls
    back from one to the other. `fn` must be importable by name (a
    module-level function) and its result picklable (host data: CUDA
    tensors are not sent back). The processes start by "spawn" and are
    given `timeout` seconds in all, which is also the process group's
    timeout: on the first rank that fails, or at the deadline, every
    other rank is killed and this raises with the failing rank's traceback.
    """
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True, name=f"mtgs-rank{r}",
                         args=(fn, r, world, backend, device, port, timeout, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    out, failure = [None] * world, None
    pending = set(range(world))
    try:
        while pending and failure is None:
            try:
                status, rank, value = results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r in pending if procs[r].exitcode not in (None, 0)]
                if dead:
                    failure = f"rank {dead[0]} exited with code {procs[dead[0]].exitcode}"
                elif time.monotonic() > deadline:
                    failure = f"ranks {sorted(pending)} still running after {timeout} s"
                continue
            if status == "ok":
                out[rank] = value
                pending.discard(rank)
            else:
                failure = f"rank {rank} failed:\n{value}"
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        results.close()
    if failure is not None:
        raise RuntimeError(f"mtgs_torch.parallel.launch({getattr(fn, '__name__', fn)}, "
                           f"world={world}, backend={backend!r}): {failure}")
    bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks {bad} exited with codes {[procs[r].exitcode for r in bad]}")
    return out

