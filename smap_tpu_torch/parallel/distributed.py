"""Process groups and the collectives of the port (counterpart of
``smap_tpu/parallel/distributed.py``).

One process per card, as the reference runs (``torchrun``, or a
coordinator address with a rank and world size): NCCL between cards, gloo
on the CPU or when asked for. Training syncs the BatchNorm statistics, the
root-depth loss's count and the gradients over the group
(:func:`all_reduce_sum`, :func:`all_reduce_mean`,
:func:`average_gradients`); labeled inference gathers each rank's results
(:func:`all_gather_objects`). Without a group every helper is the
single-process identity, and nothing here is collective.
"""

from __future__ import annotations

import argparse
import datetime
import os
import socket
import tempfile
import time
from typing import Any, Callable, Iterable, List, Optional

import torch
import torch.distributed as dist
from torch import nn

# A rank that waits longer than this for the others fails: a rank that
# died or hangs ends the run instead of holding the group forever.
TIMEOUT_S = 600


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           timeout_s: float = TIMEOUT_S) -> None:
    """Joins the process group; a no-op for a single process.

    Args:
      coordinator: ``host:port`` of rank 0's rendezvous; ``None`` reads
        torchrun's environment (``env://``: ``RANK``, ``WORLD_SIZE``,
        ``MASTER_ADDR``, ``MASTER_PORT``), and without ``WORLD_SIZE`` > 1
        stays a single process.
      num_processes, process_id: the world size and this rank (with
        ``coordinator``).
      backend: ``"nccl"`` or ``"gloo"``; by default NCCL when there is a
        card, else gloo. Under NCCL the rank takes card ``LOCAL_RANK``
        (its rank when that is unset) as its current device, so that
        ``runtime.get_device("cuda")`` is its own card; a rank with no
        card of its own raises. Under gloo the caller picks the device
        (two ranks may share one card).
      timeout_s: how long a collective waits for the other ranks.
    """
    if num_processes is not None and num_processes <= 1:
        return
    if coordinator is None:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world <= 1:
            return
        rank, init = int(os.environ["RANK"]), "env://"
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and "
                             "process_id")
        world, rank = num_processes, process_id
        init = f"tcp://{coordinator}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        cards = torch.cuda.device_count()
        if local >= cards:
            raise RuntimeError(f"rank {rank} needs card {local} under NCCL, "
                               f"but this host has {cards}")
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def add_flags(parser: argparse.ArgumentParser) -> None:
    """A CLI's ``--distributed``, ``--coordinator``, ``--num-processes``,
    ``--process-id`` and ``--backend`` (:func:`initialize_from`)."""
    parser.add_argument("--distributed", action="store_true",
                        help="join a process group: torchrun's environment, "
                        "or --coordinator with --num-processes and "
                        "--process-id")
    parser.add_argument("--coordinator", default=None,
                        help="rank 0's rendezvous address host:port")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                        help="collective backend (default: nccl with a "
                        "card, gloo without); gloo lets ranks share a "
                        "card")


def initialize_from(args: argparse.Namespace) -> None:
    """Joins the process group that a CLI's :func:`add_flags` ask for, if
    any."""
    if args.distributed or args.coordinator:
        initialize_distributed(args.coordinator, args.num_processes,
                               args.process_id, backend=args.backend)


def finalize_distributed() -> None:
    """Leaves the process group, if there is one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def in_group() -> bool:
    """True inside an initialized process group (of any size)."""
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if in_group() else 1


def process_index() -> int:
    return dist.get_rank() if in_group() else 0


def is_main_process() -> bool:
    return process_index() == 0


def all_gather_objects(obj: Any) -> List[Any]:
    """Every rank's picklable ``obj``, in rank order (``[obj]`` without a
    group)."""
    if process_count() == 1:
        return [obj]
    out: List[Any] = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group whose gradient is the sum of the ranks'
    gradients: each rank's input feeds every rank's output."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the group, differentiable (``x`` itself
    without a group of more than one)."""
    if process_count() == 1:
        return x
    return _AllReduceSum.apply(x)


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the group, detached (``x`` detached without
    a group of more than one)."""
    x = x.detach()
    if process_count() == 1:
        return x
    x = x.clone()
    dist.all_reduce(x)
    return x.div_(process_count())


def broadcast_module(module: nn.Module, src: int = 0) -> None:
    """Copies rank ``src``'s parameters and buffers into every rank's
    ``module`` (in place; nothing without a group)."""
    if not in_group():
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src)


def average_gradients(params: Iterable[torch.Tensor]) -> None:
    """Replaces each parameter's gradient by its mean over the group: one
    all-reduce of one flat bucket (of the gradients' dtype). Runs in any
    group, one rank included (the collective then runs and changes
    nothing)."""
    if not in_group():
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat.div_(process_count())
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n


def free_port() -> int:
    """A TCP port of this host that is free now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, world_size: int, coordinator: str,
               out_dir: str, args: tuple) -> None:
    result = fn(rank, world_size, coordinator, *args)
    torch.save(result, os.path.join(out_dir, f"{rank}.pt"))


def spawn_ranks(fn: Callable, world_size: int, *args,
                timeout_s: float = TIMEOUT_S) -> List[Any]:
    """Runs ``fn(rank, world_size, coordinator, *args)`` in ``world_size``
    fresh processes of this host (``spawn``) and returns their results in
    rank order. ``coordinator`` is ``localhost:<a free port>``, for
    :func:`initialize_distributed`. ``fn`` must be importable by name and
    its result picklable. A rank that raises, or a run longer than
    ``timeout_s``, kills every rank and raises here."""
    import torch.multiprocessing as mp

    coordinator = f"localhost:{free_port()}"
    with tempfile.TemporaryDirectory(prefix="smap_ranks_") as out_dir:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world_size, coordinator, out_dir, args),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(),
                                           0.01)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world_size} ranks of "
                                       f"{fn.__name__} ran past "
                                       f"{timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(timeout=30)
        return [torch.load(os.path.join(out_dir, f"{r}.pt"),
                           weights_only=False) for r in range(world_size)]
