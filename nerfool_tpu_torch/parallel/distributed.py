"""Multi-process scaffolding on ``torch.distributed`` (port of
the JAX package's ``parallel.distributed``).

The reference's multi-node story is torch DDP: an env:// rendezvous through
``init_process_group(backend="nccl",
init_method=args.distributed_init_method)``, a per-rank sampler so every rank trains on other target views, and a
gradient all-reduce. The port keeps that shape, one process per card:

* ``initialize(args)``: one call at process start. Reads the env://
  variables a launcher such as ``torchrun`` exports (``MASTER_ADDR``,
  ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``; ``LOCAL_RANK`` names the card)
  and joins the group, NCCL when the process's device is a CUDA card, gloo
  on the CPU. A single process with no ``--distributed`` returns (0, 1) and
  touches nothing.
* ``host_shard(n)``: this rank's contiguous slice of a length-``n`` axis,
  the JAX package's arithmetic.
* ``host_seed(base)``: a decorrelated per-rank stream seed (the reference's
  per-rank sampler without a sampler object; the loaders are seed-driven).
* ``make_global(local, n, rows)``: every rank's rows of a length-``n``
  axis gathered in rank order (identity with one process).
"""
from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist


def _env_spec():
    """The env:// rendezvous variables, if they describe a world of more
    than one process."""
    addr = os.environ.get("MASTER_ADDR")
    port = os.environ.get("MASTER_PORT")
    world = os.environ.get("WORLD_SIZE")
    rank = os.environ.get("RANK")
    if addr and world and int(world) > 1:
        return {"init_method": f"tcp://{addr}:{port or 1234}",
                "world_size": int(world), "rank": int(rank or 0)}
    return None


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def local_device(name="cuda"):
    """``name`` with the card of this process: a bare ``cuda`` becomes
    ``cuda:$LOCAL_RANK`` when a launcher set ``LOCAL_RANK``."""
    local = os.environ.get("LOCAL_RANK")
    if str(name) == "cuda" and local is not None:
        return f"cuda:{int(local)}"
    return name


def initialize(args=None, device=None, **overrides):
    """Join the process group; safe to call unconditionally at entry.

    Resolution order: explicit ``overrides`` (``init_method``,
    ``world_size``, ``rank``) > the env:// variables > with
    ``args.distributed`` a group of ``WORLD_SIZE`` (default 1) ranks at
    ``args.distributed_init_method`` (a world of one without ``MASTER_ADDR``
    rendezvous on a free local port). ``backend`` (an override, never a
    flag): NCCL for a CUDA ``device`` (``args.device`` when None), gloo
    otherwise. A single process without ``args.distributed`` returns (0, 1)
    without touching ``torch.distributed``.

    :return: (rank, world size)
    """
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    backend = overrides.pop("backend", None)
    spec = overrides if overrides.get("world_size") else _env_spec()
    if spec is None and not getattr(args, "distributed", False):
        return 0, 1
    if spec is None:
        method = getattr(args, "distributed_init_method", "env://")
        world = int(os.environ.get("WORLD_SIZE", 1))
        if method == "env://" and not os.environ.get("MASTER_ADDR"):
            if world > 1:
                raise RuntimeError("--distributed with WORLD_SIZE > 1 needs "
                                   "MASTER_ADDR and MASTER_PORT (env://)")
            method = f"tcp://localhost:{_free_port()}"
        spec = {"init_method": method, "world_size": world,
                "rank": int(os.environ.get("RANK", 0))}
    dev = torch.device(local_device(
        device if device is not None else getattr(args, "device", "cpu")))
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, **spec)
    return dist.get_rank(), dist.get_world_size()


def rank_and_world():
    """(rank, world size) of the default group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_main_process() -> bool:
    """The rank-0 gate for logging, checkpoints and result files."""
    return rank_and_world()[0] == 0


def host_shard(n: int, process_index: int | None = None,
               process_count: int | None = None) -> slice:
    """This rank's contiguous slice of a length-``n`` leading axis.

    The axis is split in ``ceil(n / world)`` pieces; the last ranks' slices
    are shorter (or empty) when ``n`` is not a multiple of the world size.
    """
    rank, world = rank_and_world()
    pi = rank if process_index is None else process_index
    pc = world if process_count is None else process_count
    per = -(-n // pc)
    lo = min(pi * per, n)
    return slice(lo, min(lo + per, n))


def make_global(local, n, rows):
    """Every rank's rows of a length-``n`` leading axis, in rank order.

    ``rows``: this rank's slice of the axis, which ``local`` holds. The
    gather is one sum all-reduce of a zero buffer into which each rank
    writes its rows: gloo carries CUDA tensors for all-reduce (not for
    all-gather), and adding zeros is exact. Booleans travel as float32. With
    one process it returns ``local`` unchanged.
    """
    if rank_and_world()[1] == 1:
        return local
    wire = torch.float32 if local.dtype == torch.bool else local.dtype
    buf = local.new_zeros((n,) + tuple(local.shape[1:]), dtype=wire)
    buf[rows] = local.to(wire)
    dist.all_reduce(buf)
    return buf != 0 if local.dtype == torch.bool else buf


def host_seed(base: int, process_index: int | None = None) -> int:
    """Decorrelated per-rank stream seed (rank 0 keeps ``base``)."""
    pi = rank_and_world()[0] if process_index is None else process_index
    return int(base) + 1_000_003 * pi
