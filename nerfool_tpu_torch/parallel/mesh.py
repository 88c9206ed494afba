"""The ray split (port of the JAX package's ``parallel.mesh``).

The workload's one long axis is rays; samples and views are short. The JAX
package shards that axis over a 1-D device mesh and lets GSPMD insert the
collectives. The port runs one process per card, so the mesh, the ray
sharding and the replicated sharding become one small description:
``RaySplit``, this process's rank and the world size of the default group.
Each rank renders its contiguous share of a ray batch or of a frame's chunk
list (``render``); ``gather`` puts the shares back together in rank order,
and ``all_reduce`` sums the gradients. A group of one rank is no split:
``ray_split`` returns None and the callers run the one-process program
unchanged.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from nerfool_tpu_torch.parallel.distributed import host_shard, make_global


@dataclasses.dataclass(frozen=True)
class RaySplit:
    """Which share of a ray axis this process owns."""

    rank: int
    world: int

    def rows(self, n, unit=1) -> slice:
        """This rank's rows of a length-``n`` axis split in whole ``unit``s
        (a patch of rays, a chunk, a ray block), by ``host_shard``."""
        s = host_shard(-(-n // unit), self.rank, self.world)
        return slice(min(s.start * unit, n), min(s.stop * unit, n))

    def gather(self, local, n, unit=1):
        """Every rank's rows of the length-``n`` axis in rank order. The
        rows of the other ranks carry no gradient: a loss computed on the
        gathered rows by every rank alike is differentiated by each rank
        through its own rows only, so the ranks' gradients sum to the
        gradient of the whole batch."""
        rows = self.rows(n, unit)
        full = make_global(local.detach(), n, rows)
        if not local.requires_grad:
            return full
        return torch.cat([full[:rows.start], local, full[rows.stop:]])

    def render(self, fn, n, unit=1):
        """``fn(rows)`` of this rank's share ``rows`` of a length-``n`` ray
        axis (in whole ``unit``s), gathered from every rank. ``fn`` returns
        render outputs, ``{level: None or {key: [len(rows), ...]}}``; the
        result holds them for all ``n`` rays. A rank whose share is empty
        renders the first unit and keeps none of it, so that it knows the
        outputs' layout."""
        rows = self.rows(n, unit)
        drawn = rows if rows.stop > rows.start else slice(0, min(unit, n))
        ret = fn(drawn)
        keep = rows.stop - rows.start
        return {level: None if outs is None else {
            k: self.gather(v[:keep], n, unit) for k, v in outs.items()}
            for level, outs in ret.items()}

    def localize(self, full, unit=1):
        """A per-ray tensor that every rank computed in full (a z-buffered
        warp, which reads the whole frame), with its gradient kept on this
        rank's rows only, for the same reason as ``gather``."""
        if not full.requires_grad:
            return full
        rows = self.rows(full.shape[0], unit)
        d = full.detach()
        return torch.cat([d[:rows.start], full[rows], d[rows.stop:]])

    def all_reduce(self, tensors):
        """The sum over ranks of each tensor (one collective; the tensors
        share a dtype)."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat)
        out, i = [], 0
        for t in tensors:
            out.append(flat[i:i + t.numel()].view_as(t))
            i += t.numel()
        return out

    def broadcast(self, tensors, src=0):
        """Rank ``src``'s values of ``tensors``, in place, on every rank."""
        for t in tensors:
            dist.broadcast(t.data, src)


def ray_split():
    """The split over the default group, or None without a group or in a
    group of one rank."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    world = dist.get_world_size()
    if world == 1:
        return None
    return RaySplit(rank=dist.get_rank(), world=world)


def pad_to_multiple(x, multiple: int, axis: int = 0):
    """Pad ``x`` along ``axis`` to the next multiple by repeating its last
    entry (edge padding); returns (padded, orig_len)."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    idx = torch.clamp(torch.arange(n + rem, device=x.device), max=n - 1)
    return torch.index_select(x, axis, idx), n
