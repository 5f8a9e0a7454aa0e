"""The exchanges of a sharded cost volume: halos along the sharded axis, a
gather of a slab axis, a max over a group.

Under depth-slab or height sharding (`dist.mesh`) each rank of a group holds
a slab [lo, hi) of a stage's volume along one axis.  A 3-D convolution of
the slab needs the planes (or rows) its neighbours hold at its edges; XLA's
GSPMD inserts these exchanges in JAX, the port makes them here:

  halo_exchange  the slab with `before` slices of the previous rank's end
                 and `after` of the next rank's start joined on (zeros
                 beyond the global ends): a stride-1 conv takes one each
                 side, a stride-2 conv one before, a stride-2 transposed
                 conv one after.  Its backward sends each halo's cotangent
                 back to its owner, which adds it in.
  slab_gather    the whole axis from every rank's slab; its backward sums
                 the cotangent over the group and keeps this rank's slab.
  group_max      the largest value over the group, elementwise and without
                 a gradient (the shift of a softmax over a sharded axis).

Each is built from `all_reduce` sums alone, of a zero buffer that every
rank fills at its own place: two ranks that share one card run over gloo,
whose CUDA support covers `all_reduce` and `broadcast`, and the same code
serves the CPU and the card.  `exchange_stats` counts the all-reduces by
kind; with `exchange_stats.timed` set, each is bracketed by CUDA events.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's share of a stage's cost volume along one axis.

    axis: "depth" (the hypotheses) or "spatial" (the rows).
    group: the process group of the ranks that split the axis.
    index: this rank's place in the group; bounds: every rank's [lo, hi)
      at full resolution (`dist.mesh.slab_bounds`), so lo, hi = bounds[index].
    extent: the axis's global extent.
    """
    axis: str
    group: object
    index: int
    bounds: tuple
    extent: int

    @property
    def size(self) -> int:
        return len(self.bounds)

    @property
    def lo(self) -> int:
        return self.bounds[self.index][0]

    @property
    def hi(self) -> int:
        return self.bounds[self.index][1]


class _Stats:
    """All-reduces issued by the exchanges, by kind, and their CUDA event
    pairs while `timed` is set."""

    def __init__(self):
        self.reset()

    def reset(self, timed: bool = False) -> None:
        self.counts = {"halo": 0, "gather": 0, "max": 0}
        self.timed = timed
        self.events: list = []

    def ms(self) -> float:
        """Milliseconds between each recorded pair of events, summed (waits
        for them)."""
        for _, end in self.events:
            end.synchronize()
        return sum(start.elapsed_time(end) for start, end in self.events)


exchange_stats = _Stats()


def _all_reduce(buf: torch.Tensor, group, kind: str) -> None:
    exchange_stats.counts[kind] += 1
    if exchange_stats.timed and buf.is_cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        end.record()
        exchange_stats.events.append((start, end))
    else:
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)


def _slots(x: torch.Tensor, dim: int, size: int, width: int) -> torch.Tensor:
    """A zero buffer of `size` slots, each x with `width` slices along dim."""
    shape = list(x.shape)
    shape[dim] = width
    return x.new_zeros((size, *shape))


class _Halo(torch.autograd.Function):
    """Slot r of the exchange buffer holds rank r's first `after` slices
    (the previous rank's next halo) and then its last `before` (the next
    rank's previous halo)."""

    @staticmethod
    def forward(ctx, x, dim, before, after, shard):
        n = x.shape[dim]
        if n < max(before, after):
            raise ValueError(f"halo_exchange: a slab of {n} slices for halos of {before} and "
                             f"{after}")
        ctx.meta = (dim, before, after, shard, n)
        r, size = shard.index, shard.size
        buf = _slots(x, dim, size, before + after)
        buf[r].narrow(dim, 0, after).copy_(x.narrow(dim, 0, after))
        buf[r].narrow(dim, after, before).copy_(x.narrow(dim, n - before, before))
        _all_reduce(buf, shard.group, "halo")
        prev = (buf[r - 1].narrow(dim, after, before) if r > 0 else
                _slots(x, dim, 1, before)[0])
        nxt = buf[r + 1].narrow(dim, 0, after) if r < size - 1 else _slots(x, dim, 1, after)[0]
        return torch.cat([prev, x, nxt], dim)

    @staticmethod
    def backward(ctx, g):
        dim, before, after, shard, n = ctx.meta
        r, size = shard.index, shard.size
        gx = g.narrow(dim, before, n).clone()
        buf = _slots(gx, dim, size, before + after)
        if r > 0:  # the previous rank's last slices
            buf[r - 1].narrow(dim, after, before).copy_(g.narrow(dim, 0, before))
        if r < size - 1:  # the next rank's first slices
            buf[r + 1].narrow(dim, 0, after).copy_(g.narrow(dim, before + n, after))
        _all_reduce(buf, shard.group, "halo")
        gx.narrow(dim, 0, after).add_(buf[r].narrow(dim, 0, after))
        gx.narrow(dim, n - before, before).add_(buf[r].narrow(dim, after, before))
        return gx, None, None, None, None


def halo_exchange(x: torch.Tensor, dim: int, shard: Shard, before: int,
                  after: int) -> torch.Tensor:
    """x, this rank's slab along `dim`, with the previous rank's last
    `before` slices joined before it and the next rank's first `after`
    after it (zeros past the global ends); differentiable (module
    docstring).  Every rank of the group calls it with the same arguments."""
    return _Halo.apply(x, dim, before, after, shard)


class _SlabGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, shard):
        ctx.meta = (dim, shard)
        shape = list(x.shape)
        shape[dim] = shard.extent
        full = x.new_zeros(shape)
        full.narrow(dim, shard.lo, shard.hi - shard.lo).copy_(x)
        _all_reduce(full, shard.group, "gather")
        return full

    @staticmethod
    def backward(ctx, g):
        dim, shard = ctx.meta
        g = g.contiguous().clone()
        _all_reduce(g, shard.group, "gather")
        return g.narrow(dim, shard.lo, shard.hi - shard.lo), None, None


def slab_gather(x: torch.Tensor, dim: int, shard: Shard) -> torch.Tensor:
    """The whole axis `dim` (shard.extent slices) from every rank's slab x;
    differentiable: each rank's loss reads the whole, so the cotangent of
    a rank's slab is the group's summed cotangent at its bounds."""
    return _SlabGather.apply(x, dim, shard)


@torch.no_grad()
def group_max(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """The elementwise largest of every rank's x (one shape on all ranks),
    detached."""
    buf = x.new_zeros((shard.size, *x.shape))
    buf[shard.index] = x
    _all_reduce(buf, shard.group, "max")
    return buf.amax(0)
