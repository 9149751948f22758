"""Named-axis collectives over torch.distributed.

The JAX package's rank programs run under `shard_map` on a mesh with axes
'x' (tile rows), 'y' (tile columns) and 'z' (the 2.5D replication axis),
and move data with `psum` over any subset of the axes, `all_gather` over
'x' or 'y', `ppermute` over 'x' and `psum_scatter` over 'x'. Here each
rank is one process, and `Comm` gives those four collectives with JAX's
semantics on torch.distributed process groups:

  * psum(t, axes): the sum over the ranks that differ from this one only
    in `axes`, on every one of them;
  * all_gather(t, axis): the tensors of the ranks along `axis`, stacked
    along a new leading axis in coordinate order;
  * ppermute(t, axis, pairs): each (src, dst) pair of coordinates along
    `axis` sends src's tensor to dst; a rank that receives nothing gets
    zeros;
  * psum_scatter(t, axis, dim): the sum along `axis`, split along `dim`
    into one slot per coordinate; coordinate i keeps slot i (JAX's
    `tiled=True`).

Two more serve the layout layer: `gather` of every block to one rank
(`layout.undistribute`) and the world's `all_to_all` (`layout.retile`,
the move between two descriptors, COSTA's grid2grid).

Rank coordinates follow the JAX mesh (conflux_tpu/grid.py:188-190):
rank = (pi * Py + pj) * Pz + pz.

Groups. `dist.new_group` is collective over the whole world: every rank
must create every group, in the same order, or the world deadlocks. `Comm`
creates one group per coset of each axis subset whose size exceeds 1, on
every rank of the world (idle ones too), in one fixed order: the subsets
x, y, z, xy, xz, yz, xyz, and within a subset the cosets in ascending
order of the other axes' coordinates.

Staging. NCCL takes one card per rank, so several ranks on one card form
a gloo world. gloo's collectives take CUDA tensors and pass them through
host memory themselves (all_reduce, all_gather, reduce_scatter_tensor and
gather; measured on an H100 with torch 2.11 by `python3 -m
experiments.torch_dist_probe --ops`), but its point-to-point isend/irecv
of a CUDA tensor aborts the process (its TCP transport writes from the
device pointer: "writev ... Bad address"). So on a gloo world whose
tensors live on a card, ppermute's isend/irecv pairs are staged through
host memory explicitly: the tensor is copied to the CPU, sent or
received there, and the result copied back. The staging is fixed per
backend and op; NCCL stages nothing. A rank's sends and receives of one
ppermute go in one `batch_isend_irecv`: NCCL requires a two-way exchange
to be grouped.

Dtypes. The collectives move every dtype as it is: float32, bfloat16,
float64 and complex (gloo takes all of them on CPU and CUDA tensors,
`python3 -m experiments.torch_dist_probe --dtypes`), except gather of a
complex tensor, which gloo refuses ("Invalid scalar type"): it moves the
tensor's real view (`torch.view_as_real`), the same bytes. Nothing is
upcast.

Record. Every call appends a `CommRecord` (op, axes, shape, dtype, pairs,
nbytes) to `Comm.record`, this rank's list of the collectives it issued:
the counterpart of the jaxpr walk of tests/test_spec_comm.py, from which
tests/test_torch_comm.py recomputes the ring volumes of the comm model
(spec.CommVolume).

Spans. Each collective runs inside `profiler.span("comm.<op>")`, off
unless the profiler is on (a `torch.profiler` session or
`profiler.enable(True)`), so a trace files the device's idle time under
the collective whose host work it waited on.
"""

from __future__ import annotations

import functools
import itertools
import warnings
from typing import NamedTuple

import torch

from conflux_tpu_torch.profiler import span

AXES = ("x", "y", "z")
# every axis subset, in the one order all ranks create their groups in
SUBSETS = (("x",), ("y",), ("z",), ("x", "y"), ("x", "z"), ("y", "z"),
           ("x", "y", "z"))


class CommRecord(NamedTuple):
    """One collective as this rank issued it: op ('psum', 'all_gather',
    'ppermute', 'psum_scatter', 'gather' or 'all_to_all'), the axes it ran
    over (() for the world), the shape and dtype of this rank's operand,
    for ppermute the number of (src, dst) pairs, and the operand's bytes."""

    op: str
    axes: tuple
    shape: tuple
    dtype: str
    pairs: int = 0
    nbytes: int = 0


def rank_of(coords, shape) -> int:
    """Global rank of the (pi, pj, pz) coordinates on a (Px, Py, Pz) grid."""
    (pi, pj, pz), (_, Py, Pz) = coords, shape
    return (pi * Py + pj) * Pz + pz


def coords_of(rank: int, shape):
    """(pi, pj, pz) of a global rank on a (Px, Py, Pz) grid."""
    _, Py, Pz = shape
    return rank // (Py * Pz), (rank // Pz) % Py, rank % Pz


def _spanned(fn):
    """The collective `fn` inside its span, comm.<name of fn>."""
    name = "comm." + fn.__name__

    @functools.wraps(fn)
    def call(self, *args, **kwargs):
        with span(name):
            return fn(self, *args, **kwargs)
    return call


def _canon(axes) -> tuple:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if not axes or any(a not in AXES for a in axes) or len(set(axes)) != len(axes):
        raise ValueError(f"axes {axes!r} are not a subset of {AXES}")
    return tuple(a for a in AXES if a in axes)


class Comm:
    """The collectives of one rank of a (Px, Py, Pz) grid. On a (1, 1, 1)
    grid no process group exists or is needed: every collective is the
    identity (all_gather adds its leading axis of one)."""

    def __init__(self, shape, rank: int, device: torch.device):
        self.shape = tuple(shape)
        self.sizes = dict(zip(AXES, self.shape))
        self.P = self.shape[0] * self.shape[1] * self.shape[2]
        self.rank = rank
        self.device = torch.device(device)
        self.coords = coords_of(rank, self.shape) if rank < self.P else None
        self.record: list[CommRecord] = []
        self._groups: dict[tuple, tuple] = {}
        self._stage_p2p = False
        if self.P == 1:
            return
        import torch.distributed as dist

        self._stage_p2p = (dist.get_backend() == "gloo"
                           and self.device.type == "cuda")
        for axes in SUBSETS:
            if all(self.sizes[a] == 1 for a in axes):
                continue
            others = [a for a in AXES if a not in axes]
            for fixed in itertools.product(*(range(self.sizes[a])
                                             for a in others)):
                members = []
                for free in itertools.product(*(range(self.sizes[a])
                                                for a in axes)):
                    c = dict(zip(others, fixed))
                    c.update(zip(axes, free))
                    members.append(rank_of((c["x"], c["y"], c["z"]),
                                           self.shape))
                members = sorted(members)
                group = dist.new_group(members)
                if rank in members:
                    self._groups[axes] = (group, members)

    def world_size(self) -> int:
        """The number of ranks of the world (1 without a process group)."""
        import torch.distributed as dist

        return dist.get_world_size() if dist.is_initialized() else 1

    def coord(self, axis: str) -> int:
        """This rank's coordinate along `axis` (jax.lax.axis_index)."""
        return self.coords[AXES.index(axis)]

    def _log(self, op, axes, t, pairs=0):
        self.record.append(CommRecord(op, axes, tuple(t.shape),
                                      str(t.dtype).replace("torch.", ""),
                                      pairs, t.numel() * t.element_size()))

    def _group(self, axes):
        return self._groups.get(axes, (None, None))

    @_spanned
    def psum(self, t: torch.Tensor, axes) -> torch.Tensor:
        """Sum over `axes` (any subset), as a new tensor on every rank."""
        import torch.distributed as dist

        axes = _canon(axes)
        self._log("psum", axes, t)
        # contiguous: the ranks' layouts of one operand may differ (a
        # transposed view on one rank, zeros on another), and a complex
        # tensor's real view reaches gloo with its strides unchecked
        out = t.clone(memory_format=torch.contiguous_format)
        group, _ = self._group(axes)
        if group is not None:
            dist.all_reduce(out, group=group)
        return out

    @_spanned
    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """[size(axis), *t.shape]: every coordinate's tensor, in order."""
        import torch.distributed as dist

        axes = _canon(axis)
        self._log("all_gather", axes, t)
        group, members = self._group(axes)
        if group is None:
            return t.clone()[None]
        x = t.contiguous()
        parts = [torch.empty_like(x) for _ in members]
        dist.all_gather(parts, x, group=group)
        return torch.stack(parts)

    @_spanned
    def ppermute(self, t: torch.Tensor, axis: str, pairs) -> torch.Tensor:
        """Send along `axis` from each pair's src coordinate to its dst;
        zeros where this rank receives nothing. Sources and destinations
        are each unique, as in jax.lax.ppermute."""
        import torch.distributed as dist

        axes = _canon(axis)
        pairs = [(int(s), int(d)) for s, d in pairs]
        if (len({s for s, _ in pairs}) != len(pairs)
                or len({d for _, d in pairs}) != len(pairs)):
            raise ValueError(f"ppermute pairs {pairs} repeat a source or a "
                             "destination")
        self._log("ppermute", axes, t, len(pairs))
        me = self.coord(axis)
        out = torch.zeros_like(t)
        _, members = self._group(axes)
        ops, recv = [], None
        x = (t.cpu() if self._stage_p2p else t).contiguous()
        for s, d in pairs:
            if s == d == me:
                out = t.clone()
            elif s == me:
                ops.append(dist.P2POp(dist.isend, x, members[d]))
            elif d == me:
                recv = torch.empty_like(x)
                ops.append(dist.P2POp(dist.irecv, recv, members[s]))
        # one batch: NCCL must group a rank's send and receive, or two
        # ranks that exchange both ways can each wait on the other
        for w in dist.batch_isend_irecv(ops) if ops else ():
            w.wait()
        if recv is None:
            return out
        return recv.to(self.device) if self._stage_p2p else recv

    @_spanned
    def psum_scatter(self, t: torch.Tensor, axis: str,
                     dim: int = 0) -> torch.Tensor:
        """The sum along `axis`, split along `dim` into size(axis) equal
        slots; coordinate i keeps slot i."""
        import torch.distributed as dist

        axes = _canon(axis)
        self._log("psum_scatter", axes, t)
        group, members = self._group(axes)
        if group is None:
            return t.clone()
        g = len(members)
        x = t.movedim(dim, 0).contiguous()
        if x.shape[0] % g:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                             f"split into {g} slots")
        out = torch.empty((x.shape[0] // g,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        with warnings.catch_warnings():
            # torch >= 2.13 renames it reduce_scatter_single
            warnings.simplefilter("ignore", FutureWarning)
            dist.reduce_scatter_tensor(out, x, group=group)
        return out.movedim(0, dim)

    @_spanned
    def all_to_all(self, t: torch.Tensor, in_splits, out_splits):
        """The whole world's all-to-all (`dist.all_to_all_single`), which
        every rank of the world calls, idle ones too: this rank's 1-D t is
        cut into consecutive chunks of in_splits[d] elements, chunk d goes
        to world rank d, and the chunks received, out_splits[s] elements
        from rank s, come back concatenated in rank order. Recorded with
        the axes () of the world."""
        import torch.distributed as dist

        self._log("all_to_all", (), t)
        if not dist.is_initialized():
            return t.clone()
        out = t.new_empty(sum(out_splits))
        dist.all_to_all_single(out, t.contiguous(), list(out_splits),
                               list(in_splits))
        return out

    @_spanned
    def gather(self, t: torch.Tensor, root: int = 0):
        """[P, *t.shape] of every grid rank's tensor, in rank order, on grid
        rank `root`; None on the other ranks."""
        import torch.distributed as dist

        axes = AXES
        self._log("gather", axes, t)
        group, members = self._group(axes)
        if group is None:
            return t.clone()[None]
        x = t.contiguous()
        if x.is_complex():
            # gloo's gather refuses complex: the same bytes as real pairs
            x = torch.view_as_real(x)
        parts = ([torch.empty_like(x) for _ in members]
                 if self.rank == root else None)
        dist.gather(x, parts, dst=members[root], group=group)
        if parts is None:
            return None
        out = torch.stack(parts)
        return torch.view_as_complex(out) if t.is_complex() else out
