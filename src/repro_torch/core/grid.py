"""The ("pipe", "pod", "data") grid of a HaiScale run over
``torch.distributed``: the counterpart of the JAX launcher's mesh.

``Grid(pods, data, pipe=1)`` splits the world of ``pipe * pods * data``
ranks into ``pipe`` stages of ``pods * data`` ranks.  Rank r is stage
r // (pods * data), then pod, then data index — the device order of the
JAX launcher's mesh ``("pipe", "pod", "data")`` (``("pod", "data")``
when pipe is 1) — so rank r holds the same batch rows as JAX device r.
Within its stage a rank has one *strong* group (the ranks of its pod:
the intra-node fabric in the paper, the "data" axis), one *weak* group
(its data index in every pod of the stage: the cross-pod link, the
"pod" axis) and ``world``, the stage's ranks (the batch axes);
``grid.pipe`` is the group of the ranks at its (pod, data) position
across the stages, ordered by stage.  ``grid.size`` counts a stage's
ranks (the batch shards), ``grid.ranks`` all of them, and ``grid.all``
is a group of every rank (``world`` itself when pipe is 1).  The JAX
``axis_size`` of an axis is its group's size.

``members=n`` builds the grid over the first n ranks of the default
group only (the survivors of an elastic rescale, ``platform/runner.py``:
the JAX runner switches to a smaller mesh, the port to a grid over
fewer ranks).  ``dist.new_group`` is collective over the default group,
so every rank builds such a grid, the ranks outside it too, before any
of them leaves; outside it ``grid.member`` is False and the grid has
no groups.  Its ranks keep their default-group ranks.

The collectives below take a ``ProcessGroup`` where the JAX functions
take an axis name, and return new tensors as the JAX ones do:
``all_reduce``, ``reduce_scatter`` (tiled, as ``psum_scatter``),
``all_gather`` (tiled), ``all_to_all`` (split and concatenated on dim
0), ``ppermute`` (pairs of group ranks) and ``sendrecv`` (one batch of
point-to-point sends and receives).

Staging.  The backend is gloo, which moves host memory.
``staging="host"`` is HFReduce's own path (paper §IV): a CUDA tensor is
copied to pinned host memory, the collective runs on the host, and the
result is copied back to the card; what happens between collectives
(quantize, dequantize, the local sum) stays on the card.  The caller
chooses the staging when it builds the grid.  A CUDA tensor given to a
group without staging raises; nothing is staged by catching an error.
``backend="nccl"`` (one rank per card, collectives on the card) raises:
no machine that runs the port's checks has two cards yet (ROADMAP A7,
"nccl backend").
"""
from __future__ import annotations

import socket

import torch
import torch.distributed as dist

STAGINGS = (None, "host")
_STAGING: dict = {}         # ProcessGroup -> its staging (None or "host")


class Grid:
    """Process groups of a pipe x pods x data grid; needs an initialised
    default process group of ``pipe * pods * data`` ranks.  Every rank
    must build the grid, in the same order as every other group it
    builds."""

    def __init__(self, pods: int, data: int, pipe: int = 1,
                 backend: str = "gloo", staging=None, members=None):
        if backend == "nccl":
            raise NotImplementedError(
                "Grid(backend='nccl') is not ported yet: one rank per card "
                "with collectives on the card waits for a machine with two "
                "or more cards (ROADMAP A7, nccl backend); use "
                "backend='gloo' with staging='host'")
        if backend != "gloo":
            raise ValueError(f"backend={backend!r}; want 'gloo'")
        if staging not in STAGINGS:
            raise ValueError(f"staging={staging!r}; want one of {STAGINGS}")
        if not dist.is_initialized():
            raise RuntimeError("Grid needs torch.distributed initialised "
                               "(init_process_group) first")
        world = dist.get_world_size()
        n = world if members is None else members
        if n != pipe * pods * data or n > world:
            raise ValueError(f"{pipe} stages x {pods} pods x {data} data = "
                             f"{pipe * pods * data} ranks, but the grid "
                             f"spans {n} of the world's {world}")
        self.stages, self.pods, self.data = pipe, pods, data
        self.staging = staging
        self.size = pods * data
        self.ranks = n
        self.rank = dist.get_rank()
        self.member = self.rank < n
        # outside the grid: the same new_group calls, no group kept
        self.stage, shard = divmod(self.rank, self.size) if self.member \
            else (None, None)
        self.pod, self.data_index = divmod(shard, data) if self.member \
            else (None, None)
        self.world = self.strong = self.weak = self.pipe = self.all = None
        if pipe > 1:
            self.all = self._group(list(range(n)))
        for s in range(pipe):
            base = s * self.size
            g = self._group(list(range(base, base + self.size)))
            if s == self.stage:
                self.world = g
            for p in range(pods):
                g = self._group([base + p * data + j for j in range(data)])
                if (s, p) == (self.stage, self.pod):
                    self.strong = g
            for j in range(data):
                g = self._group([base + p * data + j for p in range(pods)])
                if (s, j) == (self.stage, self.data_index):
                    self.weak = g
        if pipe == 1:
            self.all = self.world
        for k in range(self.size):
            g = self._group([s * self.size + k for s in range(pipe)])
            if k == shard:
                self.pipe = g

    def _group(self, ranks):
        g = dist.new_group(ranks, backend="gloo")
        if self.rank in ranks:
            _STAGING[g] = self.staging
            return g
        return None

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` rows (split over
        a stage's ranks; every stage holds the same rows)."""
        if n % self.size:
            raise ValueError(f"a global batch of {n} rows does not split "
                             f"over {self.size} ranks")
        per = n // self.size
        shard = self.rank % self.size
        return slice(shard * per, (shard + 1) * per)


def free_port() -> int:
    """A free TCP port on localhost, for a process group's store."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _staged(x, group) -> bool:
    if not x.is_cuda:
        return False
    if _STAGING.get(group) == "host":
        return True
    raise ValueError("a CUDA tensor reached a gloo group without staging; "
                     "build the Grid with staging='host'")


def _host(x):
    """A pinned host copy of the CUDA tensor ``x``, complete on return."""
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x, non_blocking=True)
    torch.cuda.current_stream(x.device).synchronize()
    return h


def _run(group, x, out_shape, collective):
    """``collective(out, inp)`` on host or local tensors; the result
    comes back on ``x``'s device."""
    if _staged(x, group):
        out = torch.empty(out_shape, dtype=x.dtype, pin_memory=True)
        collective(out, _host(x))
        return out.to(x.device, non_blocking=True)
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    collective(out, x.contiguous())
    return out


def all_reduce(x, group):
    """Sum of ``x`` over the group (a new tensor)."""
    def run(out, inp):
        out.copy_(inp)
        dist.all_reduce(out, group=group)
    return _run(group, x, x.shape, run)


def reduce_scatter(x, group):
    """x (n, ...) with n % size == 0 -> the group rank's 1/size of the
    sum over the group (``psum_scatter(tiled=True)``)."""
    P = dist.get_world_size(group)
    if x.shape[0] % P:
        raise ValueError(f"reduce_scatter of {x.shape[0]} rows over {P}")
    return _run(group, x, (x.shape[0] // P,) + tuple(x.shape[1:]),
                lambda out, inp: dist.reduce_scatter_tensor(out, inp,
                                                              group=group))


def all_gather(x, group):
    """Every rank's ``x`` concatenated on dim 0 in group-rank order
    (``all_gather(tiled=True)``)."""
    P = dist.get_world_size(group)
    return _run(group, x, (x.shape[0] * P,) + tuple(x.shape[1:]),
                lambda out, inp: dist.all_gather_into_tensor(out, inp,
                                                               group=group))


def all_to_all(x, group):
    """x (P, ...) -> out (P, ...) with out[i] = rank i's x[me]."""
    return _run(group, x, x.shape,
                lambda out, inp: dist.all_to_all_single(out, inp,
                                                        group=group))


def sendrecv(group, sends=(), recvs=()):
    """One batch of point-to-point transfers over ``group``: ``sends``
    are (tensor, destination group rank) pairs, ``recvs`` (like,
    source group rank) pairs, where ``like`` gives the shape, dtype and
    device of the tensor to receive.  Returns the received tensors in
    ``recvs``' order, complete (on a staged group: on ``like``'s
    device)."""
    ops, got = [], []
    for x, d in sends:
        src = _host(x) if _staged(x, group) else x.contiguous()
        ops.append(dist.P2POp(dist.isend, src,
                              dist.get_global_rank(group, d), group))
    for like, s in recvs:
        staged = _staged(like, group)
        buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=staged,
                          device="cpu" if staged else like.device)
        ops.append(dist.P2POp(dist.irecv, buf,
                              dist.get_global_rank(group, s), group))
        got.append((buf, staged, like.device))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [buf.to(dev, non_blocking=True) if staged else buf
            for buf, staged, dev in got]


def ppermute(x, group, pairs):
    """Send ``x`` from src to dst for each (src, dst) of group ranks;
    returns what arrived here, or None where nothing did."""
    me = dist.get_rank(group)
    sends = [(x, d) for s, d in pairs if s == me]
    recvs = [(x, s) for s, d in pairs if d == me]
    got = sendrecv(group, sends, recvs)
    return got[0] if got else None
