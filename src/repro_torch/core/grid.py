"""The ("pod", "data") grid of a HaiScale DDP run over
``torch.distributed``: the counterpart of the JAX mesh's two batch axes.

``Grid(pods, data)`` splits the world of ``pods * data`` ranks into one
*strong* group per pod (the ranks of one pod: the intra-node fabric in
the paper, the "data" axis) and one *weak* group per data index (rank j
of every pod: the cross-pod link, the "pod" axis).  Rank r is pod
r // data and data index r % data — the pod-major order of
``P(("pod", "data"))`` — so rank r holds the same batch rows as JAX
device r.  ``grid.world`` is a group of all ranks.

The collectives below take a ``ProcessGroup`` where the JAX functions
take an axis name, and return new tensors as the JAX ones do:
``all_reduce``, ``reduce_scatter`` (tiled, as ``psum_scatter``),
``all_gather`` (tiled), ``all_to_all`` (split and concatenated on dim
0) and ``ppermute`` (pairs of group ranks, zeros where nothing
arrives).

Staging.  The backend is gloo, which moves host memory.
``stage="host"`` is HFReduce's own path (paper §IV): a CUDA tensor is
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

STAGES = (None, "host")
_STAGE: dict = {}           # ProcessGroup -> its staging (None or "host")


class Grid:
    """Process groups of a pods x data grid; needs an initialised
    default process group of ``pods * data`` ranks.  Every rank must
    build the grid, in the same order as every other group it builds."""

    def __init__(self, pods: int, data: int, backend: str = "gloo",
                 stage=None):
        if backend == "nccl":
            raise NotImplementedError(
                "Grid(backend='nccl') is not ported yet: one rank per card "
                "with collectives on the card waits for a machine with two "
                "or more cards (ROADMAP A7, nccl backend); use "
                "backend='gloo' with stage='host'")
        if backend != "gloo":
            raise ValueError(f"backend={backend!r}; want 'gloo'")
        if stage not in STAGES:
            raise ValueError(f"stage={stage!r}; want one of {STAGES}")
        if not dist.is_initialized():
            raise RuntimeError("Grid needs torch.distributed initialised "
                               "(init_process_group) first")
        world = dist.get_world_size()
        if world != pods * data:
            raise ValueError(f"{pods} pods x {data} data = {pods * data} "
                             f"ranks, but the world has {world}")
        self.pods, self.data, self.stage = pods, data, stage
        self.size = world
        self.rank = dist.get_rank()
        self.pod, self.data_index = divmod(self.rank, data)
        self.world = self._group(list(range(world)))
        for p in range(pods):
            g = self._group([p * data + j for j in range(data)])
            if p == self.pod:
                self.strong = g
        for j in range(data):
            g = self._group([p * data + j for p in range(pods)])
            if j == self.data_index:
                self.weak = g

    def _group(self, ranks):
        g = dist.new_group(ranks, backend="gloo")
        if self.rank in ranks:
            _STAGE[g] = self.stage
        return g

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` rows."""
        if n % self.size:
            raise ValueError(f"a global batch of {n} rows does not split "
                             f"over {self.size} ranks")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


def free_port() -> int:
    """A free TCP port on localhost, for a process group's store."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _staged(x, group) -> bool:
    if not x.is_cuda:
        return False
    if _STAGE.get(group) == "host":
        return True
    raise ValueError("a CUDA tensor reached a gloo group without staging; "
                     "build the Grid with stage='host'")


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


def ppermute(x, group, pairs):
    """Send ``x`` from src to dst for each (src, dst) of group ranks;
    returns what arrived here, or None where nothing did."""
    me = dist.get_rank(group)
    staged = _staged(x, group)
    src = _host(x) if staged else x.contiguous()
    recv, ops = None, []
    for s, d in pairs:
        if s == me:
            ops.append(dist.P2POp(dist.isend, src,
                                  dist.get_global_rank(group, d), group))
        if d == me:
            recv = torch.empty(x.shape, dtype=x.dtype,
                               pin_memory=staged,
                               device="cpu" if staged else x.device)
            ops.append(dist.P2POp(dist.irecv, recv,
                                  dist.get_global_rank(group, s), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if recv is not None and staged:
        recv = recv.to(x.device, non_blocking=True)
    return recv
