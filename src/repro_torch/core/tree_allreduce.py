"""Double-binary-tree all-reduce (paper §IV Algorithm 2, Sanders et al.)
and a ring reference over ``torch.distributed`` point-to-point sends
(port of ``repro/core/tree_allreduce.py``).

The data is split in two halves, each reduced up (and broadcast down) a
different binary tree so that every rank is an interior node in at most
one tree.  Each tree round is one ``grid.ppermute`` (a batch of
isend / irecv); the schedule is the JAX package's, computed in Python
from the group size.  A tree takes 2·log2(n) rounds, a ring 2·(n-1).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.grid import ppermute


# ------------------------- schedule construction ---------------------------


def _inorder_tree(ranks):
    """In-order binary tree; returns {child: (parent, side)} and depths."""
    parent, depth = {}, {}

    def build(lo, hi, d, par, side):
        if lo > hi:
            return
        mid = (lo + hi) // 2
        r = ranks[mid]
        parent[r] = (par, side)
        depth[r] = d
        build(lo, mid - 1, d + 1, r, "L")
        build(mid + 1, hi, d + 1, r, "R")

    build(0, len(ranks) - 1, 0, -1, "")
    return parent, depth


def tree_schedule(n: int, shift: int = 0):
    """Rounds of (src, dst) pairs for the reduce and broadcast phases."""
    ranks = [(i + shift) % n for i in range(n)]
    parent, depth = _inorder_tree(ranks)
    maxd = max(depth.values())
    reduce_rounds, bcast_rounds = [], []
    for d in range(maxd, 0, -1):
        for side in ("L", "R"):
            pairs = [(c, p) for c, (p, s) in parent.items()
                     if depth[c] == d and s == side and p >= 0]
            if pairs:
                reduce_rounds.append(pairs)
    for d in range(1, maxd + 1):
        for side in ("L", "R"):
            pairs = [(p, c) for c, (p, s) in parent.items()
                     if depth[c] == d and s == side and p >= 0]
            if pairs:
                bcast_rounds.append(pairs)
    return reduce_rounds, bcast_rounds


# ------------------------------ collectives --------------------------------


def _tree_allreduce_one(x, group, shift):
    n = dist.get_world_size(group)
    if n == 1:
        return x
    reduce_rounds, bcast_rounds = tree_schedule(n, shift)
    acc = x
    for pairs in reduce_rounds:
        recvd = ppermute(acc, group, pairs)
        if recvd is not None:
            acc = acc + recvd
    for pairs in bcast_rounds:
        recvd = ppermute(acc, group, pairs)
        if recvd is not None:
            acc = recvd
    return acc


def tree_allreduce(x, group):
    """Double binary tree: two complementary trees, half the data each."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    flat = x.reshape(-1)
    pad = flat.shape[0] % 2
    if pad:
        flat = torch.cat([flat, flat.new_zeros(1)])
    h1, h2 = flat.chunk(2)
    out = torch.cat([_tree_allreduce_one(h1, group, 0),
                     _tree_allreduce_one(h2, group, n // 2 or 1)])
    if pad:
        out = out[:-1]
    return out.reshape(x.shape)


def ring_allreduce(x, group):
    """Reference ring (reduce-scatter + all-gather), the 'NCCL' analogue."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    acc = flat.reshape(n, -1).clone()
    idx = dist.get_rank(group)
    fwd = [(i, (i + 1) % n) for i in range(n)]
    # reduce-scatter: after n-1 steps rank r owns the full sum of chunk r+1
    send_idx = idx
    send = acc[send_idx]
    for _ in range(n - 1):
        recvd = ppermute(send, group, fwd)
        recv_idx = (send_idx - 1) % n
        acc[recv_idx] = acc[recv_idx] + recvd
        send_idx = recv_idx
        send = acc[recv_idx].clone()
    # all-gather ring
    own_idx = send_idx
    send = acc[own_idx].clone()
    for step in range(n - 1):
        recvd = ppermute(send, group, fwd)
        acc[(own_idx - 1 - step) % n] = recvd
        send = recvd
    out = acc.reshape(-1)
    if pad:
        out = out[:-pad]
    return out.reshape(x.shape)
