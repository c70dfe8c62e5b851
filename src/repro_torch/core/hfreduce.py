"""HFReduce: the hierarchical all-reduce that minimises weak-link bytes
(port of ``repro/core/hfreduce.py``; paper §IV).

Fire-Flyer reduces inside the node first, then across nodes over the
single NIC, then broadcasts back.  Over a ``core.grid.Grid`` the strong
group is the pod and the weak group crosses pods:

  phase 1  reduce_scatter over the strong group   (intra-pod)
           (optional prescale of the 1/strong shard)
  phase 2  all-reduce over the weak group         (cross-pod, of 1/strong)
  phase 3  all_gather over the strong group       (intra-pod broadcast)

Cross-pod bytes per rank: 2 * |x| / strong (vs 2 * |x| for a flat
all-reduce).  Phase 2 can compress its payload (``core/compression.py``).
Every rank of the grid calls these functions together.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.grid import all_gather, all_reduce, reduce_scatter
from repro_torch.models.params import tree_map


def _pad_to(x, mult):
    pad = (-x.shape[0]) % mult
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return x, pad


def hfreduce(x, *, strong, weak, weak_psum=None, prescale=None):
    """Hierarchical all-reduce of ``x`` (any shape) over the strong and
    weak groups.

    ``weak_psum(x, group)`` overrides the cross-pod phase (a compressed
    or tree-scheduled all-reduce); default ``grid.all_reduce``.
    ``prescale``: a scalar multiplied into the intra-pod shard, in the
    shard's dtype, *before* the weak phase: gradient means (1/n_shards)
    belong there, so a narrow wire format quantizes mean-magnitude values
    (fp8 e4m3 saturates at 448) and its step size is 1/n_shards smaller.
    """
    weak_psum = weak_psum or all_reduce
    flat, pad = _pad_to(x.reshape(-1), dist.get_world_size(strong))
    shard = reduce_scatter(flat, strong)
    if prescale is not None:
        shard = shard * torch.tensor(prescale, dtype=shard.dtype)
    shard = weak_psum(shard, weak)
    full = all_gather(shard, strong)
    if pad:
        full = full[:-pad]
    return full.reshape(x.shape)


def flat_allreduce(x, *, group):
    """Baseline: one flat all-reduce over every rank (the 'NCCL ring'
    analogue; ``group``: the grid's world group)."""
    return all_reduce(x, group)


def hfreduce_tree(x, *, strong, weak):
    """HFReduce with the paper's double-binary-tree cross-pod phase."""
    from repro_torch.core.tree_allreduce import tree_allreduce
    return hfreduce(x, strong=strong, weak=weak, weak_psum=tree_allreduce)


def hfreduce_pytree(tree, **kw):
    """hfreduce leaf by leaf over a gradient tree."""
    return tree_map(lambda g: hfreduce(g, **kw), tree)


# ---------------------------------------------------------------------------
# Cost model: bytes each rank pushes across the pod boundary per all-reduce
# of V bytes.
# ---------------------------------------------------------------------------


def crosspod_bytes_flat(v_bytes: int, pods: int, intra: int) -> float:
    """Flat ring all-reduce over pods*intra ranks: every byte crosses the
    boundary ~2x (reduce and gather phases pass the cut once each way)."""
    if pods == 1:
        return 0.0
    return 2.0 * v_bytes * (pods - 1) / pods


def crosspod_bytes_hier(v_bytes: int, pods: int, intra: int) -> float:
    """Hierarchical: only the 1/intra shard crosses, twice."""
    if pods == 1:
        return 0.0
    return 2.0 * (v_bytes / intra) * (pods - 1) / pods
