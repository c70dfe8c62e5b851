"""Gradient bucketing — the HaiScale DDP overlap unit (port of
``repro/core/bucketing.py``; paper §V-A).

HaiScale DDP starts each gradient bucket's all-reduce as soon as
backprop has produced it, overlapping the weak-link transfer with the
rest of the backward.  Gradients are packed into fixed-byte buckets in
reverse leaf order (the last leaves first), each bucket synced by its
own collective.  Leaves are visited in the sorted-key order of
``models.params.tree_leaves`` (``jax.tree_util``'s order), so for the
same tree ``bucket_slices`` equal the JAX package's.

The flat concat travels in ``wire_dtype`` — by default the promoted
dtype of the leaves, so an all-bf16 gradient tree stays bf16 on the
wire.  Leaf dtypes are restored on unflatten.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.device import torch_dtype
from repro_torch.models.params import tree_leaves, tree_map, \
    tree_unflatten

DEFAULT_BUCKET_BYTES = 25 * 1024 * 1024   # torch-DDP-style default


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    template: object         # the tree's nesting, leaves None
    shapes: tuple
    dtypes: tuple
    sizes: tuple
    bucket_slices: tuple     # (start, end) into the flat concat
    wire_dtype: torch.dtype  # dtype of the flat concat on the wire


def _promoted_dtype(dtypes):
    if not dtypes:
        return torch.float32
    return functools.reduce(torch.promote_types, dtypes)


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def plan_buckets(tree, bucket_bytes=DEFAULT_BUCKET_BYTES,
                 wire_dtype=None) -> BucketPlan:
    """Buckets of whole leaves over ``tree`` (tensors, or anything with
    ``shape`` and a torch ``dtype``); budgets count wire bytes."""
    leaves = tree_leaves(tree)
    shapes = tuple(tuple(l.shape) for l in leaves)
    dtypes = tuple(l.dtype for l in leaves)
    sizes = tuple(math.prod(s) for s in shapes)
    wire = torch_dtype(wire_dtype) if wire_dtype is not None \
        else _promoted_dtype(dtypes)
    item = _itemsize(wire)
    # reverse order: the leaves whose gradients finish last in the
    # forward order finish first in the backward, so their bucket can
    # start earliest
    slices = []
    start = end = sum(sizes)
    cur = 0
    for sz in sizes[::-1]:
        b = sz * item
        if cur + b > bucket_bytes and cur > 0:
            slices.append((start, end))
            end = start
            cur = 0
        start -= sz
        cur += b
    slices.append((start, end))
    return BucketPlan(tree_map(lambda _: None, tree), shapes, dtypes, sizes,
                      tuple(slices), wire)


def bucket_leaf_ranges(plan: BucketPlan) -> tuple:
    """Each bucket's flat slice as the (i0, i1) range of leaves it
    covers (buckets hold whole leaves)."""
    offsets = [0]
    for s in plan.sizes:
        offsets.append(offsets[-1] + s)
    index = {off: i for i, off in enumerate(offsets)}
    ranges = []
    for start, end in plan.bucket_slices:
        assert start in index and end in index, (start, end, offsets)
        ranges.append((index[start], index[end]))
    return tuple(ranges)


def flatten_tree(tree, wire_dtype=None) -> torch.Tensor:
    return flatten_leaves(tree_leaves(tree), wire_dtype)


def flatten_leaves(leaves, wire_dtype=None) -> torch.Tensor:
    if wire_dtype is None:
        wire_dtype = _promoted_dtype([l.dtype for l in leaves])
    return torch.cat([l.reshape(-1).to(wire_dtype) for l in leaves])


def unflatten_leaves(flat, shapes, dtypes, sizes) -> list:
    """Split a flat concat back into leaves (restoring leaf dtypes)."""
    out, off = [], 0
    for shape, dtype, size in zip(shapes, dtypes, sizes):
        out.append(flat[off:off + size].reshape(shape).to(dtype))
        off += size
    return out


def unflatten_tree(plan: BucketPlan, flat):
    return tree_unflatten(plan.template, unflatten_leaves(
        flat, plan.shapes, plan.dtypes, plan.sizes))


def bucketed_apply(plan: BucketPlan, tree, fn):
    """Apply ``fn`` (a collective) per bucket of the flattened tree."""
    flat = flatten_tree(tree, plan.wire_dtype)
    parts = [fn(flat[s:e]) for s, e in plan.bucket_slices]
    # bucket_slices cover [0, total) in reverse contiguous order
    ordered = sorted(zip(plan.bucket_slices, parts), key=lambda t: t[0][0])
    return unflatten_tree(plan, torch.cat([p for _, p in ordered]))
