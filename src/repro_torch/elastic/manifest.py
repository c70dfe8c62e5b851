"""Plan-stamped checkpoint manifests (port of
``repro/elastic/manifest.py``; DESIGN.md §13).

A sharded checkpoint carries a ``plan.json`` sidecar next to its chunk
``index.json`` recording *how* the saved tensors map onto the run that
wrote them: the full :class:`~repro_torch.parallel.plan.ParallelPlan`,
the layout's axes and shape, which layout the optimizer state used
(``zero1_flat`` flat shards vs a replicated ``tree``), and the
flat-master offset table — the per-leaf ``[start, end)`` element
ranges in sorted-key order that ``core.ddp.init_zero1_state``
concatenates.  That offset table is the index-remap substrate for
cross-plan resharding.  The gradient bucket layout
(``core.bucketing.plan_buckets`` slices and ``bucket_leaf_ranges``) is
stamped alongside.

The port has no mesh: the layout comes from the plan and the run's
``core.grid.Grid``, named as the JAX launcher's ``build_mesh`` names
its mesh — ``("data", "model")`` of shape ``(1, 1)`` for one device
(gspmd), ``("pod", "data")`` of shape ``(pods, data)`` for ddp,
``("pipe", "pod", "data")`` of shape ``(stages, pods, data)`` for pp —
so the manifest of a run reads as the JAX package's of the same
layout.
"""
from __future__ import annotations

import dataclasses
import json

import torch

from repro_torch.ckpt.manager import named_leaves
from repro_torch.core import bucketing
from repro_torch.models.params import tree_map
from repro_torch.parallel.plan import ParallelPlan

MANIFEST_NAME = "plan.json"
FORMAT = 1


def plan_to_dict(plan: ParallelPlan) -> dict:
    """JSON-ready dict of every plan field (tuples become lists)."""
    d = dataclasses.asdict(plan)
    d["batch_axes"] = list(d["batch_axes"])
    return d


def plan_from_dict(d: dict) -> ParallelPlan:
    d = dict(d)
    d["batch_axes"] = tuple(d.get("batch_axes", ("pod", "data")))
    return ParallelPlan(**d)


def plans_equal(plan: ParallelPlan, stamped: dict) -> bool:
    return plan_to_dict(plan) == dict(stamped)


def mesh_to_dict(plan: ParallelPlan, grid=None) -> dict:
    """The run's layout as the JAX launcher's mesh names it."""
    if plan.mode in ("ddp", "pp"):
        if grid is None:
            raise ValueError(f"a {plan.mode} layout needs the run's grid")
        if plan.mode == "pp":
            return {"axes": ["pipe", "pod", "data"],
                    "shape": [grid.stages, grid.pods, grid.data]}
        return {"axes": ["pod", "data"], "shape": [grid.pods, grid.data]}
    return {"axes": ["data", "model"], "shape": [1, 1]}


def master_layout(params_template, bucket_bytes=None) -> dict:
    """Flat fp32 master layout for a params tree.

    ``offsets`` maps each leaf path to its ``[start, end)`` element range
    in the flat concat (sorted-key order — the order ``init_zero1_state``
    / ``bucketing.flatten_tree`` produce), derived from the gradient
    :class:`~repro_torch.core.bucketing.BucketPlan` so the stamped bucket
    slices and the master offsets can never disagree.
    """
    f32 = tree_map(lambda x: torch.empty(tuple(x.shape), dtype=torch.float32,
                                         device="meta"), params_template)
    bplan = bucketing.plan_buckets(
        f32, bucketing.DEFAULT_BUCKET_BYTES if bucket_bytes is None
        else bucket_bytes)
    paths = [path for path, _ in named_leaves(params_template)]
    offsets = [0]
    for size in bplan.sizes:
        offsets.append(offsets[-1] + size)
    ranges = bucketing.bucket_leaf_ranges(bplan)
    return {
        "total": int(offsets[-1]),
        "offsets": {path: [int(offsets[i]), int(offsets[i + 1])]
                    for i, path in enumerate(paths)},
        "shapes": {path: list(shape)
                   for path, shape in zip(paths, bplan.shapes)},
        "bucket_slices": [[int(s), int(e)] for s, e in bplan.bucket_slices],
        "bucket_leaf_ranges": [[int(a), int(b)] for a, b in ranges],
    }


def build_manifest(step: int, plan: ParallelPlan, grid, params_template,
                   layout: str, flat: dict | None = None) -> dict:
    man = {
        "format": FORMAT,
        "step": int(step),
        "plan": plan_to_dict(plan),
        "mesh": mesh_to_dict(plan, grid),
        "layout": layout,
        "master": master_layout(params_template, plan.bucket_bytes),
    }
    if flat is not None:
        man["flat"] = flat
    return man


def dumps(man: dict) -> bytes:
    return json.dumps(man, indent=1).encode()


def loads(raw: bytes) -> dict:
    return json.loads(raw.decode())
