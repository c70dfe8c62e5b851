"""Cross-plan checkpoint resharding (port of
``repro/elastic/reshard.py``; DESIGN.md §13).

A checkpoint taken under one ``(ParallelPlan, layout)`` is remapped onto
another in three moves, all host-side index arithmetic:

  1. **canonicalize** — reassemble whatever the source wrote back into
     one flat fp32 master (and m/v) vector: ZeRO-1 shard slices are
     placed at their stamped ``[start, end)`` offsets; replicated trees
     are flattened leaf-by-leaf at the manifest's per-path offsets.
  2. **remap** — copy each leaf's source range onto its range in the
     *target* layout (``manifest.master_layout`` of the target params
     template).  Same model ⇒ same paths; only the split changes.
  3. **specialize** — cut the canonical flats for the target: a ZeRO-1
     target (``plan.mode == "ddp"`` with ``zero1``) takes this rank's
     shard at ``core.ddp._zero1_layout``'s offset (strong-major, as
     ``init_zero1_state`` lays it out), so a resharded state is
     indistinguishable from a fresh one; a tree target unflattens back
     to leaves.

The target state lands on the params template's device.  Same plan and
layout round-trip bitwise (pure byte moves, no arithmetic).
"""
from __future__ import annotations

import torch

from repro_torch.ckpt.manager import adopt, named_leaves, read_named, \
    unflatten_like
from repro_torch.core.ddp import _zero1_layout
from repro_torch.elastic import manifest as manifest_lib

FLAT_KEYS = ("master", "m", "v")


def _check_cover(comp: dict, total: int) -> None:
    """The saved shard slices of a flat component must tile ``[0,
    total)`` without a gap."""
    end = 0
    for rec in sorted(comp["shards"], key=lambda r: r["start"]):
        if rec["start"] > end:
            break
        end = max(end, rec["end"])
    if end < total:
        raise ValueError(
            f"flat shards cover only [0, {end}) of {total} elements — "
            "checkpoint is missing shard slices")


def _assemble_flat(comp: dict, tensors: dict, total: int) -> torch.Tensor:
    """Reassemble a flat component from its saved shard slices."""
    recs = comp["shards"]
    out = torch.zeros((comp["padded"],), dtype=tensors[recs[0]["name"]].dtype)
    for rec in recs:
        out[rec["start"]:rec["end"]] = tensors[rec["name"]]
    return out[:total]


def canonical_state(manager, step: int) -> dict:
    """Read checkpoint ``step`` into canonical host form.

    Returns ``{"params": {path: tensor}, "flats": {master/m/v flat
    unpadded vectors}, "step": int, "manifest": dict}`` — the midpoint
    every (source plan → target plan) pair goes through.
    """
    man = manager.load_manifest(step)
    total = man["master"]["total"]
    offsets = man["master"]["offsets"]
    if man["layout"] == "zero1_flat":
        for key in FLAT_KEYS:             # before reading any bytes
            _check_cover(man["flat"][key], total)
    tensors, _ = read_named(manager.backend, step)
    params = {p: tensors[f"params/{p}"] for p in offsets}
    flats = {}
    if man["layout"] == "zero1_flat":
        for key in FLAT_KEYS:
            flats[key] = _assemble_flat(man["flat"][key], tensors, total)
    else:
        for key in FLAT_KEYS:
            buf = None
            for path, (s, e) in offsets.items():
                leaf = tensors[f"{key}/{path}"]
                if buf is None:
                    buf = torch.zeros((total,), dtype=leaf.dtype)
                buf[s:e] = leaf.reshape(-1)
            flats[key] = buf
    return {"params": params, "flats": flats,
            "step": int(tensors["step"]), "manifest": man}


def _remap_flat(src_flat: torch.Tensor, src_offsets: dict,
                dst_offsets: dict) -> torch.Tensor:
    """The index remap: each leaf's source slice lands on its target
    slice.  Identical offset tables need no copy."""
    if src_offsets == dst_offsets:
        return src_flat
    total = max((e for _, e in dst_offsets.values()), default=0)
    out = torch.zeros((total,), dtype=src_flat.dtype)
    for path, (t0, t1) in dst_offsets.items():
        s0, s1 = src_offsets[path]
        out[t0:t1] = src_flat[s0:s1]
    return out


def reshard(manager, plan_b, grid_b, params_template, *, step: int):
    """Remap checkpoint ``step`` onto ``(plan_b, grid_b)`` (``grid_b``:
    the target run's ``core.grid.Grid``, None for one device).

    ``params_template`` is the target run's params tree (working dtype
    and device); returns ``(state, step)`` ready for ``plan_b``'s
    executor on this rank.  A tree restored onto the same tree skips
    the canonical flats: each leaf comes straight from its stored bytes
    (the same values the flats would give back).
    """
    man = manager.load_manifest(step)
    src_off = {p: tuple(v) for p, v in man["master"]["offsets"].items()}
    dst_layout = manifest_lib.master_layout(params_template,
                                            plan_b.bucket_bytes)
    dst_off = {p: tuple(v) for p, v in dst_layout["offsets"].items()}
    missing = sorted(set(dst_off) - set(src_off))
    if missing:
        raise KeyError(
            f"target params leaves absent from checkpoint: {missing[:5]}"
            f"{'...' if len(missing) > 5 else ''}")
    zero1 = plan_b.mode == "ddp" and plan_b.zero1
    if man["layout"] == "tree" and not zero1 and src_off == dst_off:
        tensors, _ = read_named(manager.backend, step)
        step_val = int(tensors["step"])
        params_src = {p: tensors[f"params/{p}"] for p in src_off}

        def piece(key, path):
            return tensors[f"{key}/{path}"].reshape(-1)
    else:
        can = canonical_state(manager, step)
        params_src, step_val = can["params"], can["step"]
        flats = {k: _remap_flat(can["flats"][k], src_off, dst_off)
                 for k in FLAT_KEYS}

        def piece(key, path):
            s, e = dst_off[path]
            return flats[key][s:e]

    leaves = named_leaves(params_template)
    dev = leaves[0][1].device
    params = unflatten_like(params_template, [
        adopt(params_src[path], leaf) for path, leaf in leaves])
    step_t = torch.tensor(step_val, dtype=torch.int32, device=dev)

    if zero1:
        if grid_b is None:
            raise ValueError("a ZeRO-1 target needs the run's grid")
        total, padded, offset = _zero1_layout(params_template, grid_b)
        shard = padded // grid_b.size

        def mine(v, dtype=None):
            """This rank's [offset, offset + shard) of the padded flat."""
            out = torch.zeros((shard,), dtype=dtype or v.dtype, device=dev)
            n = max(0, min(shard, v.shape[0] - offset))
            if n:
                out[:n].copy_(v[offset:offset + n])
            return out

        state = {"params": params,
                 "master": mine(flats["master"], torch.float32),
                 "m": mine(flats["m"]), "v": mine(flats["v"]),
                 "step": step_t}
    else:
        # replicated tree state: the one-device executor's layout
        def tree_of(key, dtype=None):
            out = []
            for path, leaf in leaves:
                x = piece(key, path)
                out.append(x.reshape(leaf.shape).to(
                    device=dev, dtype=dtype or x.dtype, copy=True))
            return unflatten_like(params_template, out)

        state = {"params": params, "master": tree_of("master", torch.float32),
                 "m": tree_of("m"), "v": tree_of("v"), "step": step_t}
    return state, step
