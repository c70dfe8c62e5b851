"""Single-source parameter schema (port of ``repro/models/params.py``).

Each model defines ``param_defs() -> nested dict of ParamDef``; from it
``init_tree`` draws real tensors on a chosen device and dtype.  Leaves
are visited in sorted-key order, the order ``jax.tree_util`` flattens
a dict in, so leaf ``i`` here is leaf ``i`` of the JAX tree.  The draws
themselves come from a ``torch.Generator`` and match the JAX package in
distribution, not in bits (``bridge.params_from_numpy`` carries JAX
weights across when bits matter).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.device import resolve_device, torch_dtype


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    axes: tuple                   # logical axis names, len == len(shape)
    init: str = "normal"          # normal | zeros | ones | embed | small
    scale: float = 0.0            # 0 => fan-in default
    dtype: str = "float32"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def p(shape, axes, init="normal", scale=0.0, dtype="float32") -> ParamDef:
    return ParamDef(tuple(shape), tuple(axes), init, scale, dtype)


def tree_leaves(tree) -> list:
    """Leaves in ``jax.tree_util`` order: dict keys sorted, recursively."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _std(d: ParamDef) -> float:
    fan_in = d.shape[0] if len(d.shape) == 1 else int(np.prod(d.shape[:-1]))
    if d.init == "embed":
        return d.scale or 1.0
    if d.init == "small":
        return d.scale or 0.02
    return d.scale or (1.0 / math.sqrt(max(fan_in, 1)))


def _init_one(d: ParamDef, gen: torch.Generator, device, dtype):
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    x = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(_std(d)).to(dtype)


def init_tree(defs, seed: int = 0, *, device=None, dtype=None) -> dict:
    """Draw every leaf of ``defs`` on ``device`` (default: the card).

    ``dtype`` overrides each ParamDef's dtype — serving at full width
    draws straight into the compute dtype instead of keeping fp32
    masters.  One generator, seeded once, visits the leaves in sorted
    key order, so a seed names one parameter set."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(tree[k]) for k in sorted(tree)}
        dt = torch_dtype(dtype if dtype is not None else tree.dtype)
        return _init_one(tree, gen, dev, dt)
    return walk(defs)


def count_params(defs) -> int:
    return int(sum(np.prod(d.shape) for d in tree_leaves(defs)))
