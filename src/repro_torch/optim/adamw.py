"""AdamW with fp32 master weights and mixed-precision working params
(port of ``repro/optim/adamw.py``).

State layout, keys as in the JAX package:
  params : working copy in ``param_dtype`` (bf16 by default)
  master : fp32
  m, v   : Adam moments in ``moments_dtype`` (fp32 by default)
  step   : 0-dim int32

The arithmetic is the JAX package's: clip the gradients by their global
norm first, then per leaf m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g²,
master -= lr (m / bc1 / (sqrt(v / bc2) + eps) + wd master) — weight
decay on every leaf, inside lr — and params = master cast to
``param_dtype``.  It is not ``torch.optim.AdamW``, which has no
master / working-copy split.

Where JAX returns a new state and donates the old one, ``apply`` updates
the state's tensors in place under ``torch.no_grad()``: the old state
dict sees the new values.  ``init`` takes ownership of ``params`` the
same way: a leaf that already has ``param_dtype`` becomes the state's
working copy without a copy.  The global norm and the update walk each
leaf in flat chunks, so no fp32 copy of the whole gradient tree (15 GB
for 3.8 B bf16 gradients) or of one whole leaf ever exists; the clip
scale multiplies each chunk inside its update.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Union

import torch

from repro_torch.device import torch_dtype
from repro_torch.models.params import tree_leaves, tree_map

CHUNK = 1 << 24    # elements per flat chunk (64 MiB in fp32)


def _chunks(t):
    """Flat views of ``t`` (contiguous) of at most CHUNK elements."""
    flat = t.reshape(-1)
    return [flat[i:i + CHUNK] for i in range(0, flat.numel(), CHUNK)]


def global_norm(tree) -> torch.Tensor:
    """sqrt(sum of squares) over every leaf, in fp32 (0-dim tensor)."""
    total = None
    for leaf in tree_leaves(tree):
        for c in _chunks(leaf):
            sq = torch.sum(torch.square(c.float()))
            total = sq if total is None else total + sq
    return torch.sqrt(total)


def _clip_scale(norm, max_norm):
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(tree, max_norm):
    """(tree scaled to a global norm of at most ``max_norm``, in fp32;
    the norm).  ``AdamW.apply`` scales inside its update instead."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.float() * scale, tree), norm


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[float, Callable] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    param_dtype: str = "bfloat16"   # working-copy dtype
    moments_dtype: str = "float32"  # m/v dtype

    def _lr(self, step):
        return self.lr(step) if callable(self.lr) else self.lr

    def init(self, params) -> dict:
        pdt, mdt = torch_dtype(self.param_dtype), \
            torch_dtype(self.moments_dtype)
        leaf = tree_leaves(params)[0]
        return {
            "params": tree_map(lambda x: x.detach().to(pdt).contiguous(),
                               params),
            # always a distinct buffer, also when params are fp32
            "master": tree_map(lambda x: x.detach().to(torch.float32,
                                                       copy=True), params),
            "m": tree_map(lambda x: torch.zeros(x.shape, dtype=mdt,
                                                device=x.device), params),
            "v": tree_map(lambda x: torch.zeros(x.shape, dtype=mdt,
                                                device=x.device), params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device),
        }

    def update_fn(self, step):
        """The per-leaf Adam update at ``step`` (post-clip):
        ``upd(g, m, v, master)`` updates m, v and master in place (any
        matching flat slices of them)."""
        lr = self._lr(step)
        b1, b2 = self.b1, self.b2
        stepf = step.float()
        bc1 = 1.0 - torch.pow(b1, stepf)
        bc2 = 1.0 - torch.pow(b2, stepf)

        def upd(g, m, v, mast):
            g = g.float()
            m32 = b1 * m.float() + (1 - b1) * g
            v32 = b2 * v.float() + (1 - b2) * torch.square(g)
            mast.sub_(lr * (m32 / bc1 / (torch.sqrt(v32 / bc2) + self.eps)
                            + self.weight_decay * mast))
            m.copy_(m32)
            v.copy_(v32)

        return upd

    @torch.no_grad()
    def apply(self, state, grads) -> dict:
        """One step from ``grads`` (the params' tree, any float dtype);
        updates ``state``'s tensors in place and returns the state."""
        step = state["step"] + 1
        scale = _clip_scale(global_norm(grads), self.clip_norm)
        upd = self.update_fn(step)
        leaves = [tree_leaves(state[k]) for k in ("params", "master", "m",
                                                  "v")]
        for g, p, mast, m, v in zip(tree_leaves(grads), *leaves):
            for gc, pc, mac, mc, vc in zip(*map(_chunks, (g, p, mast, m, v))):
                upd(gc.float() * scale, mc, vc, mac)
                pc.copy_(mac)
        return {**state, "step": step}
