"""The one-device train step (port of ``repro/train_lib.py:
make_train_step``, the gspmd executor behind ``parallel.plan``).

New callers go through ``repro_torch.parallel.plan.make_train_step``.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.params import tree_leaves
from repro_torch.models.params import tree_unflatten as _unflatten


def loss_and_grads(model, params, batch, remat=True):
    """(loss, metrics, grads) of ``model.loss(params, batch, remat)``,
    detached; ``grads`` has ``params``' tree and dtypes."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, metrics = model.loss(_unflatten(params, leaves), batch,
                               remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            _unflatten(params, grads))


def make_train_step(model, optimizer, pcfg, device=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    The loss is differentiated with respect to the state's working
    params, each layer recomputed in the backward unless ``pcfg.remat``
    is "none"; with ``pcfg.microbatch`` M > 1 the batch is cut into M
    slices along its first axis, their gradients summed in fp32 and
    divided by M, and the loss averaged, as the JAX scan does.  Batch
    leaves (numpy arrays or tensors) are moved to ``device`` (default:
    the card).  ``optimizer.apply`` then updates the state in place."""
    dev = resolve_device(device)
    M = pcfg.microbatch
    if pcfg.remat not in ("none", "full"):
        raise ValueError(f"remat={pcfg.remat!r}; want 'none' or 'full'")
    remat = pcfg.remat == "full"

    def train_step(state, batch):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        params = state["params"]
        if M > 1:
            gsum, lsum = None, 0.0
            for i in range(M):
                mb = {k: v.reshape(M, v.shape[0] // M, *v.shape[1:])[i]
                      for k, v in batch.items()}
                loss, _, g = loss_and_grads(model, params, mb, remat)
                g = [x.float() for x in tree_leaves(g)]
                gsum = g if gsum is None else [a + b for a, b in
                                               zip(gsum, g)]
                lsum = lsum + loss
            grads = _unflatten(params, [g / M for g in gsum])
            metrics = {"loss": lsum / M}
        else:
            loss, mets, grads = loss_and_grads(model, params, batch, remat)
            metrics = {"loss": loss, **mets}
        return optimizer.apply(state, grads), metrics

    return train_step
