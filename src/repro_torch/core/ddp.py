"""HaiScale DDP: a train step with explicit HFReduce gradient sync over a
``core.grid.Grid`` (port of ``repro/core/ddp.py``; paper §V-A).

Parameters are replicated, the global batch is split over the ranks in
pod-major order (``Grid.rows``), and gradients are synced by the
hierarchical schedule (``core/hfreduce.py``) bucket by bucket
(``core/bucketing.py``), optionally with a compressed cross-pod wire
format (``core/compression.py``).

Overlap, the paper's central claim.  With ``plan.overlap`` (the default)
the step runs ``loss.backward()`` on leaves that require grad, and a
``register_post_accumulate_grad_hook`` on every leaf counts its
bucket's leaves; the moment a bucket's last leaf is accumulated the
hook flattens the bucket's gradients (on the backward's stream) and
hands them to the rank's one communication thread (on the card: its own
CUDA stream, after an event recorded on the backward's), which runs
``sync_one`` on the buckets in the order they closed while the backward
goes on.  The step waits for every bucket before the
optimizer.  With ``overlap=False`` the same buckets are synced, in
plan order, after the backward.  Both paths flatten the same gradients
to the same wire dtype and call the same ``sync_one``, so their synced
gradients are bitwise equal.  A bucket whose leaves never receive a
gradient (unused parameters) is synced with zeros after the backward,
as the JAX custom_vjp gives them a zero cotangent.

``plan.zero1`` is ZeRO-1 on the explicit path: gradients are
reduce-scattered (strong, then weak; never gathered back), each rank
updates its flat fp32 master / moment shard with the optimizer's own
per-element rule (the clip norm summed over every rank), and the step
ends with a param all-gather in the working dtype (weak, then strong).

Every host-side bucket sync runs inside a ``ddp.sync`` telemetry span,
and the step's wait for the buckets after the backward inside
``ddp.wait``: with overlap on, ``ddp.wait`` is the sync time the
backward did not hide.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import math

import torch

from repro_torch.core import bucketing, compression
from repro_torch.core.grid import all_gather, all_reduce, reduce_scatter
from repro_torch.core.hfreduce import flat_allreduce, hfreduce
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models.params import tree_leaves, tree_map, \
    tree_unflatten
from repro_torch.optim.adamw import _chunks
from repro_torch.telemetry import span


def make_ddp_grad_sync(plan: bucketing.BucketPlan, grid, *,
                       compress: str = "", hierarchical=True,
                       bucketed=True, n_shards=1, quant_impl="auto"):
    """Returns grads -> synced grads (the mean over all ``n_shards``).

    The 1/n_shards mean is folded into the sync: the hierarchical
    schedule prescales the intra-pod shard before the (optionally
    compressed) cross-pod phase.  ``sync.sync_one`` is the per-bucket
    collective (flat tensor -> flat tensor) that the overlap hooks share,
    so both paths compute the same bits.  ``quant_impl`` picks the int8
    quantizer ("auto": the kernels on the card; "ref": the plain
    versions)."""
    if compress and not hierarchical:
        # never a silent no-op: the compressed wire format only exists on
        # the hierarchical schedule's cross-pod phase
        raise ValueError(
            f"compress={compress!r} needs the hierarchical schedule "
            "(grad_sync='hfreduce'); the flat all-reduce would silently "
            "ignore it")
    weak_psum = compression.make_weak_psum(compress, impl=quant_impl)
    inv = 1.0 / float(n_shards)

    def sync_one(g):
        with span("ddp.sync"):
            if hierarchical:
                return hfreduce(g, strong=grid.strong, weak=grid.weak,
                                weak_psum=weak_psum,
                                prescale=inv if n_shards > 1 else None)
            if n_shards > 1:
                g = g * torch.tensor(inv, dtype=g.dtype)
            return flat_allreduce(g, group=grid.world)

    def sync(grads):
        if bucketed:
            return bucketing.bucketed_apply(plan, grads, sync_one)
        return tree_map(sync_one, grads)

    sync.sync_one = sync_one
    return sync


def _pmean(values, grid):
    """Mean over every rank of a list of 0-dim tensors (one
    collective)."""
    v = torch.stack([x.detach().float().reshape(()) for x in values])
    return list(all_reduce(v, grid.world) / grid.size)


class DDPStep:
    """``step(state, batch) -> (state, metrics)`` for ``plan.mode ==
    "ddp"`` on this rank of ``grid``; ``batch`` is the global batch, of
    which the step takes its rows.  Built by ``make_ddp_train_step``."""

    def __init__(self, model, optimizer, grid, plan, device=None,
                 quant_impl="auto"):
        if plan.mode != "ddp":
            raise ValueError(f"plan.mode={plan.mode!r}; want 'ddp'")
        if plan.remat not in ("none", "full"):
            raise ValueError(f"remat={plan.remat!r}; want 'none' or 'full'")
        self.model, self.optimizer, self.grid, self.plan = \
            model, optimizer, grid, plan
        self.device = resolve_device(device)
        self.remat = plan.remat == "full"
        self.quant_impl = quant_impl
        self.bucket_plan = None
        self.sync = None
        self._pool = None
        self._stream = None

    # -- set-up from the first params seen -------------------------------

    def _prepare(self, params):
        if self.bucket_plan is not None:
            return
        plan = self.plan
        self.bucket_plan = bucketing.plan_buckets(
            params, plan.bucket_bytes or bucketing.DEFAULT_BUCKET_BYTES,
            wire_dtype=plan.wire_dtype)
        self.sync = make_ddp_grad_sync(
            self.bucket_plan, self.grid, compress=plan.compress,
            hierarchical=plan.grad_sync == "hfreduce",
            bucketed=plan.bucketed, n_shards=self.grid.size,
            quant_impl=self.quant_impl)
        if plan.bucketed:
            self.ranges = bucketing.bucket_leaf_ranges(self.bucket_plan)
        else:
            self.ranges = tuple((i, i + 1) for i in
                                range(len(self.bucket_plan.sizes)))
        if plan.overlap:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ddp-comm")
            if self.device.type == "cuda":
                self._stream = torch.cuda.Stream(self.device)

    def _local(self, batch):
        """This rank's rows of the global batch, on the device."""
        return {k: torch.as_tensor(v)[self.grid.rows(len(v))].to(
            self.device) for k, v in batch.items()}

    # -- one bucket ------------------------------------------------------

    def _flatten(self, leaves, b):
        """Bucket ``b``'s gradients as one flat wire tensor (zeros for a
        leaf without a gradient), on the current stream."""
        i0, i1 = self.ranges[b]
        grads = [l.grad if l.grad is not None else torch.zeros_like(l)
                 for l in leaves[i0:i1]]
        wire = self.bucket_plan.wire_dtype if self.plan.bucketed else None
        return bucketing.flatten_leaves(grads, wire)

    def _sync_flat(self, b, flat, event, out):
        """Sync bucket ``b``'s flat gradients into ``out`` (on the
        communication stream after ``event`` when there is one)."""
        i0, i1 = self.ranges[b]
        bp = self.bucket_plan
        ctx = torch.cuda.stream(self._stream) if event is not None \
            else contextlib.nullcontext()
        with ctx:
            if event is not None:
                self._stream.wait_event(event)
            flat = self.sync.sync_one(flat)
            out[i0:i1] = bucketing.unflatten_leaves(
                flat, bp.shapes[i0:i1], bp.dtypes[i0:i1], bp.sizes[i0:i1])

    # -- the replicated-optimizer path -----------------------------------

    def loss_and_grads(self, params, batch):
        """(loss, metrics, synced grads): loss and metrics meaned over
        every rank, grads in ``params``' tree and dtypes, already synced
        and meaned."""
        self._prepare(params)
        batch = self._local(batch)
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        out = [None] * len(leaves)
        n_b = len(self.ranges)
        futures, started, handles = [], [False] * n_b, []

        def start(b):
            # flattened where the gradients were made, on the backward's
            # stream; the communication thread takes it from there
            started[b] = True
            flat, event = self._flatten(leaves, b), None
            if self._stream is not None:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
                flat.record_stream(self._stream)
            futures.append(self._pool.submit(self._sync_flat, b, flat,
                                             event, out))

        if self.plan.overlap:
            counts = [0] * n_b
            for b, (i0, i1) in enumerate(self.ranges):
                def hook(_, b=b, need=i1 - i0):
                    counts[b] += 1
                    if counts[b] == need and not started[b]:
                        start(b)
                for i in range(i0, i1):
                    handles.append(
                        leaves[i].register_post_accumulate_grad_hook(hook))
        loss, metrics = self.model.loss(tree_unflatten(params, leaves),
                                        batch, remat=self.remat)
        try:
            loss.backward()
            with span("ddp.wait"):
                if self.plan.overlap:
                    for b in range(n_b):
                        if not started[b]:
                            start(b)
                    for f in futures:
                        f.result()
                    if self._stream is not None:
                        torch.cuda.current_stream(self.device).wait_stream(
                            self._stream)
                else:
                    for b in range(n_b):
                        self._sync_flat(b, self._flatten(leaves, b), None,
                                        out)
        finally:
            for h in handles:
                h.remove()
            for f in futures:
                f.cancel()
        keys = sorted(metrics)
        means = _pmean([loss] + [metrics[k] for k in keys], self.grid)
        return means[0], dict(zip(keys, means[1:])), \
            tree_unflatten(params, out)

    # -- ZeRO-1 ----------------------------------------------------------

    def _zero1_step(self, state, batch):
        params = state["params"]
        total, padded, offset = _zero1_layout(params, self.grid)
        batch = self._local(batch)
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss, metrics = self.model.loss(tree_unflatten(params, leaves),
                                        batch, remat=self.remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [g if g is not None else torch.zeros_like(l)
                 for g, l in zip(grads, leaves)]
        grid, opt = self.grid, self.optimizer
        with torch.no_grad(), span("ddp.sync"):
            # reduce-scatter, never gathered back; the mean is folded in
            # before the weak link
            flat = _pad(bucketing.flatten_leaves(grads, torch.float32),
                        padded)
            g = reduce_scatter(flat, grid.strong) * (1.0 / grid.size)
            if grid.pods > 1:
                g = reduce_scatter(g, grid.weak)
            step_no = state["step"] + 1
            gnorm = torch.sqrt(all_reduce(torch.sum(g * g), grid.world))
            g = g * torch.clamp(opt.clip_norm / torch.clamp(gnorm, min=1e-12),
                                max=1.0)
            upd = opt.update_fn(step_no)
            for gc, mc, vc, mac in zip(*map(_chunks, (
                    g, state["m"], state["v"], state["master"]))):
                upd(gc, mc, vc, mac)
            # all-gather the updated params in the working dtype
            pshard = state["master"].to(torch_dtype(opt.param_dtype))
            if grid.pods > 1:
                pshard = all_gather(pshard, grid.weak)
            pflat = all_gather(pshard, grid.strong)[:total]
            off = 0
            for p in tree_leaves(params):
                p.copy_(pflat[off:off + p.numel()].view(p.shape))
                off += p.numel()
        keys = sorted(metrics)
        means = _pmean([loss] + [metrics[k] for k in keys], grid)
        return {**state, "step": step_no}, \
            {"loss": means[0], **dict(zip(keys, means[1:]))}

    def __call__(self, state, batch):
        if self.plan.zero1:
            return self._zero1_step(state, batch)
        loss, metrics, grads = self.loss_and_grads(state["params"], batch)
        return self.optimizer.apply(state, grads), {"loss": loss, **metrics}


def make_ddp_train_step(model, optimizer, grid, plan, *, device=None,
                        quant_impl="auto") -> DDPStep:
    """The explicit-DDP train step of ``plan`` on this rank of ``grid``
    (every rank builds and calls it together).  ``optimizer``: the
    port's AdamW (``init`` / ``apply`` / ``update_fn``); with
    ``plan.zero1`` the state comes from ``init_zero1_state``.  The
    bucket plan is made from the params of the first call
    (``step.bucket_plan``)."""
    return DDPStep(model, optimizer, grid, plan, device, quant_impl)


# ---------------------------------------------------------------------------
# ZeRO-1 state: flat fp32 master / moment shards, strong-major offsets
# ---------------------------------------------------------------------------


def _pad(flat, padded):
    if padded > flat.shape[0]:
        flat = torch.cat([flat, flat.new_zeros(padded - flat.shape[0])])
    return flat


def _zero1_layout(params_template, grid):
    """(total, padded_total, offset) of this rank's flat shard.

    The flat vector is chunked strong-major: reduce-scatter over the
    strong group first (chunk j = data index), then over the weak group
    (sub-chunk i = pod), so rank (i, j) holds
    flat[j*S/strong + i*S/(strong*weak) : ...] — the layout of the JAX
    package's ``PartitionSpec((strong, weak))``."""
    total = sum(math.prod(l.shape) for l in tree_leaves(params_template))
    padded = total + ((-total) % grid.size)
    shard = padded // grid.size
    offset = grid.data_index * (padded // grid.data) + grid.pod * shard
    return total, padded, offset


def init_zero1_state(params, optimizer, grid):
    """ZeRO-1 state for this rank: ``params`` a replicated working copy
    in the optimizer's param dtype; ``master`` / ``m`` / ``v`` this
    rank's flat fp32 / moment shard."""
    total, padded, offset = _zero1_layout(params, grid)
    shard = padded // grid.size
    flat = _pad(bucketing.flatten_tree(params, torch.float32), padded)
    master = flat[offset:offset + shard].clone()
    del flat
    pdt = torch_dtype(optimizer.param_dtype)
    mdt = torch_dtype(optimizer.moments_dtype)
    return {
        "params": tree_map(lambda x: x.detach().to(pdt).contiguous(),
                           params),
        "master": master,
        "m": torch.zeros(shard, dtype=mdt, device=master.device),
        "v": torch.zeros(shard, dtype=mdt, device=master.device),
        "step": torch.zeros((), dtype=torch.int32, device=master.device),
    }
