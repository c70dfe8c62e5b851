"""Pipeline parallelism (HaiScale PP, paper §V-B2) over the pipe axis of
a ``core.grid.Grid`` (port of ``repro/parallel/pp.py``).

Two layers of machinery live here, as in the JAX package:

* ``pipeline_apply`` / ``make_pipelined_forward`` — the differentiable
  GPipe forward: microbatches flow stage to stage through ``_PPermute``,
  an ``autograd.Function`` around ``grid.ppermute`` whose backward sends
  the cotangents back along the reversed pairs (what JAX gets by
  transposing ``ppermute``).  Used by the numerics checks.
* ``make_pp_train_step`` — the executor of ``ParallelPlan(mode="pp")``:
  a manual forward / backward schedule (GPipe or 1F1B) over
  ``grid.pipe``, the stage gradients summed over the pipe into the
  replicated tree, synced with HFReduce over the stage's batch ranks,
  and fed to the replicated optimizer, so the state is exactly
  ``optimizer.init(params)`` and the trajectory is the one-device
  step's up to float reassociation.  1F1B runs one microbatch forward
  and one backward per tick after a (P-1)-tick warm-up, so a stage
  keeps at most ``2P-1`` activations live instead of GPipe's ``m``
  (``peak_live_activations``).

Each rank is one stage of one (pod, data) position; the ranks of a stage
take the same rows of the global batch as JAX device r does
(``Grid.rows``).  Point-to-point transfers go through ``grid.sendrecv``
(gloo; staged through pinned host memory on the card), one batch a
tick, carrying only what an active microbatch sends: the receiver works
out from the schedule what arrives, where the JAX program sends zeros.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.grid import all_gather, all_reduce, ppermute, sendrecv
from repro_torch.device import resolve_device
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.telemetry import span


def split_stages(stacked_params, n_stages: int):
    """(L, ...) stacked layer params -> (P, L/P, ...)."""
    def re(x):
        L = x.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers do not split into {n_stages} "
                             "stages")
        return x.reshape(n_stages, L // n_stages, *x.shape[1:])
    return tree_map(re, stacked_params)


def _permute(x, group, pairs):
    got = ppermute(x, group, pairs)
    return torch.zeros_like(x) if got is None else got


class _PPermute(torch.autograd.Function):
    """``ppermute`` with zeros where nothing arrives; its backward is the
    reverse permutation of the cotangents."""

    @staticmethod
    def forward(ctx, x, group, pairs):
        ctx.group, ctx.pairs = group, pairs
        return _permute(x, group, pairs)

    @staticmethod
    def backward(ctx, g):
        back = [(d, s) for s, d in ctx.pairs]
        return _permute(g, ctx.group, back), None, None


class _FromLast(torch.autograd.Function):
    """The last group rank's ``x`` on every rank (JAX: the masked
    psum).  Every rank computes the same loss of the result, as of
    JAX's replicated output, so the backward keeps the last rank's own
    cotangent and gives the others zeros."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.last = dist.get_rank(group) == dist.get_world_size(group) - 1
        return all_reduce(x if ctx.last else torch.zeros_like(x), group)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None


def pipeline_apply(stage_fn, stage_params, x_micro, *, group):
    """Run the GPipe schedule over ``group`` (``grid.pipe``).

    stage_fn(stage_params, x) -> x      (applies this stage's layers)
    stage_params: this rank's (L/P, ...) stage slice
    x_micro: (n_micro, mb, ...) microbatched input (stage 0 consumes it)

    Returns (n_micro, mb, ...) outputs, the same on every rank
    (broadcast from the last stage).  As in JAX every rank runs every
    tick and masks the inactive ones, so each rank's backward meets
    every ``_PPermute`` of the forward, in reverse tick order: each
    transfer's backward is a collective its neighbours join.
    """
    P = dist.get_world_size(group)
    rank = dist.get_rank(group)
    n_micro = x_micro.shape[0]
    dev = x_micro.device
    perm = [(i, i + 1) for i in range(P - 1)]
    n_ticks = n_micro + P - 1
    first = torch.tensor(rank == 0, device=dev)
    recv = torch.zeros_like(x_micro[0])
    outs = []
    for t in range(n_ticks):
        mb = t - rank
        inp = torch.where(first, x_micro[min(max(mb, 0), n_micro - 1)],
                          recv)
        out = stage_fn(stage_params, inp)
        out = torch.where(torch.tensor(0 <= mb < n_micro, device=dev), out,
                          torch.zeros_like(out))
        outs.append(out)
        if perm and t < n_ticks - 1:
            recv = _PPermute.apply(out, group, perm)
    # microbatch i leaves the last stage at tick i + P - 1
    return _FromLast.apply(torch.stack(outs[P - 1:]), group)


def make_pipelined_forward(layer_fn, n_stages: int, n_micro: int, grid):
    """Build f(stacked_params, x) -> y running layers as a P-stage
    pipeline over ``grid.pipe`` (this rank runs stage ``grid.stage``).

    layer_fn(layer_params, x) -> x;  stacked_params: (L, ...) trees;
    x: (batch, ...) with batch % n_micro == 0.
    """
    if grid.stages != n_stages:
        raise ValueError(f"the grid has {grid.stages} stages, not "
                         f"{n_stages}")

    def stage_fn(sp, x):
        for i in range(tree_leaves(sp)[0].shape[0]):
            x = layer_fn(tree_map(lambda a: a[i], sp), x)
        return x

    def f(stacked_params, x):
        b = x.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} not divisible by {n_micro} "
                             "microbatches")
        xm = x.reshape(n_micro, b // n_micro, *x.shape[1:])
        sp = tree_map(lambda a: a[grid.stage],
                      split_stages(stacked_params, n_stages))
        ym = pipeline_apply(stage_fn, sp, xm, group=grid.pipe)
        return ym.reshape(b, *x.shape[1:])

    return f


def bubble_fraction(n_stages: int, n_micro: int,
                    schedule: str = "gpipe") -> float:
    """Pipeline bubble: (P-1)/(m+P-1) — the Fig. 9 scaling term.

    GPipe and 1F1B share the same bubble fraction; 1F1B's win is
    activation memory (``peak_live_activations``), not bubble.
    """
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(schedule)
    return (n_stages - 1) / (n_micro + n_stages - 1)


def peak_live_activations(n_stages: int, n_micro: int,
                          schedule: str = "gpipe") -> int:
    """Max stage inputs held for the backward, per stage.

    GPipe holds every microbatch until the forward drains (m); the 1F1B
    interleave retires microbatch i's activation before microbatch
    i + 2P - 1 is stored, bounding liveness by the stage count alone.
    """
    if schedule == "gpipe":
        return n_micro
    if schedule == "1f1b":
        return min(n_micro, 2 * n_stages - 1)
    raise ValueError(schedule)


# ---------------------------------------------------------------------------
# First-class pipelined training (ParallelPlan mode="pp")
# ---------------------------------------------------------------------------


def _check_pp_model(model):
    from repro_torch.models.model_api import DecoderLM
    if not isinstance(model, DecoderLM) or model.is_moe or model.is_vlm:
        raise ValueError(
            "mode='pp' currently pipelines dense decoder-only LMs "
            "(params['layers'] stacked, embed/head on the edge stages); "
            f"got {type(model).__name__}")


def _add(acc: dict, delta: dict) -> dict:
    """``acc + delta`` leaf by leaf in ``acc``'s dtypes (a leaf missing
    from ``acc`` starts at ``delta``: 0 + d is d exactly)."""
    out = dict(acc)
    for k, d in delta.items():
        if d is not None:
            out[k] = d if k not in out else out[k] + d.to(out[k].dtype)
    return out


class PPStep:
    """``step(state, batch) -> (state, metrics)`` for ``plan.mode ==
    "pp"`` on this rank of ``grid``; ``batch`` is the global batch, of
    which the step takes its stage rank's rows.  Built by
    ``make_pp_train_step``.

    The schedule (JAX's): stage r runs the forward of microbatch f at
    tick f + r and the backward of microbatch b at tick b + off - r,
    with off = 2P - 1 for 1F1B (the last stage's backward trails its
    forward by one tick) and m + 2P - 2 for GPipe (after the forward
    drains).  A ring of ``peak_live_activations`` slots holds the stage
    inputs; the backward reads its slot before the forward of the same
    tick stores into it (at the liveness bound they share the slot).
    The forward runs without autograd; the backward recomputes the
    stage from its saved input (the remat of the one-device step) and
    backpropagates the cotangent that arrived.  The embedding runs on
    stage 0, the head (final norm, logits, CE) on stage P - 1.
    """

    def __init__(self, model, optimizer, grid, plan, device=None):
        if plan.mode != "pp":
            raise ValueError(f"plan.mode={plan.mode!r}; want 'pp'")
        _check_pp_model(model)
        if grid is None:
            raise ValueError("mode='pp' runs over the pipe axis of a "
                             "core.grid.Grid; pass grid=")
        P = grid.stages
        if model.cfg.n_layers % P:
            raise ValueError(f"n_layers={model.cfg.n_layers} not divisible "
                             f"by {P} pipeline stages")
        self.model, self.optimizer, self.grid, self.plan = \
            model, optimizer, grid, plan
        self.device = resolve_device(device)
        self.lps = model.cfg.n_layers // P
        self.m = m = plan.pp_microbatches
        self.off = 2 * P - 1 if plan.pp_schedule == "1f1b" else m + 2 * P - 2
        self.n_ticks = m + self.off
        self.n_slots = peak_live_activations(P, m, plan.pp_schedule)
        self.first, self.last = grid.stage == 0, grid.stage == P - 1
        self.sync = None
        self._prepared = False

    def _prepare(self, params):
        """HFReduce over the stage's batch ranks, on the bucket plan of
        the whole tree (JAX: ``make_ddp_grad_sync``).  A stage of one
        rank without compression would sync with itself, an identity:
        it is skipped."""
        if self._prepared:
            return
        self._prepared = True
        plan = self.plan
        if self.grid.size == 1 and not plan.compress:
            return
        from repro_torch.core import bucketing
        from repro_torch.core.ddp import make_ddp_grad_sync
        bucket_plan = bucketing.plan_buckets(
            params, plan.bucket_bytes or bucketing.DEFAULT_BUCKET_BYTES,
            wire_dtype=plan.wire_dtype)
        self.sync = make_ddp_grad_sync(
            bucket_plan, self.grid, compress=plan.compress,
            hierarchical=plan.grad_sync == "hfreduce",
            bucketed=plan.bucketed, n_shards=self.grid.size)

    # -- the pieces of a tick ---------------------------------------------

    def _stage_params(self, layers):
        """This stage's slice of the stacked layers (views)."""
        s = self.grid.stage * self.lps
        return {k: v[s:s + self.lps] for k, v in layers.items()}

    def _stage_fwd(self, sp, x):
        from repro_torch.models.transformer import dense_layer, scan_layers
        cfg = self.model.cfg

        def fn(h, aux, lp):
            return dense_layer(cfg, lp, h, causal=True), aux
        return scan_layers(fn, x, None, sp, remat=False)[0]

    def _saved(self, ring, t):
        """The stage input of the microbatch whose backward runs at tick
        ``t`` (None when none does)."""
        b = t + self.grid.stage - self.off
        return ring[b % self.n_slots] if 0 <= b < self.m else None

    def _forward(self, t, ring, nonlayer, sp, tokens, recv_f):
        """The forward of tick ``t`` (no autograd): stores the stage
        input in the ring; returns what goes to the next stage."""
        f = t - self.grid.stage
        if not 0 <= f < self.m:
            return None
        with torch.no_grad():
            x = self.model._embed(nonlayer, tokens[f]) if self.first \
                else recv_f
            y = self._stage_fwd(sp, x)
        ring[f % self.n_slots] = x
        return None if self.last else y

    def _backward(self, t, x_saved, nonlayer, sp, tokens, labels, recv_b):
        """The backward of tick ``t``: (layer grads, the non-layer grads
        as a list in JAX's order of accumulation (the head's, then the
        embedding's), loss, cotangent for the previous stage), or None
        when no microbatch's backward runs here at ``t``."""
        b = t + self.grid.stage - self.off
        if not 0 <= b < self.m:
            return None
        spl = {k: v.detach().requires_grad_() for k, v in sp.items()}
        x = x_saved.detach().requires_grad_()
        y = self._stage_fwd(spl, x)
        names = sorted(spl)
        inputs = [spl[k] for k in names] + [x]
        loss, dnl = None, []
        if self.last:
            nl = {k: v.detach().requires_grad_() for k, v in
                  nonlayer.items()}
            loss = self.model._ce(nl, y, labels[b])
            keys = sorted(nl)
            g = torch.autograd.grad(loss, inputs + [nl[k] for k in keys],
                                    allow_unused=True)
            dnl.append(dict(zip(keys, g[len(inputs):])))
        else:
            g = torch.autograd.grad(y, inputs, recv_b)
        dsp = dict(zip(names, g[:len(names)]))
        dx = g[len(names)]
        if self.first:
            emb = {"embed": nonlayer["embed"].detach().requires_grad_()}
            (d_emb,) = torch.autograd.grad(
                self.model._embed(emb, tokens[b]), emb["embed"], dx)
            dnl.append({"embed": d_emb})
            dx = None
        return dsp, dnl, loss, dx

    def _exchange(self, t, send_f, send_b, like):
        """Tick ``t``'s transfers: the forward output to the next stage,
        the cotangent to the previous one; returns (recv_f, recv_b),
        what the previous stage's forward and the next stage's backward
        sent at ``t`` (None where that op did not run)."""
        s, m = self.grid.stage, self.m
        sends = [(x, d) for x, d in ((send_f, s + 1), (send_b, s - 1))
                 if x is not None]
        want_f = not self.first and 0 <= t - (s - 1) < m
        want_b = not self.last and 0 <= t + (s + 1) - self.off < m
        recvs = [(like, s - 1)] * want_f + [(like, s + 1)] * want_b
        with span("pp.send"):
            got = iter(sendrecv(self.grid.pipe, sends, recvs))
        return (next(got) if want_f else None,
                next(got) if want_b else None)

    def _pipe_sum(self, params, dsp, dnl):
        """The full gradient tree, summed over the stages, in one
        all-gather: the stage slices of the layer leaves placed in stage
        order (every other stage's part of a slice is zero, so this is
        the sum bit for bit), the non-layer leaves summed over the
        stages on the device (stage 0 holds the embedding's gradient,
        stage P - 1 the head's; a tied embedding gets both)."""
        P = self.grid.stages
        nl = {k: dnl[k] if dnl.get(k) is not None
              else torch.zeros_like(params[k])
              for k in sorted(params) if k != "layers"}
        if P == 1:
            return {"layers": dsp, **nl}
        names = sorted(dsp)
        shapes = [dsp[k].shape for k in names]
        n_layers = sum(shape.numel() for shape in shapes)
        nl_shapes = {k: g.shape for k, g in nl.items()}
        flat = torch.cat([dsp[k].reshape(-1) for k in names] +
                         [g.reshape(-1) for g in nl.values()])
        dsp.clear()
        del nl
        parts = all_gather(flat, self.grid.pipe).view(P, -1)
        del flat
        out, off = {"layers": {}}, 0
        for k, shape in zip(names, shapes):
            n = shape.numel()
            out["layers"][k] = parts[:, off:off + n].reshape(P * shape[0],
                                                             *shape[1:])
            off += n
        summed = parts[:, n_layers:].sum(0)
        del parts
        off = 0
        for k, shape in nl_shapes.items():
            out[k] = summed[off:off + shape.numel()].view(shape)
            off += shape.numel()
        return out

    # -- the step ---------------------------------------------------------

    def loss_and_grads(self, params, batch):
        """(loss, grads): the loss meaned over the microbatches and the
        batch ranks, the gradient tree summed over the pipe, divided by
        m and synced over the stage's ranks."""
        self._prepare(params)
        grid, m = self.grid, self.m
        dev = self.device
        local = {k: torch.as_tensor(v)[grid.rows(len(v))].to(dev)
                 for k, v in batch.items()}
        tokens, labels = local["tokens"], local["labels"]
        b = tokens.shape[0]
        if b % m:
            raise ValueError(f"local batch {b} not divisible by "
                             f"pp_microbatches={m}")
        tokens = tokens.reshape(m, b // m, *tokens.shape[1:])
        labels = labels.reshape(m, b // m, *labels.shape[1:])
        nonlayer = {k: v for k, v in params.items() if k != "layers"}
        sp = self._stage_params(params["layers"])
        like = torch.empty((b // m, tokens.shape[2], self.model.cfg.d_model),
                           dtype=self.model.compute_dtype, device=dev)
        ring = [None] * self.n_slots
        recv_f = recv_b = None
        dsp, dnl = {}, {}
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for t in range(self.n_ticks):
            # the backward reads its slot before the forward stores into it
            x_saved = self._saved(ring, t)
            send_f = self._forward(t, ring, nonlayer, sp, tokens, recv_f)
            bwd = self._backward(t, x_saved, nonlayer, sp, tokens, labels,
                                 recv_b)
            send_b = None
            if bwd is not None:
                d_sp, d_nls, loss_mb, send_b = bwd
                dsp = _add(dsp, d_sp)
                for d_nl in d_nls:
                    dnl = _add(dnl, d_nl)
                if loss_mb is not None:
                    loss_sum = loss_sum + loss_mb.detach().float()
            del x_saved, bwd
            if grid.stages > 1:
                recv_f, recv_b = self._exchange(t, send_f, send_b, like)
        with span("pp.grad_sum"):
            grads = self._pipe_sum(params, dsp, dnl)
            del dsp, dnl
            for g in tree_leaves(grads):      # fresh tensors: in place
                g.div_(m)
            loss = (all_reduce(loss_sum, grid.pipe) if grid.stages > 1
                    else loss_sum) / m
        if self.sync is not None:
            grads = self.sync(grads)
        if grid.size > 1:
            loss = all_reduce(loss, grid.world) / grid.size
        return loss, grads

    def __call__(self, state, batch):
        loss, grads = self.loss_and_grads(state["params"], batch)
        return self.optimizer.apply(state, grads), {"loss": loss}


def make_pp_train_step(model, optimizer, grid, plan, *,
                       device=None) -> PPStep:
    """The pipelined train step of ``plan`` on this rank of ``grid``
    (every rank builds and calls it together).  ``optimizer``: the
    port's AdamW (``apply``); the state is ``optimizer.init(params)``,
    the whole tree on every rank."""
    return PPStep(model, optimizer, grid, plan, device)
