"""Speculative decoding (port of ``repro/serving/speculative.py``):
drafters and the acceptance rule.

A drafter proposes up to ``k`` continuation tokens per slot; one chunk
``forward(params, state, tokens, positions, all_logits=True)`` verifies
them through the paged chunk-attention op a decode tick uses (a
(b, k + 1) chunk with per-slot positions), and the engine keeps the
longest accepted prefix plus one bonus token: 1 .. k + 1 tokens per
sweep of the cache.

Drafters share one protocol::

    propose(rid, history, k) -> list[int]   # <= k proposed tokens
    release(rid)                            # forget per-request state

and are deterministic functions of ``history`` (prompt + emitted), so
eviction replay reproduces the accepted stream and greedy speculation
emits what plain decode emits.

* ``NGramDrafter``: prompt-lookup decoding over the request's history.
* ``DraftModelDrafter``: a same-vocabulary draft model with its own
  dense SeqState per request, greedy.

``spec_accept`` is the rejection rule with a point-mass proposal:
greedy slots accept drafts equal to the verify argmax; sampled slots
accept draft ``d`` with probability ``p(d)`` and on rejection resample
from ``p`` with ``d`` zeroed.  Each (slot, row) draws from three
``torch.Generator`` streams seeded by the engine's ``sample_seed(seed,
rid, position)`` (the accept draw, the rejection resample, the bonus),
so sampled speculation replays bit for bit inside the port; its draws
are not JAX's ``fold_in`` draws.
"""
from __future__ import annotations

import numpy as np
import torch

SPEC_MODES = ("off", "ngram", "draft-model")
_MASK64 = (1 << 64) - 1


def _pow2_at_least(n: int, floor: int = 1) -> int:
    w = max(floor, 1)
    while w < n:
        w *= 2
    return w


# ------------------------------- drafters ----------------------------------


class NGramDrafter:
    """Prompt-lookup drafting: the most recent earlier occurrence of the
    longest suffix n-gram (``max_n`` down to ``min_n``) proposes the up
    to ``k`` tokens that followed it.  Stateless and deterministic."""

    def __init__(self, max_n: int = 3, min_n: int = 1):
        if not 1 <= min_n <= max_n:
            raise ValueError(f"need 1 <= min_n <= max_n, got {min_n}, "
                             f"{max_n}")
        self.max_n = max_n
        self.min_n = min_n

    def propose(self, rid: int, history, k: int) -> list:
        h = np.asarray(history, np.int64)
        L = len(h)
        for n in range(self.max_n, self.min_n - 1, -1):
            if L <= n:
                continue
            pat = h[L - n:]
            # candidate starts j with a continuation (j + n < L) that is
            # not the suffix itself
            win = np.lib.stride_tricks.sliding_window_view(h[:L - 1], n)
            hits = np.flatnonzero(np.all(win == pat, axis=1))
            if hits.size == 0:
                continue
            j = int(hits[-1])                       # most recent match
            cont = h[j + n: j + n + k]
            if cont.size:
                return [int(t) for t in cont]
        return []

    def release(self, rid: int) -> None:
        pass


class DraftModelDrafter:
    """A second (params, SeqState) pair drafting greedily.

    The draft model shares the target's vocabulary and carries only
    attention KV (families ``dense`` / ``moe``): positional overwrite
    rolls it back for free (the next ``propose`` feeds the true accepted
    tokens at the positions the rejected drafts took, and masking hides
    anything beyond).  Recurrent draft families are refused.  Each
    request holds a dense SeqState of ``max_len`` positions; a history
    past ``max_len - k`` gets no proposal (a plain decode tick)."""

    def __init__(self, model, params, *, max_len: int = 512):
        if model.cfg.family not in ("dense", "moe"):
            raise ValueError(
                f"draft model must be a dense-attention family "
                f"(dense/moe), got {model.cfg.family!r}: recurrent "
                f"draft state cannot roll back by positional overwrite")
        self.model = model
        self.params = params
        self.max_len = max_len
        self._seqs: dict[int, tuple] = {}     # rid -> (SeqState, cached)

    def propose(self, rid: int, history, k: int) -> list:
        hist = np.asarray(history, np.int32)
        L = len(hist)
        if L + k > self.max_len:
            return []                 # out of draft capacity: degrade
        dev = self.params["embed"].device
        ent = self._seqs.get(rid)
        if ent is None or ent[1] > L:           # fresh, or stale (replay)
            state = self.model.init_seq_state(
                self.params, self.max_len, batch_size=1,
                dtype=self.model.cfg.compute_dtype, device=dev)
            cached = 0
        else:
            state, cached = ent
        # catch up on the tokens accepted since the last round as one
        # chunk padded to a power of two (positions -1: writes dropped)
        feed = hist[cached:]
        width = _pow2_at_least(len(feed))
        toks = np.zeros((1, width), np.int32)
        toks[0, :len(feed)] = feed
        pos = np.full((1, width), -1, np.int32)
        pos[0, :len(feed)] = np.arange(cached, L, dtype=np.int32)
        state, logits = self.model.forward(
            self.params, state, torch.from_numpy(toks).to(dev),
            torch.from_numpy(pos).to(dev))
        drafts = [int(torch.argmax(logits[0]))]
        for i in range(k - 1):
            state, logits = self.model.forward(
                self.params, state,
                torch.tensor([[drafts[-1]]], dtype=torch.int32, device=dev),
                torch.tensor([[L + i]], dtype=torch.int32, device=dev))
            drafts.append(int(torch.argmax(logits[0])))
        # the cache covers the true history only; draft writes past L are
        # overwritten by the next catch-up chunk
        self._seqs[rid] = (state, L)
        return drafts

    def release(self, rid: int) -> None:
        self._seqs.pop(rid, None)


def make_drafter(mode: str, *, ngram_max: int = 3, ngram_min: int = 1,
                 draft_model=None, draft_params=None,
                 draft_max_len: int = 512, target_vocab: int | None = None):
    """Drafter factory for ``ServingEngine(spec_mode=...)``."""
    if mode not in SPEC_MODES:
        raise ValueError(f"spec_mode must be one of {SPEC_MODES}, "
                         f"got {mode!r}")
    if mode == "off":
        return None
    if mode == "ngram":
        return NGramDrafter(max_n=ngram_max, min_n=ngram_min)
    if draft_model is None or draft_params is None:
        raise ValueError("spec_mode='draft-model' needs draft_model "
                         "and draft_params")
    if (target_vocab is not None
            and draft_model.cfg.vocab_size != target_vocab):
        raise ValueError(
            f"draft model vocab {draft_model.cfg.vocab_size} != target "
            f"vocab {target_vocab}: speculation requires a shared "
            f"tokenizer")
    return DraftModelDrafter(draft_model, draft_params,
                             max_len=draft_max_len)


# ----------------------------- acceptance ----------------------------------


def stream_seed(base: int, stream: int) -> int:
    """Seed of draw stream ``stream`` (0 accept, 1 rejection resample,
    2 bonus) under a token's ``sample_seed`` (splitmix64)."""
    x = (base + (stream + 1) * 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) & ((1 << 63) - 1)


def _gen(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def spec_accept(logits, draft_next, seeds, positions, temps, topks):
    """Per-row acceptance inputs of one verify chunk.

    logits (b, T, V): the ``all_logits`` verify output, row t predicting
    the token after ``positions[:, t]``; draft_next (b, T): the draft
    each row is checked against (row t holds d_{t+1}); seeds: per slot
    a callable ``position -> sample_seed`` (None for greedy slots);
    positions (b, T) the chunk's write positions (negative = padding);
    temps / topks (b,) sampling parameters.

    Returns numpy (greedy_next, accept, rej_tok, plain_tok), all (b, T):
    the verify argmax; for sampled slots the accept flags ``u < p(draft)``,
    the rejection resample from ``p`` with the draft zeroed (drawn only
    where the draft is refused, -1 elsewhere) and the plain draw (the
    bonus after full acceptance).  A row's draws depend only on its
    slot's seed and position (the token lands at ``position + 1``)."""
    b, T, V = logits.shape
    greedy_next = torch.argmax(logits, dim=-1).cpu().numpy().astype(np.int32)
    accept = np.zeros((b, T), bool)
    rej = np.full((b, T), -1, np.int32)
    plain = np.full((b, T), -1, np.int32)
    pos = np.asarray(positions)
    for s in range(b):
        if seeds[s] is None:
            continue
        lf = logits[s].float()
        if int(topks[s]) > 0:
            kk = min(int(topks[s]), V)
            thr = torch.topk(lf, kk, dim=-1).values[:, -1:]
            lf = torch.where(lf < thr, torch.full_like(lf, -float("inf")),
                             lf)
        probs = torch.softmax(lf / max(float(temps[s]), 1e-6), dim=-1)
        for t in range(T):
            if pos[s, t] < 0:
                continue
            base = seeds[s](int(pos[s, t]) + 1)
            d = int(draft_next[s, t])
            u = torch.rand((), generator=_gen(probs.device,
                                               stream_seed(base, 0)),
                           device=probs.device)
            accept[s, t] = bool(u < probs[t, d])
            if not accept[s, t]:
                left = probs[t].clone()
                left[d] = 0.0
                rej[s, t] = int(torch.multinomial(
                    left, 1, generator=_gen(probs.device,
                                            stream_seed(base, 1))))
            plain[s, t] = int(torch.multinomial(
                probs[t], 1, generator=_gen(probs.device,
                                            stream_seed(base, 2))))
    return greedy_next, accept, rej, plain


def longest_accept(greedy: bool, drafts, greedy_next, accept, rej, plain):
    """One slot's emission: the longest accepted draft prefix plus the
    bonus token (1 .. k + 1 tokens).  Greedy slots accept by exact
    argmax match; sampled slots by the flags and tokens of
    ``spec_accept``."""
    n = len(drafts)
    m = 0
    if greedy:
        while m < n and int(greedy_next[m]) == int(drafts[m]):
            m += 1
        bonus = int(greedy_next[m])
    else:
        while m < n and bool(accept[m]):
            m += 1
        bonus = int(plain[m]) if m == n else int(rej[m])
    return list(drafts[:m]) + [bonus]
