"""Serving entry point of the port: dense lockstep decode or the paged
continuous-batching engine (``--decode-impl paged``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \\
      --decode-impl paged --batch 8 --prompt-len 512 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch codeqwen1.5-7b \\
      --smoke --device cpu --decode-impl paged --stagger 2 --prefill-chunk 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \\
      --decode-impl paged --spec-mode ngram --draft-k 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \\
      --decode-impl paged --replicas 2 --prefill-replicas 2 \\
      --slo-ttft-ms 500 --slo-tpot-ms 100

Every family serves on the dense path: the VLM (``internvl2-76b``) with
its stub frontend's patch embeddings and Whisper (``whisper-base``) with
its frame embeddings, both drawn by ``data.synthetic.batch_for_model``,
and xLSTM (``xlstm-125m``); the paged engine takes the dense, MoE and
hybrid families, as the JAX engine does.

Runs on the card by default (``--device cuda``) and stops with an error
when there is none; ``--device cpu`` runs the plain PyTorch path.  At
full width the weights are drawn once in the compute dtype (``--dtype``,
default the config's bfloat16); ``--smoke`` runs the reduced config in
float32.  Weights are random, drawn from ``--seed``.  ``--spec-mode``
speculates on the paged path (n-gram prompt lookup, or a draft model:
the target arch at half its layers with its own random weights);
``--replicas N`` serves through a ``ServingCluster`` of
``--prefill-replicas`` prefill and N decode engines (speculation rides
the decode leg).  ``--trace PATH`` writes the run's spans
(``engine.prefill_chunk``, ``engine.decode_tick``, ``engine.spec_tick``,
``router.route_*`` or ``serve.dense_*``) as Chrome-trace JSON at exit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from repro_torch.telemetry import now, span


def build(arch: str, *, smoke=False, dtype=None, device=None, seed=0):
    """(cfg, model, params): the arch's config (reduced with ``smoke``),
    its model and random weights drawn on ``device`` in the compute
    dtype."""
    from repro_torch.configs.registry import get_arch, smoke_config
    from repro_torch.models import build_model

    cfg = smoke_config(arch) if smoke else get_arch(arch)
    if smoke:
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
    if dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    model = build_model(cfg)
    params = model.init(seed, device=device, dtype=cfg.compute_dtype)
    return cfg, model, params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    ap.add_argument("--dtype", default=None,
                    help="compute dtype (default: the config's)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--decode-impl", choices=("dense", "paged"),
                    default=None, help="override cfg.decode_impl")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--n-blocks", type=int, default=0,
                    help="paged: pool size in blocks (0 = sized to fit)")
    ap.add_argument("--stagger", type=int, default=0,
                    help="paged: admit request i at engine step i*stagger")
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--kv-dtype", default=None,
                    choices=("bfloat16", "float8_e4m3", "int8"))
    ap.add_argument("--spec-mode", default="off",
                    choices=("off", "ngram", "draft-model"),
                    help="paged: speculative decoding (greedy streams stay "
                         "those of --spec-mode off)")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="spec: drafts proposed and verified per slot a "
                         "step")
    ap.add_argument("--replicas", type=int, default=0,
                    help="paged: decode replicas of a disaggregated "
                         "ServingCluster (0 = one engine)")
    ap.add_argument("--prefill-replicas", type=int, default=1,
                    help="cluster: prefill replicas (with --replicas > 0)")
    ap.add_argument("--slo-ttft-ms", type=float, default=1000.0,
                    help="cluster: the router's TTFT target (ms)")
    ap.add_argument("--slo-tpot-ms", type=float, default=200.0,
                    help="cluster: the router's TPOT target (ms)")
    ap.add_argument("--metrics", action="store_true")
    ap.add_argument("--trace", default="",
                    help="write a Chrome-trace JSON (chrome://tracing / "
                         "Perfetto) of the run's spans to this path")
    args = ap.parse_args(argv)

    from repro_torch.data.synthetic import batch_for_model
    from repro_torch.device import resolve_device

    device = resolve_device(args.device)
    cfg, model, params = build(args.arch, smoke=args.smoke, dtype=args.dtype,
                               device=device, seed=args.seed)
    impl = args.decode_impl or cfg.decode_impl
    batch = batch_for_model(cfg, "prefill", 0, args.batch, args.prompt_len,
                            args.seed)
    tokens = batch["tokens"]
    writer = None
    if args.trace:
        from repro_torch.telemetry import TraceWriter, install_writer
        writer = TraceWriter()
        install_writer(writer)
    try:
        if impl == "paged" and args.replicas > 0:
            return _serve_cluster(model, params, tokens, args, device)
        if impl == "paged":
            return _serve_paged(model, params, tokens, args, device)
        return _serve_dense(model, params, batch, args, device)
    finally:
        if writer is not None:
            from repro_torch.telemetry import uninstall_writer
            uninstall_writer()
            writer.write(args.trace)
            print(f"trace written to {args.trace}")


def _print_stats(stats, request_metrics=None):
    from repro_torch.serving.stats import check_schema
    check_schema(stats)
    print("serving stats:")
    print(json.dumps(stats, indent=2, default=str, sort_keys=True))
    if request_metrics is not None:
        print("request metrics:")
        print(json.dumps(request_metrics, indent=2, default=str))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _serve_dense(model, params, batch, args, device):
    """Lockstep decode through the chunk API: the prompt (``batch``: the
    model-format prefill inputs, a VLM's patches or Whisper's frames
    included) is one fresh chunk, every decode step a T = 1 chunk; the
    SeqState holds prompt + gen up front."""
    batch = {k: torch.as_tensor(np.asarray(v), device=device)
             for k, v in batch.items()}
    tok, positions, embeds = model.prompt_inputs(params, batch)
    b, s = positions.shape
    t0 = now()
    with span("serve.dense_prefill", batch=b, prompt_len=s):
        state = model.init_seq_state(params, s + args.gen, batch=batch,
                                     batch_size=b,
                                     dtype=model.cfg.compute_dtype,
                                     device=device)
        state, logits = model.forward(params, state, tok, positions,
                                      embeds=embeds, fresh=True)
        _sync(device)
    t_prefill = now() - t0
    toks = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [toks.cpu().numpy()]
    t0 = now()
    for i in range(args.gen - 1):
        pos = torch.full((b, 1), s + i, dtype=torch.int32, device=device)
        with span("serve.dense_decode", step=i):
            state, logits = model.forward(params, state, toks[:, None], pos)
            toks = torch.argmax(logits, dim=-1).to(torch.int32)
            out.append(toks.cpu().numpy())
    t_decode = now() - t0
    if args.metrics:
        from repro_torch.serving.stats import serving_stats
        from repro_torch.telemetry import Histogram
        h_ttft, h_tpot = Histogram("serve.ttft_s"), Histogram("serve.tpot_s")
        per_step = t_decode / max(args.gen - 1, 1)
        for _ in range(b):
            h_ttft.record(t_prefill)
            for _ in range(max(args.gen - 1, 1)):
                h_tpot.record(per_step)
        _print_stats(serving_stats(requests_completed=b, queue_depth=0,
                                   evictions=0, ttft=h_ttft, tpot=h_tpot,
                                   backend="dense"))
    gen = np.stack(out, axis=1)
    print(f"prefill {s} toks x{b}: {t_prefill:.3f}s")
    print(f"decode  {args.gen} steps: {t_decode:.3f}s "
          f"({t_decode / max(args.gen - 1, 1) * 1e3:.1f} ms/step)")
    return gen


def serve_paged(model, params, prompts, gen: int, *, arrivals=None,
                device=None, **engine_kwargs) -> dict:
    """Serve ``prompts`` (a list of int token arrays, any lengths)
    through a fresh ``ServingEngine``, ``gen`` new tokens each, request
    i admissible from engine step ``arrivals[i]``.  Returns {"tokens":
    [per-request arrays], "engine", "seconds"} — the wall time from the
    first submit until every request finished."""
    from repro_torch.serving import ServingEngine

    engine = ServingEngine(model, params, device=device, **engine_kwargs)
    arrivals = arrivals or [0] * len(prompts)
    t0 = now()
    rids = [engine.submit(p, gen, arrival=a)
            for p, a in zip(prompts, arrivals)]
    outs = engine.run()
    return {"tokens": [outs[r] for r in rids], "engine": engine,
            "seconds": now() - t0}


def _spec_kwargs(model, args, device):
    """Engine kwargs of ``--spec-mode``.  The draft-model demo builds the
    target arch at half its layers with its own random weights (a
    stand-in for a distilled draft model sharing the tokenizer)."""
    if args.spec_mode == "off":
        return {}
    kw = {"spec_mode": args.spec_mode, "draft_k": args.draft_k}
    if args.spec_mode == "draft-model":
        from repro_torch.models import build_model
        dcfg = dataclasses.replace(model.cfg,
                                   n_layers=max(1, model.cfg.n_layers // 2))
        dmodel = build_model(dcfg)
        kw["draft_model"] = dmodel
        kw["draft_params"] = dmodel.init(args.seed + 1, device=device,
                                         dtype=dcfg.compute_dtype)
    return kw


def _n_blocks(args) -> int:
    return args.n_blocks or (
        args.batch * (-(-(args.prompt_len + args.gen) // args.block_size))
        * 2 + 1)


def _serve_paged(model, params, tokens, args, device):
    """Continuous batching: requests join a running decode batch at
    their arrival step."""
    tokens = np.asarray(tokens)
    res = serve_paged(model, params, list(tokens), args.gen,
                      arrivals=[i * args.stagger for i in range(len(tokens))],
                      device=device, n_blocks=_n_blocks(args),
                      block_size=args.block_size, max_slots=args.batch,
                      prefill_chunk=args.prefill_chunk,
                      temperature=args.temperature, top_k=args.top_k,
                      seed=args.seed, kv_dtype=args.kv_dtype,
                      **_spec_kwargs(model, args, device))
    engine = res["engine"]
    mode = "" if args.spec_mode == "off" else \
        f" (spec {args.spec_mode}, draft_k {args.draft_k})"
    print(f"paged{mode}: {args.batch * args.gen} tokens over "
          f"{engine.step_count} engine steps in {res['seconds']:.3f}s")
    if args.metrics:
        _print_stats(dict(engine.stats), engine.request_metrics())
    return np.stack(res["tokens"])


def _serve_cluster(model, params, tokens, args, device):
    """Disaggregated serving: M prefill + N decode replicas behind the
    SLO router, each request's state handed off between the roles."""
    from repro_torch.serving import ServingCluster

    tokens = np.asarray(tokens)
    clu = ServingCluster(model, params,
                         prefill_replicas=args.prefill_replicas,
                         decode_replicas=args.replicas,
                         slo_ttft_ms=args.slo_ttft_ms,
                         slo_tpot_ms=args.slo_tpot_ms,
                         temperature=args.temperature, top_k=args.top_k,
                         seed=args.seed, device=device,
                         engine_kwargs=dict(n_blocks=_n_blocks(args),
                                            block_size=args.block_size,
                                            max_slots=args.batch,
                                            prefill_chunk=args.prefill_chunk,
                                            kv_dtype=args.kv_dtype),
                         # speculation rides the decode leg only
                         decode_engine_kwargs=_spec_kwargs(model, args,
                                                           device))
    crids = [clu.submit(row, args.gen, arrival=i * args.stagger)
             for i, row in enumerate(tokens)]
    t0 = now()
    outs = clu.run()
    t_total = now() - t0
    print(f"cluster ({args.prefill_replicas}P+{args.replicas}D, SLO "
          f"ttft<{args.slo_ttft_ms:g}ms tpot<{args.slo_tpot_ms:g}ms): "
          f"{args.batch * args.gen} tokens over {clu.step_count} cluster "
          f"steps in {t_total:.3f}s")
    if args.metrics:
        _print_stats(clu.stats(), clu.request_metrics())
    return np.stack([outs[r] for r in crids])


if __name__ == "__main__":
    main()
