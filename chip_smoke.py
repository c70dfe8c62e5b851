#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. card: name and power limit (nvidia-smi); build every kernel from the
   sources in this checkout (one nvcc per CUDA source, all at once);
   print each kernel's ptxas registers and spills, and the count of HGMMA
   (wgmma) instructions in the SASS of the flash forward, flash backward,
   paged and SSD chunk-scan libraries, which must not be 0 (nor may a
   freshly built one spill, nor ptxas serialize a wgmma of the SSD library, nor
   the fused rmsnorm backward spill at one slice a thread, the
   instantiations of every width up to 4096 in bf16, nor any
   instantiation of the rmsnorm forward or of the top-k gating kernels).
2. kernels: each hand-written kernel against its plain PyTorch version
   on the card, at the shapes phi4-mini-3.8b's serving and training
   paths give it, with its time, the plain version's time, one PyTorch
   library call that computes the same function (a yardstick the port
   never calls) and the least time the card could take (bytes over
   3.35 TB/s or operations over the peak rate, whichever is larger).
   Each case also holds the kernel's output against plain versions with
   a planted fault (the rmsnorm weight ignored, one warp's partial left
   out of its block's sum of squares, a persistent block's rstd carried
   from its previous row; the fused rmsnorm
   backward's projection term or last row block dropped, dx's dot from
   the previous row of its block's ring, one block's dw partial left out
   of the fixed-order sum; a key tile dropped, a row's own key masked,
   the flash forward's middle key tile skipped or its rescale of O
   dropped, fp8 / int8 scales ignored, delta dropped, the GQA sum over
   one head, one stage of the dK/dV kernel's ring or one of the dQ
   kernel's key tiles skipped); each of those must fail the tolerance.
   The flash forward runs also at the training steps' shapes (phi4's and
   zamba2's, b 2 x 2048) beside SDPA with enable_gqa, and every flash
   forward case must repeat bitwise.  The paged kernel runs at the
   serving path's shapes (decode ticks, T 16 chunks, the dense-cache
   view, a 256-token prefill chunk; bf16, fp8 and int8 pools; d 128 and
   64), at b 8 over S 4096 (several key splits an item) and with edge
   sequences (only key 0, full capacity, all padding), at the
   speculative verify window (T 5) and over the self-draft's dense
   cache of 1 088 positions.  The flash forward and backward run
   non-causal too, at whisper-base's shapes (8 heads of 64, b 8): the
   encoder over 1 500 frames (not a multiple of the 64-key tile) and
   cross-attention from 448 decoder rows (forward and backward) and
   from a decode tick's 1 row (forward), beside SDPA, with a causal
   mask applied and the last partial key tile dropped as their faults.
   Every paged case must
   repeat bitwise and write exact zeros for padding rows, its faults
   include "one split dropped" and "combine rescale dropped", and it is
   timed warm (``ms``) and cold (``ms_cold``, each call on its own copy
   of the pools, > 64 MB of K/V between two uses).  The rmsnorm forward
   runs at the decode tick, at phi4's and zamba2's training shapes with
   rstd (held against the plain rstd), in fp32, on rows 3075 elements
   apart and at d 2500; every case repeats bitwise and is timed warm and
   cold beside its bound and ``F.rms_norm``.  The fused rmsnorm
   backward (dx and dw in one launch) runs at phi4's and zamba2's
   training shapes and a decode-sized one, repeats bitwise and is timed
   warm and cold beside autograd of ``F.rms_norm``.  The backward
   cases also hold the forward kernels' residuals (rstd, lse) against the
   plain forward's, and the chain forward kernel -> backward kernels
   against plain forward -> plain backward; the flash backward kernels
   must repeat bitwise and give dK = dV = 0 past kv_len.  The forward
   cases time one eager call through the op as serving calls it, with
   no gradient to take (``host_ms``), and through the kernel's wrapper
   alone (``host_ms_wrapper``), in turn, the least of five readings
   each.
3. serving end to end: phi4-mini-3.8b at full width in bf16 (random
   weights drawn on the card from seed 0) serves 8 requests with prompts
   of 64..1024 tokens, staggered arrivals and 32 new tokens each through
   ``repro_torch.launch.serve.serve_paged``, once with whole-prompt
   prefill and once with prefill chunks of 256.  Every serving kernel's
   launch counter is zeroed before each run and must be > 0 after it.
   Then the kernel path and the plain path are held against each other
   on the same prompts: first-token logits and 4 teacher-forced decode
   ticks through a fragmented paged pool.  Then the same trace three
   more ways: speculation with n-gram drafts (draft_k 4: every verify a
   T = 5 chunk through the paged kernel), with the target as its own
   draft model (a dense cache of 1 088 positions a request), and a
   ``ServingCluster`` of 2 prefill and 2 decode engines sharing the
   params (every handoff timed and its imported blocks held bitwise
   against the export), then a flush of every prefix to a 3FS prefix
   store and one cross-replica store hit.  Gates: (i) each greedy
   stream equals the plain engine's up to the plain path's first
   near-tie (top-two gap within E2E_REL_TOL of max |logit|), and past
   its first difference every token lies within that tolerance of the
   largest logit, the stream teacher-forced along itself; (ii) a
   prefill's blocks exported, published, fetched and imported by
   another engine bitwise in bf16 and e4m3 (codes and scale rows);
   (iii) planted faults caught: a draft accepted past the first
   mismatch, a rollback that keeps the rejected tail's blocks (the
   block tables after every spec tick must cover exactly the accepted
   tokens), one flipped byte in a fetched artifact.
4. training end to end: phi4-mini-3.8b at full width (bf16 working
   params, fp32 masters and moments, per-layer remat) — the kernel
   path's loss and gradients on one batch of 2 x 2048 tokens against
   the plain path's, and the same with planted faults: four wiring
   faults that must fail the gates (delta dropped, the causal mask off
   by one, the kv heads rolled, rstd = 1 in the rmsnorm backward) and
   three that touch 1/32 of the rows, recorded to show the gates'
   resolution; then 8 AdamW
   steps through
   ``repro_torch.parallel.plan.make_train_step`` with every training
   kernel's launch counter zeroed before and > 0 after, step time,
   tokens/s, model FLOPs utilisation, peak memory, and one profiled
   step.
5. checkpoint: phi4-mini-3.8b at full width with 2 of its 32 layers
   (~0.82 B parameters, ~11.4 GB of bf16 params and fp32 master, m, v;
   ~23 GB on disk at replication 2; the phase fails unless 3x the
   state's bytes are free under build/ckpt_phase): a probe (one step
   twice from two clones of one state: does the step repeat bitwise?),
   6 steps straight, then 3 steps, an async ``ElasticCheckpointer``
   save to an in-process 3FS cluster with 2 more steps taken while the
   write is in flight, a restart (state, model, checkpointer and
   cluster dropped, a fresh 3FS backend over the root) and
   ``restore_latest``, the remaining 3 steps (batches from the port's
   ``PrefetchLoader``), ``restore_for`` onto ddp + ZeRO-1 over a
   one-rank gloo grid, saved as ``zero1_flat`` and resharded back to a
   tree, and ``python -m repro_torch.launch.train --smoke --ckpt-fs3``
   on the card (run as ``-m`` runs it, in this process), 4 steps with
   ``--trace`` (the Chrome-trace JSON must load and hold ``train.step``
   and ``ckpt.*`` events) then ``--resume`` to 6.  Gates: the restored
   state bitwise equal to the state at the save, the resumed losses and
   final state bitwise equal to the straight run's, the tree -> ZeRO-1
   -> tree round trip bitwise, the training kernels launched in the
   resumed steps, and four planted faults caught (a snapshot holding
   references, one master offset shifted by one element, a ZeRO-1
   shard missing, the resumed loader restarted at step 0).  Prints the
   checkpoint's bytes and chunks, the seconds the caller was blocked
   by the async save, of the background write and of the restore with
   their GB/s, and the free disk.
6. MoE serving: qwen2-moe-a2.7b at full width (24 layers, random bf16
   weights from seed 0) serves the same trace over its vocabulary, both
   runs, every serving kernel (the top-k gating forward included)
   launched; logits against the gating-only reference (gate_impl
   "ref") and the whole plain path; one MoE layer at full width against
   the plain route, with experts rolled by one as a planted fault;
   n-gram speculation on 4 requests of the trace under gate (i).
7. MoE training: qwen2-moe-a2.7b at full widths with 4 of its 24 layers
   (capacity-limited dispatch): loss and gradients against the plain
   path, the gating-only reference and the plain gating backward (with
   planted gating-backward faults), then 8 AdamW steps as in 4.

8. hybrid serving: zamba2-1.2b at full width and depth (38 Mamba-2
   layers, the shared attention block 6 times, random bf16 weights from
   seed 0) serves the same trace, both runs, every serving kernel (the
   SSD chunk scan included, 38 launches per prompt) launched; logits
   against the SSD-only reference (ssm_impl "ref") and the whole plain
   path; speculation on 4 requests with a drafter proposing 2 true
   tokens then junk (partial acceptance and the correction pass on every
   tick) under gate (i), which the correction pass skipped must fail.
9. hybrid training: zamba2-1.2b at full width and depth: loss and
   gradients against the plain path and against the plain SSD backward
   in place of the kernel's (with planted SSD-backward faults), then 8
   AdamW steps as in 4, with the SSD kernels' launches per step checked.
9b. families (``families_phase``): xlstm-125m at full width and depth
   (12 blocks "mmsmmsmmsmms", d 768), whisper-base at full size (6 + 6
   layers, d 512, 8 heads of 64) and internvl2-76b at full width (d
   8192, 64 heads of 128, GQA 8, vocab 128 256) with 2 of its 80
   layers, random bf16 weights drawn once each from seed 0.  Each serves
   8 requests (xLSTM: 512-token prompts through
   ``launch.serve._serve_dense``; Whisper: 1 500 encoder frames and 32
   tokens through ``serve_lib.BatchServer``; the VLM: 256 patches + 256
   tokens through ``_serve_dense``), 32 greedy tokens, every serving
   kernel of its path launched, then trains 3 AdamW steps (xLSTM 4 x
   512, Whisper 8 x (1 500 frames, 448 tokens), the VLM 2 x (256 + 1
   792), remat).  Gates against the plain path: every prompt row's
   logits within E2E_REL_TOL of that row's max |logit| (the first
   token's row among them), every row of Whisper's encoder output
   within WHISPER_ENC_TOL of its max, every greedy stream through gate
   (i), the loss within 1e-3 and every gradient leaf within 3e-2.
   Planted faults that must fail their gate: Whisper's cross-attention
   run causal (logits), its encoder run causal (encoder), the mLSTM
   chunk carry reset between chunks, sLSTM's recurrent term R dropped,
   the VLM's patches dropped from the prompt (logits).  Prints serving seconds, tokens/s, TTFT and TPOT
   p50 / p95, step time, tokens/s, MFU, peak memory, launches per step
   and the profiled step's busy share (``families_summary``).
10. HaiScale DDP training: gpt2-medium at full width and depth (24
   layers, d 1024) as 8 ranks sharing the card, 2 pods x 4 data, each
   rank 2 x 1024 tokens, gloo collectives staged through pinned host
   memory (``core.grid.Grid(staging="host")``, spawned by
   ``testing.multidev.run_ranks``).  Gates on step 1's synced gradient:
   (i) uncompressed against one process on the whole global batch, (ii)
   overlap on against off, bitwise, (iii) the int8 wire through the
   kernels against the plain quantizer, bitwise, (iv) int8 against
   uncompressed within the quantization bound, (v) planted faults (the
   prescale dropped, a strong rank's shard missing from phase 3, a
   bucket's hook one leaf early) that (i) or (ii) must catch; then 1
   step with each of the uncompressed and int8 wires (overlap on, every
   kernel's launches counted from the ranks), one with overlap off, and
   the hfreduce of the whole gradient with each wire format.
11. HaiScale pp training: llama-13b at full width (d 5120, 40 heads of
   128, SwiGLU 13 824, vocab 32 000, untied) with 4 of its 40 layers
   under ``ParallelPlan(mode="pp")`` as 2 ranks sharing the card (pipe
   2 x pod 1 x data 1, 2 layers a stage, host-staged gloo), a global
   batch of 8 x 2048 tokens in 8 microbatches, AdamW.  Gates: (i) the
   gradient the step hands its optimizer at step 1 (gpipe and 1f1b)
   against one process on the whole batch, (ii) gpipe and 1f1b
   bitwise equal over 2 steps, losses and recorded gradients, (iii)
   planted faults (1F1B's forward storing into the ring before the
   backward reads its slot, a cotangent send dropped, the gradients
   not divided by the microbatch count, stage 1 slicing its layers at
   the wrong offset) that (i) or (ii) must catch; every training
   kernel launched.  Prints each schedule's step times, ticks, peak
   memory per rank and the seconds in pipe sends and in the gradient
   sum over the pipe.  The bubble is not idle time on one shared card.
12. HAI-Platform fault tolerance (``ft_phase``): gpt2-medium at full
   width and depth (bf16, AdamW with fp32 masters) as 4 ranks sharing
   the card over host-staged gloo, 4 x 1024 tokens a step, under
   ``platform.FTRunner`` with ``elastic.ElasticCheckpointer`` saving
   asynchronously to an in-process 3FS cluster
   (``testing.multidev.check_elastic``).  Leg 1: ddp + ZeRO-1, the
   first non-fatal Table-V class of ``FailureModel(0)`` between two
   checkpoints; the losses, replay included, and every leaf of the
   final state bitwise equal to an unbroken run.  Leg 2: pp (2 stages,
   1f1b), the first fatal class of ``FailureModel(1)``, the validator
   healthy on the card, ``restore_for`` onto ddp + ZeRO-1 over 2 of the
   ranks; 3 post-restore losses within 1e-3 relative of the unbroken
   pp run, one rescale, world 1, the lost steps.  Both: each record
   once, the event log's JSONL equal to the report, validator <
   restore < rescale.  Planted faults (resuming at the failure step,
   the survivors' ZeRO-1 shards swapped, a broken GEMM check) must
   each fail its gate.

The kernel cases of phase 2 include both top-k gating kernels at the
MoE shapes (qwen2-moe's decode, prefill and training rows, 64 experts
top-6, 128 top-8, no renorm, tie rows, bf16 logits) with planted faults
(among them the lane groups emulated by ``gating_lane_groups`` with the
row's last lane ignored and by ``gating_bwd_lane_groups`` with a pick's
dw taken from the neighbouring lane), both repeating bitwise, the
backward timed warm and cold beside a device copy of the same bytes
(phase 1 fails on a ptxas spill in the gating library), both SSD
chunk-scan kernels at zamba2's shapes (the training step, prefills of
1024, 200 and 768 tokens, one fp32 case, a 777-token prompt through
the padding wrapper) with planted faults (the carried state dropped,
the diagonal of L masked, dh_final ignored, da's reverse cumsum shifted
by a row, dB summed over half the heads, and, of the bf16 kernels'
design emulated in plain torch by ``ssd_blocked_fwd`` /
``ssd_blocked_bwd``, the state fold off by one chunk and an fp32
operand rounded to bf16 with its lo half dropped), each forward and
backward twice bitwise equal, timed warm and cold, their bound with
the fp32-operand products at the tensor cores' rate and, as before,
at the CUDA cores', the reused forward and
backward kernels at zamba2's shapes (head dim 64, rmsnorm over 4096 and
2048), and the int8 quantize / dequantize kernels at the DDP wire's
shapes (one bucket's weak shard, the whole per-rank payload, zero
blocks, values on code boundaries, a length the wrapper pads), held
bitwise against their plain versions, with planted faults (truncation,
the reciprocal multiply, the absmax over half the block with and
without the clip, a neighbour's scale).

Every result is printed as one JSON object per line.  The last line is
{"ok": true, "device": {...}}; the line before it lists every kernel's
numbers as one JSON object, and the line before that the card.
"""
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ARCH = "phi4-mini-3.8b"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
# "fp32_tensor": a product with an fp32 operand on the tensor cores, as
# two bf16 products (hi + lo) or one TF32 product: the TF32 rate
PEAK = {"bf16_tensor": 989e12, "fp32_tensor": 495e12, "fp32": 67e12}
SEED = 0

# bf16 tolerances (atol, rtol), kernel vs plain version on the same
# inputs: both compute in fp32 and round the output to bf16 (one bf16 ulp
# is 2^-8 relative, 2 ulps is under 1e-2); the attention kernels also
# round P (and dequantized fp8 / int8 K, V) to bf16 before their
# tensor-core products.  Every case prints the share of its tolerance
# it used, and planted faults (``controls``) must exceed it.
TOL = {"rmsnorm": (1e-2, 1e-2), "flash_attention": (1e-2, 1e-2),
       "paged_chunk_attention": (8e-3, 1e-2),
       # backward, kernel vs plain function on the same inputs: dx and
       # dK / dV / dQ are rounded to bf16 once at the end (P and dS also
       # before their tensor-core products); dw is an fp32 sum over rows
       # in another order
       "rmsnorm_bwd_dx": (1e-2, 1e-2), "rmsnorm_bwd_dw": (1e-3, 1e-4),
       "flash_attention_bwd_dkv": (2e-2, 2e-2),
       "flash_attention_bwd_dq": (2e-2, 2e-2),
       # the forward kernels' residuals, which the backward kernels read
       # on the training path: both sides reduce in fp32 in another order
       "rmsnorm_rstd": (0.0, 1e-5),
       # top-k gating, kernel vs plain function on the same fp32 logits:
       # the same arithmetic (accurate expf, a divide by the row sum) with
       # sums in another order; experts must be identical
       "topk_gating": (1e-6, 0.0), "topk_gating_bwd": (1e-6, 1e-5),
       # bf16 logits: both sides compute in fp32 from the same bf16 logits
       # and round dlogits to bf16 once, so an element lands at most one
       # bf16 neighbour away (2^-7 relative at most)
       "topk_gating_bwd_bf16": (1e-6, 2.0 ** -7),
       # the flash kernel sums P after rounding it to bf16 (its l is the
       # normaliser of the P that multiplies V), each term within 2^-9
       # relative, so its lse lies within log(1 + 2^-9) = 1.95e-3
       "flash_attention_lse": (2e-3, 0.0)}
# end to end, kernel path vs plain path at full width: max |difference|
# over max |plain logit| — bf16 rounding differs per op across 32 layers
E2E_REL_TOL = 1.5e-2
# training, kernel path vs plain path on one batch at full width: the
# loss's relative difference, and per gradient leaf |g - g_plain| /
# |g_plain| (Frobenius norms) — bf16 gradients through 32 layers.  Each
# gate lies between the sound kernel path's reading and the readings of
# the planted faults of ``train_faults``, which must exceed one of them
TRAIN_LOSS_REL_TOL = 1e-3
TRAIN_GRAD_REL_TOL = 3e-2
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 8
TRAIN_KERNELS = ("rmsnorm", "rmsnorm_bwd", "flash_attention",
                 "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
# rows per tile: TILE of the paged kernel's streamed K / V tiles
# (paged_chunk_attention.cu), of the flash forward's key tiles
# (flash_attention_fwd.cu) and of the flash backward's streamed tiles
# (flash_attention_bwd.cu)
KEY_TILE = 64
# the paged kernel's cold timing: touched K/V bytes between two uses of
# one copy of the pools, above the H100's 50 MB L2
COLD_BYTES = 64 * 2 ** 20

# the MoE family: qwen2-moe-a2.7b serves at full width (24 layers) and
# trains at full widths with its depth cut to MOE_TRAIN_LAYERS, so that
# weights, fp32 masters, moments and gradients (~47 GB) fit one card
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_TRAIN_LAYERS = 4
# gating only (gate_impl "auto" against "ref", every other kernel on):
# the two routes' weights differ in fp32 ulps (softmax sums in another
# order), which now and then rounds a bf16 combine weight the other way;
# the served logits are bf16, so the gate counts bf16 ulps of the
# largest logit (the first reading: 1 ulp, or bitwise equal), with
# identical greedy tokens.  Training: the loss within 1e-5 relative
MOE_GATE_LOGIT_ULPS = 2
MOE_GATE_LOSS_TOL = 1e-5
# the routed experts' and the router's gradient leaves, kernel path vs a
# reference whose bf16 rounding differs: a rounding difference upstream
# of a router flips near-tied expert choices and capacity ranks, and
# one token changed in an expert queue of ~336 capacity-limited slots
# moves that expert's gradient by ~sqrt(2 / 336) = 7.7 %.  The gate lies
# between the first readings (5.0-6.5e-2) and the planted gating
# backward faults (>= 0.32)
MOE_ROUTED_GRAD_TOL = 0.2
MOE_ROUTED_LEAVES = ("layers/moe_router", "layers/moe_e_gate",
                     "layers/moe_e_up", "layers/moe_e_down")
# the gating backward kernel in place, forward bitwise the same (kernel
# forward in both, backward kernel vs plain backward): the router's
# gradient within 1e-3 relative norm
MOE_GATE_ROUTER_TOL = 1e-3
# one MoE layer's routed experts at full width in bf16, gating kernel
# route vs plain route on the same inputs: max |difference| over max |y|
# (a weight rounded to the other bf16 neighbour moves its token's y by
# <= 2^-8 relative); experts rolled by one must fail it
MOE_LAYER_TOL = 1e-2
# the MoE kernel path against the whole plain path end to end
MOE_E2E_REL_TOL = E2E_REL_TOL

KERNEL_META = {
    "rmsnorm": ("cuda", "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm_fwd.cu",
                "src/repro/kernels/rmsnorm/kernel.py:36"),
    "flash_attention": (
        "cuda", "src/repro_torch/kernels/flash_attention/csrc/"
        "flash_attention_fwd.cu",
        "src/repro/kernels/flash_attention/kernel.py:105"),
    "paged_chunk_attention": (
        "cuda", "src/repro_torch/kernels/paged_chunk_attention/csrc/"
        "paged_chunk_attention.cu",
        "src/repro/kernels/paged_chunk_attention/kernel.py:105"),
    "rmsnorm_bwd": ("cuda",
                    "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm_bwd.cu",
                    "src/repro/kernels/rmsnorm/kernel.py:76"),
    "flash_attention_bwd_dkv": (
        "cuda", "src/repro_torch/kernels/flash_attention/csrc/"
        "flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention/kernel.py:205"),
    "flash_attention_bwd_dq": (
        "cuda", "src/repro_torch/kernels/flash_attention/csrc/"
        "flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention/kernel.py:289"),
    "topk_gating": ("cuda",
                    "src/repro_torch/kernels/topk_gating/csrc/topk_gating.cu",
                    "src/repro/kernels/topk_gating/kernel.py:50"),
    "topk_gating_bwd": (
        "cuda", "src/repro_torch/kernels/topk_gating/csrc/topk_gating.cu",
        "src/repro/kernels/topk_gating/kernel.py:94"),
    "ssd_scan": ("cuda", "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan/kernel.py:76"),
    "ssd_scan_bwd": (
        "cuda", "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan/kernel.py:195"),
    "quantize": ("cuda",
                 "src/repro_torch/kernels/quant_comm/csrc/quant_comm.cu",
                 "src/repro/kernels/quant_comm/kernel.py:34"),
    "dequantize": ("cuda",
                   "src/repro_torch/kernels/quant_comm/csrc/quant_comm.cu",
                   "src/repro/kernels/quant_comm/kernel.py:55"),
}
# one hand-written kernel in place of two TPU kernels: the other one
ALSO_REPLACES = {"rmsnorm_bwd": "src/repro/kernels/rmsnorm/kernel.py:103"}
DENSE_SERVING_KERNELS = ("rmsnorm", "flash_attention",
                         "paged_chunk_attention")
SERVING_KERNELS = DENSE_SERVING_KERNELS + ("topk_gating",)
MOE_TRAIN_KERNELS = TRAIN_KERNELS + ("topk_gating", "topk_gating_bwd")

# the hybrid family: zamba2-1.2b (38 Mamba-2 layers, one shared attention
# block every 6) serves and trains at full width and full depth
HYBRID_ARCH = "zamba2-1.2b"
HYBRID_SERVING_KERNELS = DENSE_SERVING_KERNELS + ("ssd_scan",)
HYBRID_TRAIN_KERNELS = TRAIN_KERNELS + ("ssd_scan", "ssd_scan_bwd")
# SSD chunk scan, kernel vs plain function on the same inputs, max
# |difference| over max |plain|: outputs in bf16 are rounded once at the
# end by both sides (sums in another order can round an element to the
# other bf16 neighbour: up to 2^-7 of the largest value); fp32 outputs
# (h_final, h_prev, da) differ only in the order of fp32 sums
SSD_REL_TOL = {"bf16": 1e-2, "fp32": 1e-4}
# zamba2 serving, the SSD scan alone switched (ssm_impl "ref" against the
# kernel, every other kernel on): bf16 ulps of the largest logit, with
# identical greedy tokens.  The sound kernel reads bitwise equal under
# the init rule; 1 ulp (not 2) so that the SSD kernel with its carry
# dropped, 1.81-2.13 ulps there, fails it
HYBRID_SSD_LOGIT_ULPS = 1
# zamba2 serving, kernel path vs the whole plain path: max |difference|
# over max |plain logit|.  bf16 rounding through 38 + 6 sublayers: the
# first reading was 1.57-1.80e-2 (phi4's gate is 1.5e-2 at 32 layers)
# with the SSD-only logits bitwise equal, and both bf16 paths lay
# 4.1-5.5e-2 from the fp32 forward, the kernel path no farther than the
# plain one (recorded every run in ``hybrid_serve_phase``)
HYBRID_E2E_REL_TOL = 2.5e-2
# zamba2 serving on slow-decay weights: A_log = log(0.05) in every Mamba
# layer (as the CPU tests draw it; a ~ -0.05 dt per step, where the init
# rule's A_log = 1 gives a ~ -1.9), so that the state carried across a
# 256-token chunk matters.  There each SSD forward call of the serving
# path is held at the op (SSD_REL_TOL against the plain forward on the
# same inputs) and the logits at the two gates above; the kernel with
# its carry dropped must fail the op gate and the SSD-only one
SLOW_A_LOG = math.log(0.05)
# zamba2 training, the kernel forward with the plain SSD backward in
# place of the kernel's (the forward bitwise the same) is held at two
# levels: at the op, each of the 38 backward calls' kernel outputs
# against the plain backward's on the same saved inputs (SSD_REL_TOL);
# at the Mamba leaves, the gradients' relative norm against the kernel
# path's within TRAIN_GRAD_REL_TOL.  The leaves cannot hold the plain
# backward to 1e-3: the two backwards round dx, dB and dC to bf16 apart,
# and 38 layers of bf16 backward carry that to ~1.2e-2 (first reading).


def ptxas_lines(log):
    """(kernel, line) for each register and spill line of an nvcc
    ``-Xptxas -v`` log, the kernel named as c++filt demangles it."""
    import re
    fn, out = "", []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            try:
                fn = subprocess.run(["c++filt", fn], capture_output=True,
                                    text=True, timeout=30).stdout.strip()
            except OSError:
                pass
            fn = fn.replace("(anonymous namespace)::", "")
        elif "registers" in line or "spill" in line:
            out.append((fn, line.strip()))
    return out


def spills(log):
    """The ptxas lines of an nvcc log that report spilled bytes."""
    import re
    return [(fn, line) for fn, line in ptxas_lines(log)
            if any(int(n) for n in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", line))]


def serialized(log):
    """The lines of an nvcc log where ptxas reports wgmma serialized."""
    return [line.strip() for line in log.splitlines()
            if "wgmma" in line and "serialized" in line]


def sass_count(name, opcode):
    """How often ``opcode`` appears in the SASS of kernel library
    ``name`` (cuobjdump from the CUDA toolkit that built it)."""
    from repro_torch.kernels import build
    exe = Path(build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(exe), "-sass", str(build.lib_path(name))],
                          capture_output=True, text=True, timeout=300)
    if sass.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {sass.stderr.strip()}")
    return sass.stdout.count(opcode)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ------------------------------ measurement ---------------------------------


def _events_ms(run, iters):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_ms(fn, iters=20, warmup=3, stream=None):
    """Device time of one ``fn()``: ``iters`` calls captured in one CUDA
    graph and replayed between two events, so the host's launch cost
    (Python, ctypes) is not counted.  ``stream``: the
    side stream to warm up and capture on (default: warm up on the
    current stream, capture on torch's own side stream)."""
    import torch
    with torch.cuda.stream(stream or torch.cuda.current_stream()):
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = _events_ms(graph.replay, iters)
    del graph
    return ms


def backward_ms(forward, inputs, grad, iters=20):
    """Device time of one backward of ``forward()`` for ``inputs``.
    Autograd runs each backward op on the stream its forward op ran on,
    so the forward runs on the side stream the graph then captures on."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = forward()
    return time_ms(lambda: torch.autograd.grad(out, inputs, grad,
                                               retain_graph=True),
                   iters, stream=side)


def host_ms(fn, iters=20, warmup=3):
    """Time per eager ``fn()`` call, launches included — what the
    serving loop pays when the host is the bottleneck."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()
    return _events_ms(run, iters)


def host_ms_pair(a, b, reps=5):
    """``host_ms`` of two calls measured in turn ``reps`` times; the
    least reading of each, the one least disturbed by other work on the
    host."""
    ra, rb = [], []
    for _ in range(reps):
        ra.append(host_ms(a))
        rb.append(host_ms(b))
    return min(ra), min(rb)


def bound(nbytes, ops, peak=None):
    """The least time (ms) for ``nbytes`` of memory traffic and ``ops``
    operations at the ``peak`` rate, or ``ops`` {peak: count} for work
    of several types (their times add)."""
    per = ops if isinstance(ops, dict) else {peak: ops}
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK[k] for k, n in per.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name, got, ref):
    """max |got - ref|, the share of the tolerance used (the largest
    |got - ref| / (atol + rtol |ref|) over the elements) and whether it
    passes: share <= 1 and every value finite."""
    import torch
    atol, rtol = TOL[name]
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    used = float((err / (atol + rtol * r.abs())).max())
    ok = used <= 1 and bool(torch.isfinite(g).all())
    return float(err.max()), used, ok


def checked(name, got, ref, faulty=None):
    """``compare`` and ``controls`` as one record."""
    err, used, ok = compare(name, got, ref)
    return {"max_abs_err": err, "tol_used": used, "ok": ok,
            "controls": controls(name, got, faulty or {})}


def controls(name, got, faulty):
    """The kernel's output held against plain versions with a planted
    fault: each must fail the tolerance (``caught``)."""
    out = []
    for fault, ref in faulty.items():
        err, used, ok = compare(name, got, ref)
        out.append({"fault": fault, "max_abs_err": err, "tol_used": used,
                    "caught": not ok})
    return out


# --------------------------------- kernels ----------------------------------


# the rmsnorm forward kernel's design faults (rmsnorm_fwd.cu), emulated in
# plain torch by ``rmsnorm_blocks``
RMS_WARP_FAULT = "one warp's partial left out of the block's sum of squares"
RMS_CARRY_FAULT = "a persistent block's rstd carried from its previous row"


def rmsnorm_blocks(x, w, plan, eps=1e-6, fault=None):
    """(y in x.dtype, rstd (n,) fp32) as the rmsnorm forward kernel
    computes them under ``plan`` (``kernels.rmsnorm.kernel.fwd_plan``):
    block b takes the rows ``plan.rows[b]``, its thread t the row's
    16-byte slices t, t + 32 * plan.warps, ..., the block's sum of
    squares its warps' partials.  Fault RMS_WARP_FAULT: warp 0's partial
    (its threads' slices) left out of the sum (not out of y).
    Fault RMS_CARRY_FAULT: every row of a block but its first normalised
    by the rstd of the row before it."""
    import torch
    n, d = x.shape
    xf = x.float()
    sq = xf.square()
    if fault == RMS_WARP_FAULT:
        vec = torch.arange(d, device=x.device) // (16 // x.element_size())
        sq = sq * (vec % (32 * plan.warps) >= 32)
    elif fault not in (None, RMS_CARRY_FAULT):
        raise ValueError(fault)
    rstd = torch.rsqrt(sq.sum(dim=-1) / d + eps)
    if fault == RMS_CARRY_FAULT:
        src = torch.arange(n, device=x.device) - 1
        first = torch.tensor([lo for lo, _ in plan.rows], dtype=torch.long,
                             device=x.device)
        src[first] = first
        rstd = rstd[src]
    return (xf * rstd[:, None] * w.float()).to(x.dtype), rstd


def check_rmsnorm(dev, n, d, dtype="bfloat16", stride=None,
                  save_rstd=False):
    """The forward kernel against the plain forward on the same x (n, d),
    rows ``stride`` elements apart (default d), and w: y within
    TOL["rmsnorm"], with ``save_rstd`` (the training path) rstd within
    TOL["rmsnorm_rstd"] of the plain rstd; two launches bitwise equal.
    Planted faults on y (and rstd): the weight ignored, and the kernel's
    design faults emulated by ``rmsnorm_blocks``: one warp's partial
    left out of the block's sum of squares, and, where a block of the
    plan has two rows or more, a persistent block's rstd carried from its
    previous row.
    Timed as the path calls it (with rstd at the training shapes): warm
    (``ms``) and cold (``ms_cold``: each call on its own copy of x, > 64
    MB of them between two uses), each beside the bound and beside a
    device copy of the same bytes (``copy_ms``, ``copy_ms_cold``: what
    the card's memory gives this even mix of reads and writes); host
    time of one eager call through the op as serving calls it
    (``host_ms``) and through the wrapper (``host_ms_wrapper``), in
    turn, least of five."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_fwd_ref,
                                             rmsnorm_ref)
    from repro_torch.kernels.rmsnorm.kernel import fwd_plan_for, rmsnorm_fwd
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(n, stride or d, device=dev, generator=g).to(dt)[:, :d]
    w = (1 + 0.1 * torch.randn(d, device=dev, generator=g)).to(dt)
    plan = fwd_plan_for(x)
    if save_rstd:
        fn = lambda: rmsnorm_fwd(x, w, save_rstd=True)   # noqa: E731
        plain = lambda: rmsnorm_fwd_ref(x, w)            # noqa: E731
    else:
        fn = lambda: rmsnorm(x, w)                       # noqa: E731
        plain = lambda: rmsnorm_ref(x, w)                # noqa: E731
    first, second = fn(), fn()
    got, rstd = first if save_rstd else (first, None)
    bitwise = bool(torch.equal(got, second[0] if save_rstd else second) and
                   (rstd is None or torch.equal(rstd, second[1])))
    ref, ref_rstd = rmsnorm_fwd_ref(x, w)
    designed = [RMS_WARP_FAULT] + ([RMS_CARRY_FAULT] if max(
        hi - lo for lo, hi in plan.rows) > 1 else [])
    faulty = {f: rmsnorm_blocks(x, w, plan, fault=f) for f in designed}
    row = checked("rmsnorm", got, ref, {
        "weight ignored": rmsnorm_ref(x, torch.ones_like(w)),
        **{f: out[0] for f, out in faulty.items()}})
    if save_rstd:
        row["residual"] = {"rstd": checked("rmsnorm_rstd", rstd, ref_rstd, {
            f: out[1] for f, out in faulty.items()})}
    # cold: copies of x with its strides, > COLD_BYTES of them between
    # two uses
    copies = []
    for _ in range(min(1024, COLD_BYTES // (n * d * x.element_size()) + 2)):
        c = torch.empty_strided(x.shape, x.stride(), dtype=dt, device=dev)
        copies.append(c.copy_(x))
    ms_cold = cold_ms([lambda c=c: rmsnorm_fwd(c, w, save_rstd=save_rstd)
                       for c in copies])
    # yardstick: a device copy of the same bytes (x read, y written once)
    copy_ms_cold = cold_ms([lambda c=c: torch.empty((n, d), dtype=dt,
                                                    device=dev).copy_(c)
                            for c in copies])
    del copies
    ms = time_ms(fn)
    b_ms, b_by = bound(2 * n * d * x.element_size() + d * w.element_size()
                       + (4 * n if save_rstd else 0), 4 * n * d, "fp32")
    op_host, wrapper_host = host_ms_pair(lambda: rmsnorm(x, w),
                                         lambda: rmsnorm_fwd(x, w))
    case = f"n={n},d={d},{'bf16' if dtype == 'bfloat16' else dtype}" + \
        (f",stride={stride}" if stride else "") + \
        (",rstd" if save_rstd else "")
    return {"case": case, **row, "ok": row["ok"] and bitwise,
            "bitwise_repeat": bitwise,
            "plan": {k: getattr(plan, k) for k in (
                "blocks", "warps", "width", "slices")},
            "ms": ms, "ms_cold": ms_cold, "bound_share": b_ms / ms,
            "bound_share_cold": b_ms / ms_cold,
            "host_ms": op_host, "host_ms_wrapper": wrapper_host,
            "plain_ms": time_ms(plain),
            "library_ms": time_ms(lambda: F.rms_norm(x, (d,), w, 1e-6)),
            "library_covers": "y only (F.rms_norm)",
            "copy_ms": time_ms(lambda: torch.empty((n, d), dtype=dt,
                                                   device=dev).copy_(x)),
            "copy_ms_cold": copy_ms_cold,
            "bound_ms": b_ms, "bound_by": b_by}


def _fwd_pairs(q, k, kw):
    """Scores s (b, h, sq, skv) fp32, the (sq, skv) mask of the pairs the
    causal (unless ``kw["causal"]`` is False) / kv_len mask keeps, and
    the GQA group, as the flash forward kernel sees them (end-aligned
    q_offset by default)."""
    import torch
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    q_offset = skv - sq if kw.get("q_offset") is None else kw["q_offset"]
    kv_len = skv if kw.get("kv_len") is None else kw["kv_len"]
    kf = k.float().repeat_interleave(h // kvh, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * d ** -0.5
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(skv, device=q.device)
    valid = kpos[None, :] < kv_len
    if kw.get("causal", True):
        valid = valid & (kpos[None, :] <= qpos[:, None])
    return s, valid, h // kvh


def middle_tile_skipped(q, k, v, kw):
    """The plain forward with one of the flash forward kernel's key tiles
    lost: the middle 64-key tile below kv_len masked for every row (a row
    that keeps no key gives 0)."""
    import torch
    s, valid, group = _fwd_pairs(q, k, kw)
    skv = k.shape[2]
    kv_end = min(skv if kw.get("kv_len") is None else kw["kv_len"], skv)
    lo = (kv_end // KEY_TILE) // 2 * KEY_TILE
    kpos = torch.arange(skv, device=q.device)
    valid = valid & ~((kpos >= lo) & (kpos < min(lo + KEY_TILE, kv_end)))
    w = torch.softmax(s.masked_fill(~valid, float("-inf")), dim=-1)
    w = torch.nan_to_num(w) * valid
    vf = v.float().repeat_interleave(group, dim=1)
    return torch.einsum("bhqk,bhkd->bhqd", w, vf).to(q.dtype)


def rescale_dropped(q, k, v, kw):
    """The plain forward with the online softmax's rescale of O dropped:
    key tile by key tile of 64, O adds exp(s - m) V with m the running max
    after that tile but is never multiplied by exp(m_old - m_new); the
    normaliser l is kept right."""
    import torch
    s, valid, group = _fwd_pairs(q, k, kw)
    b, h, sq, skv = s.shape
    vf = v.float().repeat_interleave(group, dim=1)
    o = torch.zeros(b, h, sq, v.shape[-1], device=q.device)
    m = torch.full((b, h, sq, 1), -1e30, device=q.device)
    l = torch.zeros(b, h, sq, 1, device=q.device)
    for lo in range(0, skv, KEY_TILE):
        st = s[..., lo:lo + KEY_TILE].masked_fill(
            ~valid[:, lo:lo + KEY_TILE], float("-inf"))
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        p = torch.exp(st - m_new)
        l = l * torch.exp(m - m_new) + p.sum(-1, keepdim=True)
        o = o + torch.einsum("bhqk,bhkd->bhqd", p, vf[:, :, lo:lo + KEY_TILE])
        m = m_new
    return (o / l.clamp_min(1e-30)).to(q.dtype)


def check_flash(dev, sq, kv_len=None, b=1, h=24, kvh=8, d=128,
                sdpa_gqa=False, skv=None, causal=True):
    """The forward kernel against the plain forward at (b, sq, skv
    (default sq), h, kvh, d) in the model's (b, s, h, d) memory, keys
    past kv_len (default skv) masked, causal with end-aligned queries or
    (``causal=False``: Whisper's encoder, sq = skv, and its
    cross-attention, sq != skv) not.  Two launches must agree bitwise (o
    and lse).  Faults: the last key tile below kv_len dropped (a partial
    one where kv_len is not a multiple of 64), each row's own key masked
    (causal) or a causal mask applied (q_offset 0, as ``attention_core``
    passes it; non-causal), the middle key tile skipped, the rescale of
    O dropped.  The SDPA yardstick runs on K/V repeated to every head
    (``sdpa_gqa``: on the same tensors with ``enable_gqa``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_fwd
    skv = sq if skv is None else skv
    kv_len = skv if kv_len is None else kv_len
    g = torch.Generator(device=dev).manual_seed(2)
    bf = torch.bfloat16
    # the model's (b, s, h, d) layout, seen as (b, h, s, d) like the model
    q = torch.randn(b, sq, h, d, device=dev, generator=g).to(bf)
    k = torch.randn(b, skv, kvh, d, device=dev, generator=g).to(bf)
    v = torch.randn(b, skv, kvh, d, device=dev, generator=g).to(bf)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    kw = dict(kv_len=kv_len, causal=causal)
    got = flash_attention(qt, kt, vt, **kw)
    o1, lse1 = flash_attention_fwd(qt, kt, vt, save_lse=True, **kw)
    o2, lse2 = flash_attention_fwd(qt, kt, vt, save_lse=True, **kw)
    bitwise = bool(torch.equal(got, o1) and torch.equal(o1, o2)
                   and torch.equal(lse1, lse2))
    del o1, o2, lse1, lse2
    ref = attention_ref(qt, kt, vt, **kw)
    err, used, ok = compare("flash_attention", got, ref)
    del ref
    last = (min(kv_len, skv) - 1) // KEY_TILE * KEY_TILE
    faults = {
        "last key tile dropped" if kv_len % KEY_TILE == 0 else
        "last partial key tile dropped": attention_ref(
            qt, kt, vt, causal=causal, kv_len=last)}
    if causal:
        faults["own key masked"] = attention_ref(qt, kt, vt, q_offset=-1,
                                                 kv_len=kv_len)
    else:
        faults["causal mask applied"] = attention_ref(
            qt, kt, vt, q_offset=0, kv_len=kv_len)
    faults["middle key tile skipped"] = middle_tile_skipped(qt, kt, vt, kw)
    faults["rescale dropped"] = rescale_dropped(qt, kt, vt, kw)
    ctl = controls("flash_attention", got, faults)
    del faults
    if sdpa_gqa:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=causal, enable_gqa=True)
    else:
        kr = kt.repeat_interleave(h // kvh, dim=1).contiguous()
        vr = vt.repeat_interleave(h // kvh, dim=1).contiguous()
        qc = qt.contiguous()
        mask = None
        if kv_len != skv:
            qpos = skv - sq + torch.arange(sq, device=dev)
            kpos = torch.arange(skv, device=dev)
            mask = kpos[None, :] < kv_len
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qc, kr, vr, attn_mask=mask, is_causal=causal and mask is None)
    # work this input needs: the pairs among the first kv_len keys
    pairs = b * causal_pairs(sq, skv, skv - sq, kv_len, causal)
    # q read and o written; K and V only below kv_len (never fetched past)
    nbytes = b * (2 * sq * h * d + 2 * min(skv, kv_len) * kvh * d) * 2
    b_ms, b_by = bound(nbytes, 4 * d * h * pairs, "bf16_tensor")
    op_host, wrapper_host = host_ms_pair(
        lambda: flash_attention(qt, kt, vt, **kw),
        lambda: flash_attention_fwd(qt, kt, vt, **kw))
    case = (f"b={b},sq=skv={sq},kv_len={kv_len}," if causal else
            f"b={b},sq={sq},skv={skv},")
    return {"case": f"{case}h={h},kvh={kvh},d={d}" + (
                "" if causal else ",non-causal"),
            "max_abs_err": err, "tol_used": used, "ok": ok and bitwise,
            "bitwise_repeat": bitwise, "controls": ctl,
            "ms": time_ms(lambda: flash_attention(qt, kt, vt, **kw)),
            "host_ms": op_host, "host_ms_wrapper": wrapper_host,
            "plain_ms": time_ms(lambda: attention_ref(qt, kt, vt, **kw), 5),
            "library_ms": time_ms(lib), "bound_ms": b_ms, "bound_by": b_by}


def _paged_scores(q, kp, vp, bt, ps, ks=None, vs=None):
    """As the plain version sees a paged call: scores s (b, h, T, S) fp32
    (scaled), the (b, T, S) mask of the valid (row, key) pairs and V
    (b, S, h, d) fp32, gathered, dequantized and repeated to every head."""
    import torch
    from repro_torch.kernels.paged_chunk_attention.ref import _gather
    b, T, h, d = q.shape
    kvh = kp.shape[2]
    tables = bt.long()
    k = _gather(kp, tables).reshape(b, -1, kvh, d).float()
    v = _gather(vp, tables).reshape(b, -1, kvh, d).float()
    if ks is not None:
        k = k * ks[tables].reshape(b, -1)[:, :, None, None]
        v = v * vs[tables].reshape(b, -1)[:, :, None, None]
    k = k.repeat_interleave(h // kvh, dim=2)
    v = v.repeat_interleave(h // kvh, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q.float(), k) * d ** -0.5
    kpos = torch.arange(k.shape[1], device=q.device)
    valid = kpos[None, None, :] <= ps.long()[:, :, None]
    return s, valid, v


def split_combine(q, kp, vp, bt, ps, ks=None, vs=None, *, split_keys,
                  fault=None):
    """The plain version computed as the paged kernel splits it: the key
    axis cut into ranges of ``split_keys``, each range's (m, l, O) over
    its valid keys, and the combine of the ranges that start at or before
    a row's position, O = sum_s w_s O_s / sum_s w_s l_s with w_s =
    exp(m_s - max m) (a row at position < 0 reads none: zeros).  Faults:
    "one split dropped" (each row's last split -- the one holding its own
    position -- left out of the combine), "combine rescale dropped" (w_s
    = 1: partials summed without exp(m_s - max m))."""
    import torch
    s, valid, v = _paged_scores(q, kp, vp, bt, ps, ks, vs)
    b, h, T, S = s.shape
    pos = ps.long()
    nv = torch.where(pos >= 0, pos.clamp(max=S - 1) // split_keys + 1, 0)
    if fault == "one split dropped":
        nv = (nv - 1).clamp(min=0)
    neg = torch.tensor(-1e30, device=q.device)
    parts = []
    for i in range(-(-S // split_keys)):
        lo, hi = i * split_keys, min((i + 1) * split_keys, S)
        ok = valid[:, None, :, lo:hi]                       # (b, 1, T, k)
        si = s[..., lo:hi].masked_fill(~ok, float("-inf"))
        m = torch.maximum(si.amax(-1, keepdim=True), neg)   # (b, h, T, 1)
        p = torch.where(ok, torch.exp(si - m), 0.0)
        use = (i < nv)[:, None, :, None]
        parts.append((torch.where(use, m, neg),
                      p.sum(-1, keepdim=True) * use,
                      torch.einsum("bhtk,bkhd->bhtd", p, v[:, lo:hi]) * use))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    num = torch.zeros_like(parts[0][2])
    den = torch.zeros_like(parts[0][1])
    for m, l, o in parts:
        w = (torch.ones_like(m) if fault == "combine rescale dropped"
             else torch.exp(m - mx))
        num, den = num + w * o, den + w * l
    o = torch.where(den > 0, num / den.clamp_min(1e-30), 0.0)
    return o.permute(0, 2, 1, 3).to(q.dtype)


def cold_ms(calls, iters=None):
    """``time_ms`` of ``calls`` taken in turn, each on its own copy of the
    inputs, so that a call finds its data evicted from the 50 MB L2 by
    the others (the caller makes enough copies)."""
    state = {"i": 0}

    def run():
        calls[state["i"] % len(calls)]()
        state["i"] += 1
    return time_ms(run, iters or max(20, 2 * len(calls)))


def check_paged(dev, *, kv_dtype, T, bs, b=8, h=24, kvh=8, d=128,
                dense_view=False, cap=1024, seed=3, edges=False):
    """The paged kernel against the plain version at (b, T, h / kvh, d)
    over a fragmented pool of block size ``bs`` (or the dense-cache view,
    one block of ``cap`` a sequence).  A padded tail in sequence 0 and an
    idle last slot (position -1); with ``edges`` also a sequence whose
    only key is position 0 and two at full capacity.  The kernel must
    repeat bitwise and write exact zeros for padding rows; the planted
    faults include the split kernel's own ("one split dropped",
    "combine rescale dropped") at the split the wrapper picks.  ``ms``
    replays the same call (its K/V then sit in L2), ``ms_cold`` cycles
    through copies of the pools, more than 64 MB of touched K/V between
    two uses of one copy, as a serving tick finds each layer's pool."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_chunk_attention import (
        paged_chunk_attention, paged_chunk_attention_ref)
    from repro_torch.kernels.build import sm_count
    from repro_torch.kernels.paged_chunk_attention.kernel import (
        paged_chunk_attention_fwd, split_plan)
    from repro_torch.models.attention import KV_DTYPES, bits, quantize_kv
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    # per-sequence query positions: a chunk of T ending inside 64..cap
    ends = rng.integers(max(64, T), cap, b)
    pos = np.stack([np.arange(e - T + 1, e + 1) for e in ends])
    pos[0, -min(T, 4):] = -1                  # padding rows -> exact zeros
    if b > 1:
        pos[-1, :] = -1                       # an idle slot
    if edges:
        pos[1] = np.maximum(np.arange(1 - T, 1), -1)   # only key: 0
        pos[2] = pos[3] = np.arange(cap - T, cap)        # full capacity
    if dense_view:
        bs, nbmax, nb = cap, 1, b
        tables = np.arange(b, dtype=np.int32)[:, None]
    else:
        nbmax = cap // bs
        nb = b * nbmax + 1
        tables = (rng.permutation(nb - 1)[:b * nbmax] + 1).reshape(
            b, nbmax).astype(np.int32)        # fragmented, block 0 scratch
    kf = torch.randn(nb, bs, kvh, d, device=dev, generator=g)
    vf = torch.randn(nb, bs, kvh, d, device=dev, generator=g)
    kp, ks = quantize_kv(kf, KV_DTYPES[kv_dtype])
    vp, vs = quantize_kv(vf, KV_DTYPES[kv_dtype])
    if kv_dtype == "bfloat16":
        ks = vs = None
    del kf, vf
    q = torch.randn(b, T, h, d, device=dev, generator=g).bfloat16()
    bt = torch.as_tensor(tables, device=dev)
    ps = torch.as_tensor(pos.astype(np.int32), device=dev)
    args = (q, kp, vp, bt, ps, ks, vs)
    got = paged_chunk_attention(*args)
    o1, o2 = paged_chunk_attention_fwd(*args), paged_chunk_attention_fwd(*args)
    bitwise = bool(torch.equal(got, o1) and torch.equal(o1, o2))
    del o1, o2
    ref = paged_chunk_attention_ref(*args)
    err, used, ok = compare("paged_chunk_attention", got, ref)
    # planted faults: each sequence's last key tile (the one holding its
    # largest position) skipped; each row's own key masked; for fp8 /
    # int8 pools, the scales ignored; the split kernel's combine one
    # split short, and without its rescale
    last = (ps.max(dim=1, keepdim=True).values // KEY_TILE) * KEY_TILE
    faulty = {"last key tile dropped": paged_chunk_attention_ref(
        q, kp, vp, bt, torch.where(ps >= 0, torch.minimum(ps, last - 1), ps),
        ks, vs),
        "own key masked": paged_chunk_attention_ref(
            q, kp, vp, bt, torch.where(ps >= 0, ps - 1, ps), ks, vs)}
    if ks is not None:
        faulty["scales ignored"] = paged_chunk_attention_ref(q, kp, vp, bt,
                                                             ps)
    S = tables.shape[1] * bs
    n_split, split_keys = split_plan(S, bs, b, kvh, T * (h // kvh),
                                     sm_count(dev))
    if n_split > 1:
        for fault in ("one split dropped", "combine rescale dropped"):
            faulty[fault] = split_combine(*args, split_keys=split_keys,
                                          fault=fault)
    ctl = controls("paged_chunk_attention", got, faulty)
    del faulty
    pad = ps < 0
    zeros_ok = bool(torch.all(got[pad] == 0))
    # library yardstick: SDPA on K/V gathered and dequantized beforehand
    kg = bits(kp)[bt.long()].view(kp.dtype).reshape(b, S, kvh, d).float()
    vg = bits(vp)[bt.long()].view(vp.dtype).reshape(b, S, kvh, d).float()
    if ks is not None:
        kg = kg * ks[bt.long()].reshape(b, S)[:, :, None, None]
        vg = vg * vs[bt.long()].reshape(b, S)[:, :, None, None]
    grp = h // kvh
    kg = kg.bfloat16().transpose(1, 2).repeat_interleave(grp, 1).contiguous()
    vg = vg.bfloat16().transpose(1, 2).repeat_interleave(grp, 1).contiguous()
    qg = q.transpose(1, 2).contiguous()
    mask = (torch.arange(S, device=dev)[None, None, None, :]
            <= ps[:, None, :, None])
    lib = lambda: F.scaled_dot_product_attention(qg, kg, vg,  # noqa: E731
                                                 attn_mask=mask)
    # what this input needs: q of the rows at a position >= 0, o of every
    # row, each sequence's keys (and their table entries) up to its
    # largest query position, once; every valid (row, key) pair for the
    # products
    elt = kp.element_size()
    need = np.minimum(np.maximum(pos.max(axis=1) + 1, 0), S)
    rows = int((pos >= 0).sum())
    kv_bytes = int(need.sum()) * kvh * d * elt * 2
    nbytes = ((rows + b * T) * h * d * 2 + kv_bytes
              + (int(need.sum()) * 4 * 2 if ks is not None else 0)
              + int((-(-need // bs)).sum()) * 4 + ps.numel() * 4)
    pairs = int(np.where(pos >= 0, np.minimum(pos + 1, S), 0).sum()) * h
    b_ms, b_by = bound(nbytes, 4 * d * pairs, "bf16_tensor")
    op_host, wrapper_host = host_ms_pair(
        lambda: paged_chunk_attention(*args),
        lambda: paged_chunk_attention_fwd(*args))
    ms = time_ms(lambda: paged_chunk_attention(*args))
    # cold: copies of the pools, > 64 MB of touched K/V between two uses
    copies = [args] + [
        (q, kp.clone(), vp.clone(), bt, ps,
         None if ks is None else ks.clone(),
         None if vs is None else vs.clone())
        for _ in range(max(1, -(-COLD_BYTES // max(kv_bytes, 1))))]
    ms_cold = cold_ms([lambda a=a: paged_chunk_attention(*a) for a in copies])
    del copies
    view = f"dense-view S={cap}" if dense_view else f"bs={bs},S={S}"
    res = {"case": f"{view},T={T},b={b},{kv_dtype},fragmented="
                   f"{not dense_view},h={h},kvh={kvh},d={d}"
                   + (",edges" if edges else ""),
           "split": {"n_split": n_split, "split_keys": split_keys},
           "max_abs_err": err, "tol_used": used,
           "ok": ok and zeros_ok and bitwise, "bitwise_repeat": bitwise,
           "padding_rows_zero": zeros_ok, "controls": ctl,
           "ms": ms, "ms_cold": ms_cold,
           "bound_share": b_ms / ms, "cold_bound_share": b_ms / ms_cold,
           "host_ms": op_host, "host_ms_wrapper": wrapper_host,
           "plain_ms": time_ms(lambda: paged_chunk_attention_ref(*args), 5),
           "library_ms": time_ms(lib), "bound_ms": b_ms, "bound_by": b_by}
    return res


# the fused rmsnorm backward's dw combine (rmsnorm_bwd.cu): lane k of
# COMBINE_LANES adds the partials k, k + COMBINE_LANES, ... in block
# order, then the lanes are added in order
COMBINE_LANES = 32
# the training path's planted fault "dw without its last row block":
# the last 64 rows of each rmsnorm backward call left out of dw
DW_FAULT_ROWS = 64
DX_RING_FAULT = "dx's dot taken from the previous row of the block's ring"
DW_PART_FAULT = "one block's dw partial left out of the fixed-order sum"


def dx_ring(x, w, dy, rstd, rows, fault=None):
    """dx (n, d) fp32 as the fused rmsnorm backward computes it, row by
    row in the plan's blocks (``rows``: (start, stop) per block): with
    g = dy * w, r * g - x * r^3 * sum(g * x) / d.  Fault DX_RING_FAULT:
    each row takes the dot of the row before it in its block, and a
    block's first row 0 (its ring slot has no predecessor)."""
    import torch
    xf, r = x.float(), rstd[:, None]
    g = dy.float() * w.float()
    dot = (g * xf).sum(dim=-1)
    if fault == DX_RING_FAULT:
        prev = torch.zeros_like(dot)
        for lo, hi in rows:
            prev[lo + 1:hi] = dot[lo:hi - 1]
        dot = prev
    elif fault is not None:
        raise ValueError(fault)
    return r * g - xf * (r * r * r) * (dot[:, None] / x.shape[-1])


def dw_blocked(x, dy, rstd, rows, fault=None):
    """dw (d,) fp32 as the fused rmsnorm backward adds it: one fp32
    partial of dy * x * r per plan block (``rows``), the partials added
    in the combine's fixed order (COMBINE_LANES).  Fault DW_PART_FAULT:
    the middle block's partial left out."""
    import torch
    t = dy.float() * x.float() * rstd[:, None]
    parts = [t[lo:hi].sum(dim=0) for lo, hi in rows]
    if fault == DW_PART_FAULT:
        parts[len(parts) // 2] = torch.zeros_like(parts[0])
    elif fault is not None:
        raise ValueError(fault)
    dw = torch.zeros(x.shape[-1], dtype=torch.float32, device=x.device)
    for k in range(COMBINE_LANES):
        lane = torch.zeros_like(dw)
        for p in parts[k::COMBINE_LANES]:
            lane = lane + p
        dw = dw + lane
    return dw


def both(dx_rec, dw_rec):
    """One record for the fused backward's two outputs: the larger error
    and tolerance share, ok if both are, every planted fault of each."""
    return {"max_abs_err": max(dx_rec["max_abs_err"], dw_rec["max_abs_err"]),
            "tol_used": max(dx_rec["tol_used"], dw_rec["tol_used"]),
            "ok": dx_rec["ok"] and dw_rec["ok"],
            "controls": dx_rec["controls"] + dw_rec["controls"]}


def check_rmsnorm_bwd(dev, n, d):
    """The fused backward kernel (dx and dw in one launch) against the
    plain functions on the same x, w, dy and rstd: dx within
    TOL["rmsnorm_bwd_dx"], dw within TOL["rmsnorm_bwd_dw"], two launches
    bitwise equal.  Faults: dx without its projection term, dx's dot
    from the previous row of the block's ring; dw without its last row
    block (the plan's last block), one block's dw partial left out of
    the fixed-order sum.  Then the training path's hand-off: the forward
    kernel's y and rstd against the plain forward's (fault: the mean
    over all columns but the last), and the chain forward kernel ->
    fused backward from its own rstd against plain forward -> plain
    backward.  Timed warm (``ms``) and cold (``ms_cold``: each call on
    its own copy of x, dy and rstd, > 64 MB of them between two uses)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import (rmsnorm_bwd_dw_ref,
                                             rmsnorm_bwd_dx_ref,
                                             rmsnorm_fwd_ref)
    from repro_torch.kernels.build import sm_count
    from repro_torch.kernels.rmsnorm.kernel import (bwd_plan, rmsnorm_bwd,
                                                    rmsnorm_fwd)
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(n, d, device=dev, generator=g).bfloat16()
    w = (1 + 0.1 * torch.randn(d, device=dev, generator=g)).bfloat16()
    dy = torch.randn(n, d, device=dev, generator=g).bfloat16()
    plan = bwd_plan(n, d, x.element_size(), sm_count(dev))
    y, rstd = rmsnorm_fwd_ref(x, w)
    dx, dw = rmsnorm_bwd(x, w, dy, rstd)
    dx2, dw2 = rmsnorm_bwd(x, w, dy, rstd)
    bitwise = bool(torch.equal(dx, dx2) and torch.equal(dw, dw2))
    dx_ref = rmsnorm_bwd_dx_ref(x, w, dy, rstd)
    dw_ref = rmsnorm_bwd_dw_ref(x, dy, rstd)
    yk, rstd_k = rmsnorm_fwd(x, w, save_rstd=True)
    residual = {"rstd": checked("rmsnorm_rstd", rstd_k, rstd, {
        "last column dropped": torch.rsqrt(
            x[:, :-1].float().square().mean(-1) + 1e-6)}),
        "y": checked("rmsnorm", yk, y)}
    cdx, cdw = rmsnorm_bwd(x, w, dy, rstd_k)
    chained = {"dx": checked("rmsnorm_bwd_dx", cdx, dx_ref),
               "dw": checked("rmsnorm_bwd_dw", cdw, dw_ref)}
    keep = plan.rows[-1][0]
    outputs = {
        "dx": checked("rmsnorm_bwd_dx", dx, dx_ref, {
            "projection term dropped": dy.float() * w.float() * rstd[:, None],
            DX_RING_FAULT: dx_ring(x, w, dy, rstd, plan.rows, DX_RING_FAULT)}),
        "dw": checked("rmsnorm_bwd_dw", dw, dw_ref, {
            "last row block dropped": rmsnorm_bwd_dw_ref(
                x[:keep], dy[:keep], rstd[:keep]),
            DW_PART_FAULT: dw_blocked(x, dy, rstd, plan.rows, DW_PART_FAULT)})}
    row = both(outputs["dx"], outputs["dw"])
    # cold: copies of x, dy and rstd, > COLD_BYTES of them between two uses
    copies = [(x.clone(), dy.clone(), rstd.clone()) for _ in range(
        min(1024, COLD_BYTES // (2 * n * d * x.element_size()) + 2))]
    ms_cold = cold_ms([lambda c=c: rmsnorm_bwd(c[0], w, c[1], c[2])
                       for c in copies])
    del copies
    # library yardstick: autograd of F.rms_norm, dx and dw in one call
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    lib_ms = backward_ms(lambda: F.rms_norm(xl, (d,), wl, 1e-6), (xl, wl),
                         dy)
    fn = lambda: rmsnorm_bwd(x, w, dy, rstd)         # noqa: E731
    ms = time_ms(fn)
    # the pair's bytes: x, dy read and dx written once, w, rstd and dw
    b_ms, b_by = bound(3 * n * d * 2 + d * 2 + n * 4 + d * 4, 11 * n * d,
                       "fp32")
    return {"rmsnorm_bwd": {
        "case": f"n={n},d={d},bf16", **row,
        "ok": row["ok"] and bitwise, "bitwise_repeat": bitwise,
        "outputs": outputs, "residual": residual, "chained": both(
            chained["dx"], chained["dw"]),
        "plan": {"blocks": plan.blocks, "threads": plan.threads,
                 "stages": plan.stages, "slices": plan.slices},
        "ms": ms, "ms_cold": ms_cold, "host_ms": host_ms(fn),
        "plain_ms": time_ms(lambda: (rmsnorm_bwd_dx_ref(x, w, dy, rstd),
                                     rmsnorm_bwd_dw_ref(x, dy, rstd))),
        "plain_covers": "dx and dw together",
        "library_ms": lib_ms,
        "library_covers": "dx and dw together (autograd of F.rms_norm)",
        "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms}}


def causal_pairs(sq, skv, q_offset, kv_len, causal=True):
    """(query, key) pairs a causal / kv_len mask keeps, per head."""
    import numpy as np
    qpos = q_offset + np.arange(sq)
    lim = np.minimum(qpos + 1, kv_len) if causal else \
        np.full(sq, min(kv_len, skv))
    return int(np.clip(lim, 0, skv).sum())


def stage_skipped(q, k, v, do, lse, delta, kw):
    """The plain dK, dV with one stage of the dK/dV kernel's ring lost:
    query head 0's middle 64-row tile contributes nothing (its dO and
    delta zeroed, so its P^T dO and dS^T Q terms vanish)."""
    from repro_torch.kernels.flash_attention import attention_bwd_ref
    sq = q.shape[2]
    lo = (sq // KEY_TILE) // 2 * KEY_TILE
    do_f, delta_f = do.clone(), delta.clone()
    do_f[:, 0, lo:lo + KEY_TILE] = 0
    delta_f[:, 0, lo:lo + KEY_TILE] = 0
    return attention_bwd_ref(q, k, v, do_f, lse, delta_f, **kw)[1:]


def key_tile_skipped(q, k, v, do, lse, delta, rq, kw):
    """The plain dQ with one of the dQ kernel's key tiles lost: the middle
    64-key tile below kv_len contributes nothing (``rq`` minus its
    dS K term, with P and dS as the plain backward forms them)."""
    import torch
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    kv_end = min(skv if kw["kv_len"] is None else kw["kv_len"], skv)
    lo = (kv_end // KEY_TILE) // 2 * KEY_TILE
    hi = min(lo + KEY_TILE, kv_end)
    group, scale = h // kvh, d ** -0.5
    kt = k[:, :, lo:hi].float().repeat_interleave(group, dim=1)
    vt = v[:, :, lo:hi].float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kt) * scale
    qpos = kw["q_offset"] + torch.arange(sq, device=q.device)
    kpos = torch.arange(lo, hi, device=q.device)
    valid = (kpos[None, :] <= qpos[:, None]) | (not kw["causal"])
    p = torch.where(valid, torch.exp(s - lse[..., None]),
                    torch.zeros_like(s))
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), vt)
    ds = p * (dp - delta[..., None]) * scale
    return (rq - torch.einsum("bhqk,bhkd->bhqd", ds, kt),)


def check_flash_bwd(dev, *, b, sq, skv, h=24, kvh=8, d=128, q_offset=None,
                    kv_len=None, causal=True):
    """dK/dV and dQ kernels against the plain backward on the same q, k,
    v, dO, lse and delta (lse and delta from the plain forward), in the
    model's (b, s, h, d) memory layout, causal or not (``causal=False``:
    Whisper's encoder and cross-attention).  Faults: delta dropped, the
    last (partial) key tile dropped, (dK/dV) the GQA sum over one head
    only and one ring stage skipped (one query head's middle 64-row tile:
    its dO and delta zeroed), (dQ) one middle key tile skipped, and, on a
    non-causal case, a causal mask applied (q_offset 0, as
    ``attention_core`` passes it).  Two launches on the
    same inputs must agree bitwise, and keys at or past kv_len must get
    dK = dV = 0 exactly.  Then the training path's hand-off: the forward
    kernel's o and lse against the plain forward's (fault: the last key
    tile dropped), and the chain forward kernel -> dK/dV and dQ kernels
    from its own o and lse against plain forward -> plain backward."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     attention_fwd_ref)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd)
    q_offset = skv - sq if q_offset is None else q_offset
    kv_len = skv if kv_len is None else kv_len
    g = torch.Generator(device=dev).manual_seed(6)
    bf = torch.bfloat16

    def t(s, heads):
        return torch.randn(b, s, heads, d, device=dev,
                           generator=g).to(bf).transpose(1, 2)
    q, k, v, do = t(sq, h), t(skv, kvh), t(skv, kvh), t(sq, h)
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    o, lse = attention_fwd_ref(q, k, v, **kw)
    delta = (o.float() * do.float()).sum(-1).contiguous()
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    again = (flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
             + (flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw),))
    bitwise = all(torch.equal(x, y) for x, y in zip((dk, dv, dq), again))
    del again
    kv_end = min(kv_len, skv)
    zero_past = bool((dk[:, :, kv_end:] == 0).all()
                     and (dv[:, :, kv_end:] == 0).all())
    rq, rk, rv = attention_bwd_ref(q, k, v, do, lse, delta, **kw)
    last = (min(kv_len, skv) - 1) // KEY_TILE * KEY_TILE
    o_k, lse_k = flash_attention_fwd(q, k, v, save_lse=True, **kw)
    residual = {"lse": checked("flash_attention_lse", lse_k, lse, {
        "last key tile dropped": attention_fwd_ref(
            q, k, v, causal=causal, q_offset=q_offset, kv_len=last)[1]}),
        "o": checked("flash_attention", o_k, o)}
    delta_k = (o_k.float() * do.float()).sum(-1).contiguous()
    chain = (flash_attention_bwd_dkv(q, k, v, do, lse_k, delta_k, **kw)
             + (flash_attention_bwd_dq(q, k, v, do, lse_k, delta_k, **kw),))
    del o_k, delta_k
    # planted faults
    f_delta = attention_bwd_ref(q, k, v, do, lse, torch.zeros_like(delta),
                                **kw)
    f_tile = attention_bwd_ref(q, k, v, do, lse, delta, causal=causal,
                               q_offset=q_offset, kv_len=last)
    dkv_faults = {"delta dropped": f_delta[1:],
                  "last key tile dropped": f_tile[1:],
                  "one ring stage skipped": stage_skipped(
                      q, k, v, do, lse, delta, kw)}
    dq_faults = {"delta dropped": f_delta[:1],
                 "last key tile dropped": f_tile[:1],
                 "one key tile skipped": key_tile_skipped(
                     q, k, v, do, lse, delta, rq, kw)}
    if not causal:
        f_causal = attention_bwd_ref(q, k, v, do, lse, delta, causal=True,
                                     q_offset=0, kv_len=kv_len)
        dkv_faults["causal mask applied"] = f_causal[1:]
        dq_faults["causal mask applied"] = f_causal[:1]
    if h > kvh:
        one = torch.zeros(h, device=dev, dtype=bf)
        one[::h // kvh] = 1
        dkv_faults["GQA sum over one head"] = attention_bwd_ref(
            q, k, v, do * one[None, :, None, None], lse,
            delta * one[None, :, None].float(), **kw)[1:]

    def both(name, pair, refs):
        (e1, u1, ok1), (e2, u2, ok2) = (compare(name, a, r)
                                        for a, r in zip(pair, refs))
        return max(e1, e2), max(u1, u2), ok1 and ok2

    def ctl(name, pair, faults):
        out = []
        for fault, refs in faults.items():
            err, used, ok = both(name, pair, refs)
            out.append({"fault": fault, "max_abs_err": err,
                        "tol_used": used, "caught": not ok})
        return out

    # library yardstick: SDPA's backward for q, k, v (one call for all
    # three), on the same tensors with the same mask
    ql, kl, vl = (x.detach().clone().requires_grad_() for x in (q, k, v))
    if not causal and kv_len == skv:
        def lib_fwd():
            return F.scaled_dot_product_attention(ql, kl, vl,
                                                  enable_gqa=True)
    elif sq == skv and kv_len == skv and q_offset == 0:
        def lib_fwd():
            return F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                                  enable_gqa=True)
    else:
        qpos = q_offset + torch.arange(sq, device=dev)
        kpos = torch.arange(skv, device=dev)
        mask = ((kpos[None, :] <= qpos[:, None]) | (not causal)) & \
            (kpos[None, :] < kv_len)

        def lib_fwd():
            return F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask,
                                                  enable_gqa=True)
    lib_ms = backward_ms(lib_fwd, (ql, kl, vl), do)
    plain_ms = time_ms(lambda: attention_bwd_ref(q, k, v, do, lse, delta,
                                                 **kw), 3)
    pairs = b * h * causal_pairs(sq, skv, q_offset, kv_len, causal)
    qb, kb = b * h * sq * d * 2, b * kvh * min(skv, kv_len) * d * 2
    rows_b = b * h * sq * 4 * 2                      # lse and delta
    case = (f"b={b},sq={sq},skv={skv},q_offset={q_offset},kv_len={kv_len},"
            f"h={h},kvh={kvh},d={d}" + ("" if causal else ",non-causal"))
    out = {}
    for name, pair, refs, faults, fn, nbytes, ops in (
            ("flash_attention_bwd_dkv", (dk, dv), (rk, rv), dkv_faults,
             lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw),
             2 * qb + 2 * kb + rows_b + 2 * b * kvh * skv * d * 2,
             8 * d * pairs),
            ("flash_attention_bwd_dq", (dq,), (rq,), dq_faults,
             lambda: flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw),
             3 * qb + 2 * kb + rows_b, 6 * d * pairs)):
        if len(pair) == 1:
            err, used, ok = compare(name, pair[0], refs[0])
            faults_out = [{"fault": f, "max_abs_err": e, "tol_used": u,
                           "caught": not c} for f, (e, u, c) in
                          ((f, compare(name, pair[0], r[0]))
                           for f, r in faults.items())]
        else:
            err, used, ok = both(name, pair, refs)
            faults_out = ctl(name, pair, faults)
        b_ms, b_by = bound(nbytes, ops, "bf16_tensor")
        chained = [checked(name, a, r) for a, r in zip(
            chain[:2] if len(pair) == 2 else chain[2:], refs)]
        out[name] = {"case": case, "max_abs_err": err, "tol_used": used,
                     "ok": ok and bitwise and zero_past,
                     "bitwise_repeat": bitwise,
                     "zero_past_kv_len": zero_past, "controls": faults_out,
                     "residual": residual, "chained": {
                         "max_abs_err": max(c["max_abs_err"]
                                            for c in chained),
                         "tol_used": max(c["tol_used"] for c in chained),
                         "ok": all(c["ok"] for c in chained)},
                     "ms": time_ms(fn),
                     "host_ms": host_ms(fn), "plain_ms": plain_ms,
                     "plain_covers": "dq, dk and dv together",
                     "library_ms": lib_ms,
                     "library_covers": "dq, dk and dv together",
                     "bound_ms": b_ms, "bound_by": b_by}
    return out


def backward_kernel_phase(dev):
    """The three backward kernels, each against its plain functions: the
    training step's shapes first (rmsnorm 4096 x 3072, flash b 2 x 2048
    causal), then a decode-sized rmsnorm and ragged flash cases, then
    zamba2-1.2b's training shapes (rmsnorm over d_inner 4096 and d 2048,
    flash with 32 heads of 64, no grouping), then the flash kernels'
    edges: lengths that are not multiples of their 64 / 128-row tiles
    (129, 200, 1000), GQA groups of 1, 3 and 4, head dims 64 and 128,
    q_offset > 0 and kv_len < skv with whole key tiles past kv_len; last,
    whisper-base's training shapes, non-causal: the encoder (1 500 x
    1 500) and cross-attention (448 x 1 500), d 64, b 8."""
    cases = {n: [] for n in ("rmsnorm_bwd", "flash_attention_bwd_dkv",
                             "flash_attention_bwd_dq")}
    for n, d in ((4096, 3072), (8, 3072), (4096, 4096), (4096, 2048)):
        for name, row in check_rmsnorm_bwd(dev, n, d).items():
            cases[name].append(row)
    for kw in (dict(b=2, sq=2048, skv=2048),
               dict(b=1, sq=1000, skv=1000),
               dict(b=1, sq=448, skv=512, q_offset=64, kv_len=480),
               dict(b=1, sq=512, skv=512, d=64),
               dict(b=2, sq=2048, skv=2048, h=32, kvh=32, d=64),
               dict(b=2, sq=129, skv=129, h=12, kvh=4, d=64),
               dict(b=2, sq=200, skv=200, h=8, kvh=2, d=128),
               dict(b=2, sq=1000, skv=1000, h=16, kvh=4, d=64),
               dict(b=2, sq=200, skv=1000, h=8, kvh=8, d=128, q_offset=700,
                    kv_len=777),
               # whisper-base's training step, non-causal: the encoder,
               # and cross-attention from its decoder rows
               dict(b=WHISPER_TRAIN[0], sq=WHISPER_FRAMES,
                    skv=WHISPER_FRAMES, h=8, kvh=8, d=64, causal=False),
               dict(b=WHISPER_TRAIN[0], sq=WHISPER_TRAIN[1],
                    skv=WHISPER_FRAMES, h=8, kvh=8, d=64, causal=False)):
        for name, row in check_flash_bwd(dev, **kw).items():
            cases[name].append(row)
    return cases


def kernel_phase(dev):
    """The forward kernels at phi4-mini-3.8b's shapes, then at
    zamba2-1.2b's (the gated rmsnorm over d_inner 4096 and the pre-norms
    over d 2048; the shared block's attention, 32 heads of 64 without
    grouping: fresh prefill, decode tick, prefill chunk, and a 256-token
    continuation chunk against the dense-cache view); the flash
    forward at both training steps' shapes (b 2 x 2048); last, its
    non-causal path at whisper-base's shapes (b 8: the encoder over 1 500
    frames, cross-attention from 448 rows and from 1)."""
    cases = {"rmsnorm": [], "flash_attention": [],
             "paged_chunk_attention": []}
    # the decode tick, the training step (with rstd), then fp32, rows
    # 3075 elements apart (2-byte loads) and a d that is not a multiple of 8
    rm = cases["rmsnorm"]
    rm.append(check_rmsnorm(dev, 8, 3072))
    rm.append(check_rmsnorm(dev, 4096, 3072, save_rstd=True))
    rm.append(check_rmsnorm(dev, 4096, 3072, "float32", save_rstd=True))
    rm.append(check_rmsnorm(dev, 4096, 3072, stride=3075))
    rm.append(check_rmsnorm(dev, 4096, 2500))
    for sq in (512, 2048):
        for kv_len in (sq, sq - sq // 8):
            cases["flash_attention"].append(check_flash(dev, sq, kv_len))
    pc = cases["paged_chunk_attention"]
    for kv_dtype in ("bfloat16", "float8_e4m3", "int8"):
        for T in (1, 16):
            pc.append(check_paged(dev, kv_dtype=kv_dtype, T=T, bs=16))
    for T, b in ((1, 8), (16, 8), (256, 1)):
        pc.append(check_paged(dev, kv_dtype="bfloat16", T=T, bs=0, b=b,
                              dense_view=True))
    # several splits an item (b 8 at S 4096), and the edges: a sequence
    # whose only key is position 0, two at full capacity, an idle one
    for kv_dtype, T in (("bfloat16", 1), ("bfloat16", 16), ("int8", 1)):
        pc.append(check_paged(dev, kv_dtype=kv_dtype, T=T, bs=16, cap=4096))
    pc.append(check_paged(dev, kv_dtype="bfloat16", T=16, bs=16, edges=True))
    pc.append(check_paged(dev, kv_dtype="float8_e4m3", T=1, bs=16, cap=4096,
                          edges=True))
    # the speculative verify window (T = SPEC_K + 1), and the self-draft
    # model's dense cache (one block of SPEC_DRAFT_MAX_LEN a sequence)
    pc.append(check_paged(dev, kv_dtype="bfloat16", T=SPEC_K + 1, bs=16))
    pc.append(check_paged(dev, kv_dtype="bfloat16", T=1, bs=0, b=8,
                          dense_view=True, cap=SPEC_DRAFT_MAX_LEN))
    hd64 = dict(h=32, kvh=32, d=64)
    for d in (4096, 2048):
        rm.append(check_rmsnorm(dev, 4096, d, save_rstd=True))
    for sq in (512, 2048):
        cases["flash_attention"].append(check_flash(dev, sq, sq, **hd64))
    # the training steps' shapes: phi4-mini-3.8b's and zamba2-1.2b's
    for kw in (dict(h=24, kvh=8, d=128), hd64):
        cases["flash_attention"].append(check_flash(dev, 2048, 2048, b=2,
                                                    sdpa_gqa=True, **kw))
    for T in (1, 16):
        pc.append(check_paged(dev, kv_dtype="bfloat16", T=T, bs=16, **hd64))
    pc.append(check_paged(dev, kv_dtype="bfloat16", T=256, bs=0, b=1,
                          dense_view=True, **hd64))
    pc.append(check_paged(dev, kv_dtype="bfloat16", T=1, bs=16, cap=4096,
                          edges=True, **hd64))
    # whisper-base's non-causal attention (8 heads of 64): the encoder
    # over WHISPER_FRAMES frames, cross-attention from the training
    # step's decoder rows and from a decode tick's one row
    for sq in (WHISPER_FRAMES, WHISPER_TRAIN[1], 1):
        cases["flash_attention"].append(check_flash(
            dev, sq, b=FAM_REQUESTS, skv=WHISPER_FRAMES, causal=False,
            h=8, kvh=8, d=64))
    return cases


# ------------------------------ top-k gating --------------------------------


def _gating_bwd_faulty(logits, experts, dw, renorm, fault):
    """The plain top-k gating backward with one planted fault: "renorm
    Jacobian dropped" (dwr = dw / S), "c term dropped" or "scattered to
    index + 1" (dp lands on the next expert)."""
    import torch
    p = torch.softmax(logits.float(), dim=-1)
    idx = experts.long()
    wr = torch.gather(p, -1, idx)
    S = torch.clamp(wr.sum(-1, keepdim=True), min=1e-9)
    if not renorm:
        dwr = dw
    elif fault == "renorm Jacobian dropped":
        dwr = dw / S
    else:
        dwr = (dw - (dw * wr / S).sum(-1, keepdim=True)) / S
    if fault == "scattered to index + 1":
        idx = (idx + 1) % p.shape[-1]
    dp = torch.zeros_like(p).scatter_add_(-1, idx, dwr)
    c = 0.0 if fault == "c term dropped" else \
        (dwr * wr).sum(-1, keepdim=True)
    return (p * (dp - c)).to(logits.dtype)


def _gating_library(x, k, renorm=True):
    """The nearest PyTorch composition: softmax -> topk -> divide."""
    import torch
    w, i = torch.topk(torch.softmax(x, dim=-1), k)
    return (w / w.sum(-1, keepdim=True) if renorm else w), i


# the top-k gating kernels' lane groups (topk_gating.cu), emulated in plain
# torch by ``gating_lane_groups`` (forward) and ``gating_bwd_lane_groups``
# (backward): their planted faults
GATE_LANE_FAULT = "the row's last lane ignored"
GATE_BWD_LANE_FAULT = "a pick's dw taken from the neighbouring lane"


def _lane_sum(acc):
    """The kernels' xor butterfly over a row's group of lanes: acc (T,
    lanes) -> (T,), lane j adding lane j ^ off for off = lanes / 2 .. 1
    (every lane ends with the same bits: lane 0's)."""
    import torch
    lanes = acc.shape[1]
    j = torch.arange(lanes, device=acc.device)
    off = lanes // 2
    while off:
        acc = acc + acc[:, j ^ off]
        off //= 2
    return acc[:, 0]


def _lane_softmax(xf, plan):
    """(p, live) as both gating kernels compute p over a row's lane group
    under ``plan``: xf (T, lanes * slots) fp32 holds expert e in column e,
    -inf where no logit is (live False); lane j holds experts j, j +
    lanes, ...; the row max, exp and the sum (each lane its slots in
    order, then ``_lane_sum``), a divide; p 0 where not live."""
    import torch
    T = xf.shape[0]
    live = xf > float("-inf")
    ex = torch.where(live, torch.exp(xf - xf.amax(dim=-1, keepdim=True)),
                     0.0)
    by_slot = ex.view(T, plan.slots, plan.lanes)   # [t, s, j]: j + lanes s
    acc = by_slot[:, 0]
    for s in range(1, plan.slots):
        acc = acc + by_slot[:, s]
    return torch.where(live, ex / _lane_sum(acc)[:, None], 0.0), live


def _padded_logits(x, plan):
    import torch
    T, E = x.shape
    xf = torch.full((T, plan.lanes * plan.slots), float("-inf"),
                    device=x.device)
    xf[:, :E] = x.float()
    return xf


def gating_lane_groups(x, k, renorm, plan, fault=None):
    """(weights (T, k) fp32, experts (T, k) int32) as the top-k gating
    forward kernel computes them under ``plan``
    (``kernels.topk_gating.kernel.gating_plan``): lane j of a row's group
    of ``plan.lanes`` holds experts j, j + lanes, ... in ``plan.slots``
    slots, -inf past E; p by ``_lane_softmax``; then k rounds
    of the largest remaining p, the lower index first among equals, each
    pick set to NEG_INF; the picks renormalised by max(their sum in round
    order, 1e-9).  Fault GATE_LANE_FAULT: the group's last lane left out
    of the row (its logits in neither the max, the sum nor a pick)."""
    import torch
    from repro_torch.kernels.topk_gating.ref import NEG_INF
    lanes = plan.lanes
    xf = _padded_logits(x, plan)
    if fault == GATE_LANE_FAULT:
        col = torch.arange(xf.shape[1], device=x.device)
        xf[:, col % lanes == lanes - 1] = float("-inf")
    elif fault is not None:
        raise ValueError(fault)
    p, live = _lane_softmax(xf, plan)
    p = torch.where(live, p, float("-inf"))
    ws, picks = [], []
    for _ in range(k):
        wj, ij = p.max(dim=-1)              # the first maximal index
        ws.append(wj)
        picks.append(ij)
        p = p.scatter(-1, ij[:, None], NEG_INF)
    w = torch.stack(ws, dim=-1)
    if renorm:
        wsum = ws[0]
        for v in ws[1:]:
            wsum = wsum + v
        w = w / torch.clamp(wsum, min=1e-9)[:, None]
    return w, torch.stack(picks, dim=-1).to(torch.int32)


def gating_bwd_lane_groups(x, experts, dw, k, renorm, plan, fault=None):
    """dlogits (T, E) in x's dtype as the top-k gating backward kernel
    computes it under ``plan`` (``gating_plan(..., backward=True)``, or
    any plan of the forward's lane groups): p by
    ``_lane_softmax``; lane j < k holds pick j (expert, dw, and wr =
    p[expert], 0 for an expert outside [0, E)), lanes >= k hold 0; each
    sum over the picks a ``_lane_sum``: with renorm S = max(sum wr,
    1e-9), dot = sum(dw (wr / S)), dwr = (dw - dot) / S, c = sum(dwr
    wr), without it dwr = dw and c = sum(dw wr); dp[e] the sum of dwr
    over the picks of e in pick order; dlogits = p (dp - c).  Fault
    GATE_BWD_LANE_FAULT: lane j takes lane j + 1's dw (the last pick's
    lane reads a lane with no pick: 0)."""
    import torch
    T, E = x.shape
    lanes = plan.lanes
    p, _ = _lane_softmax(_padded_logits(x, plan), plan)
    p = p[:, :E]
    pick = experts.long()
    valid = (pick >= 0) & (pick < E)
    g = dw.float()
    if fault == GATE_BWD_LANE_FAULT:
        g = torch.cat([g[:, 1:], torch.zeros_like(g[:, :1])], dim=-1)
    elif fault is not None:
        raise ValueError(fault)
    wr = torch.where(valid, torch.gather(p, -1, pick.clamp(0, E - 1)), 0.0)

    def pick_sum(v):                        # (T, k) -> (T, 1)
        lane = torch.zeros(T, lanes, device=x.device)
        lane[:, :k] = v
        return _lane_sum(lane)[:, None]
    if renorm:
        S = torch.clamp(pick_sum(wr), min=1e-9)
        dwr = (g - pick_sum(g * (wr / S))) / S
    else:
        dwr = g
    c = pick_sum(dwr * wr)
    dp = torch.zeros(T, E + 1, device=x.device).scatter_add_(
        -1, torch.where(valid, pick, E), dwr)[:, :E]
    return (p * (dp - c)).to(x.dtype)


def gating_verdict(w, e, ref_w, ref_e):
    """Experts identical and weights within TOL["topk_gating"]."""
    err, used, ok = compare("topk_gating", w, ref_w)
    mism = int((e != ref_e).any(dim=-1).sum())
    return {"max_abs_err": err, "tol_used": used,
            "experts_mismatch_rows": mism, "ok": ok and mism == 0}


def check_gating(dev, T, E, k, renorm=True, ties=0, seed=7,
                 dtype="float32"):
    """Forward and backward kernel against their plain versions on logits
    (T, E) of ``dtype``: experts identical, weights within 1e-6, dlogits
    within TOL["topk_gating_bwd"] (bf16: TOL["topk_gating_bwd_bf16"]) of
    the plain backward and of autograd through the plain forward.
    ``ties`` > 0 makes that many rows all-equal (and the next all-zero):
    their experts must be 0..k-1.  Planted faults, where the input can
    show them: forward renorm skipped, ties broken to the higher index
    (tie case), the last expert column ignored, and the forward kernel's
    lane groups with the row's last lane ignored (``gating_lane_groups``);
    backward renorm Jacobian dropped, the c term dropped (renorm=False
    only: with renorm, c = sum(dwr * wr) = 0 in exact arithmetic),
    dlogits scattered to index + 1, and the backward kernel's lane groups
    with a pick's dw taken from the neighbouring lane
    (``gating_bwd_lane_groups``).  Both kernels must repeat bitwise.  Host
    time: the forward through the op as serving calls it and through the
    wrapper, in turn, least of five each; the backward through its
    wrapper, least of five.  The backward is also timed cold (``ms_cold``:
    each call on its own copy of the inputs, > 64 MB of them between two
    uses) beside a device copy of the same bytes, warm and cold, and run
    under the forward's lane groups too (``forward_layout``: within the
    gate, timed beside its own plan)."""
    import torch
    from repro_torch.kernels.topk_gating import (topk_gating,
                                                 topk_gating_bwd_ref,
                                                 topk_gating_fwd_ref,
                                                 topk_gating_ref)
    from repro_torch.kernels.build import sm_count
    from repro_torch.kernels.topk_gating.kernel import (gating_plan,
                                                        topk_gating_bwd,
                                                        topk_gating_fwd)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(T, E, device=dev, generator=g) * 2
    if ties:
        x[:ties] = 0.7
        x[ties] = 0.0
    x = x.to(getattr(torch, dtype))
    dw = torch.randn(T, k, device=dev, generator=g)
    fwd_plan = gating_plan(T, E, sm_count(dev))
    w, e = topk_gating(x, k=k, renorm=renorm)
    w2, e2 = topk_gating(x, k=k, renorm=renorm)
    rw, re = topk_gating_fwd_ref(x, k, renorm)
    fwd = gating_verdict(w, e, rw, re)
    fwd["bitwise_repeat"] = bool(torch.equal(w, w2) and torch.equal(e, e2))
    fwd["ok"] = fwd["ok"] and fwd["bitwise_repeat"]
    fwd["oracle"] = gating_verdict(w, e, *topk_gating_ref(x, k, renorm))
    if ties:
        want = torch.arange(k, device=dev, dtype=torch.int32)
        fwd["tie_rows_ok"] = bool((e[:ties + 1] == want).all())
        fwd["ok"] = fwd["ok"] and fwd["tie_rows_ok"]
    faults = {"last expert column ignored": topk_gating_fwd_ref(
        x[:, :-1].contiguous(), k, renorm)}
    if renorm:
        faults["renorm skipped"] = topk_gating_fwd_ref(x, k, False)
    if ties:
        # flipping the expert axis makes the first maximal index the
        # highest original one
        fw, fe = topk_gating_fwd_ref(x.flip(-1).contiguous(), k, renorm)
        faults["ties broken to the higher index"] = (fw, E - 1 - fe)
    # the lane-group fault, where this input can show it (a pick or a
    # weight of some row changes)
    lane_fault = gating_lane_groups(x, k, renorm, fwd_plan, GATE_LANE_FAULT)
    if gating_verdict(*lane_fault, rw, re)["ok"]:
        fwd["not_shown"] = [GATE_LANE_FAULT]
    else:
        faults[GATE_LANE_FAULT] = lane_fault
    fwd["controls"] = [{"fault": f, **gating_verdict(w, e, *r)}
                       for f, r in faults.items()]
    for c in fwd["controls"]:
        c["caught"] = not c.pop("ok")

    tol = "topk_gating_bwd" + ("_bf16" if dtype == "bfloat16" else "")
    dl = topk_gating_bwd(x, e, dw, k, renorm)
    dl2 = topk_gating_bwd(x, e, dw, k, renorm)
    ref = topk_gating_bwd_ref(x, e, dw, k, renorm)
    err, used, ok = compare(tol, dl, ref)
    xr = x.clone().requires_grad_()
    auto = torch.autograd.grad(topk_gating_ref(xr, k, renorm)[0], xr, dw)[0]
    a_err, a_used, a_ok = compare(tol, dl, auto)
    bitwise = bool(torch.equal(dl, dl2))
    plan = gating_plan(T, E, backward=True)
    bfaults = {f: _gating_bwd_faulty(x, e, dw, renorm, f) for f in (
        ["scattered to index + 1"] +
        (["renorm Jacobian dropped"] if renorm else ["c term dropped"]))}
    bwd = {"max_abs_err": err, "tol_used": used,
           "ok": ok and a_ok and bitwise, "bitwise_repeat": bitwise,
           "vs_autograd": {"max_abs_err": a_err, "tol_used": a_used,
                           "ok": a_ok},
           "plan": plan._asdict()}
    # the backward's lane-group fault, where this input can show it
    lane_fault = gating_bwd_lane_groups(x, e, dw, k, renorm, plan,
                                        GATE_BWD_LANE_FAULT)
    if compare(tol, lane_fault, ref)[2]:
        bwd["not_shown"] = [GATE_BWD_LANE_FAULT]
    else:
        bfaults[GATE_BWD_LANE_FAULT] = lane_fault
    bwd["controls"] = controls(tol, dl, bfaults)
    # bounds: the inputs read, the outputs written, once each (the
    # forward's bytes are also the backward's input bytes)
    es = x.element_size()
    f_bytes = T * E * es + T * k * 8
    b_bytes = f_bytes + T * E * es
    case = f"T={T},E={E},k={k},renorm={renorm}" + (
        f",ties={ties}" if ties else "") + (
        ",bf16" if dtype == "bfloat16" else "")
    xl = x.clone().requires_grad_()
    fwd["host_ms"], fwd["host_ms_wrapper"] = host_ms_pair(
        lambda: topk_gating(x, k=k, renorm=renorm),
        lambda: topk_gating_fwd(x, k, renorm))
    bwd_fn = lambda: topk_gating_bwd(x, e, dw, k, renorm)  # noqa: E731
    bwd["host_ms"] = bwd["host_ms_wrapper"] = min(
        host_ms(bwd_fn) for _ in range(5))
    # cold: copies of the backward's inputs, > COLD_BYTES of them between
    # two uses; yardstick: a device copy that moves the same bytes (half
    # of them read, half written), warm and cold
    copies = [(x.clone(), e.clone(), dw.clone()) for _ in range(
        min(1024, COLD_BYTES // f_bytes + 2))]
    bwd["ms_cold"] = cold_ms([
        lambda c=c: topk_gating_bwd(*c, k, renorm) for c in copies])
    del copies
    half = -(-b_bytes // 8)
    srcs = [torch.randn(half, device=dev) for _ in range(
        min(1024, COLD_BYTES // (4 * half) + 2))]
    bwd["copy_ms"] = time_ms(lambda: torch.empty_like(srcs[0]).copy_(srcs[0]))
    bwd["copy_ms_cold"] = cold_ms([
        lambda c=c: torch.empty_like(c).copy_(c) for c in srcs])
    del srcs
    for rec, fn, plain, lib, (b_ms, b_by) in (
            (fwd, lambda: topk_gating(x, k=k, renorm=renorm),
             lambda: topk_gating_fwd_ref(x, k, renorm),
             lambda: _gating_library(x, k, renorm),
             bound(f_bytes, T * E * (4 + 2 * k), "fp32")),
            (bwd, bwd_fn,
             lambda: topk_gating_bwd_ref(x, e, dw, k, renorm), None,
             bound(b_bytes, T * E * (6 + k), "fp32"))):
        rec.update({"case": case, "ms": time_ms(fn),
                    "plain_ms": time_ms(plain),
                    "library_ms": (time_ms(lib) if lib else backward_ms(
                        lambda: _gating_library(xl, k, renorm)[0], (xl,),
                        dw)),
                    "library_covers": (
                        "torch.softmax -> torch.topk -> divide: no one "
                        "PyTorch call computes this function" if lib else
                        "autograd of torch.softmax -> torch.topk -> "
                        "divide"),
                    "bound_ms": b_ms, "bound_by": b_by})
    bwd["bound_share"] = bwd["bound_ms"] / bwd["ms"]
    bwd["bound_share_cold"] = bwd["bound_ms"] / bwd["ms_cold"]
    # the backward kernel under the forward's lane groups (16 lanes a row
    # at T 4096), the layout its plan passes over: within the gate, and
    # its time beside the plan's
    fwd_layout = _gating_bwd_in_layout(x, e, dw, k, renorm)
    bwd["forward_layout"] = {
        "plan": fwd_plan._asdict(),
        "ok": compare(tol, fwd_layout(), ref)[2], "ms": time_ms(fwd_layout)}
    bwd["ok"] = bwd["ok"] and bwd["forward_layout"]["ok"]
    return {"topk_gating": fwd, "topk_gating_bwd": bwd}


def _gating_bwd_in_layout(x, e, dw, k, renorm):
    """A call of the top-k gating backward kernel under the forward's
    launch descriptor (its plan's lane groups) in place of the
    backward's own."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.topk_gating import kernel
    T, E = x.shape
    config = kernel._fwd_config(T, E, k, renorm, kernel._DTYPES[x.dtype],
                                build.sm_count(x.device))[0]

    def call():
        out = torch.empty_like(x)
        build.check(build.launch(
            kernel._fn("topk_gating_bwd"), x.device.index, x.data_ptr(),
            e.data_ptr(), dw.data_ptr(), out.data_ptr(), config),
            "topk_gating_bwd (forward layout)")
        return out
    return call


# the first forward case is the decode tick, the first backward case the
# training step (the rows the kernel summary reports)
GATING_CASES = [dict(T=8, E=60, k=4), dict(T=4096, E=60, k=4),
                dict(T=1024, E=60, k=4), dict(T=4096, E=64, k=6),
                dict(T=4096, E=128, k=8),
                dict(T=4096, E=60, k=4, renorm=False),
                dict(T=1024, E=60, k=4, ties=3),
                dict(T=4096, E=60, k=4, dtype="bfloat16")]


def gating_phase(dev):
    """Both top-k gating kernels at the MoE path's shapes: qwen2-moe's
    training step (4096 x 60, top-4), decode tick (8 rows) and prefill
    bucket (1024), deepseekmoe-16b's (64 experts, top-6) and qwen3-moe's
    (128, top-8) gating, one case without renorm, one with tie rows and
    the training step on bf16 logits."""
    cases = {"topk_gating": [], "topk_gating_bwd": []}
    for kw in GATING_CASES:
        for name, row in check_gating(dev, **kw).items():
            cases[name].append(row)
    cases["topk_gating_bwd"].insert(0, cases["topk_gating_bwd"].pop(1))
    return cases


# ------------------------------ SSD chunk scan -------------------------------


def ssd_inputs(dev, b, l, h, c, dtype, p=64, n=64, seed=8):
    """x, a, B, C, dy and dL/dh_final on the card.  a is drawn in
    [-2/c, 0], so the state carried across a chunk keeps at least e^-2
    of itself: a dropped carry or an ignored dh_final shows (under the
    model's init, a ~ -1.9 per step, no state survives a chunk)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, l, h, p, device=dev, generator=g).to(dtype)
    a = -torch.rand(b, l, h, device=dev, generator=g) * (2.0 / c)
    B = (torch.randn(b, l, n, device=dev, generator=g) / n ** 0.5).to(dtype)
    C = (torch.randn(b, l, n, device=dev, generator=g) / n ** 0.5).to(dtype)
    dy = torch.randn(b, l, h, p, device=dev, generator=g).to(dtype)
    dhf = torch.randn(b, h, p, n, device=dev, generator=g)
    return x, a, B, C, dy, dhf


def ssd_verdict(outs, refs, faulty):
    """Each output against its plain version: max |difference| over max
    |plain| within SSD_REL_TOL of the output's dtype.  ``faulty`` {fault:
    {output: plain version with the fault}}: each fault must fail the
    gate on one of its outputs (``caught``)."""
    import torch

    def rel(name, got, ref):
        tol = SSD_REL_TOL["fp32" if got.dtype == torch.float32 else "bf16"]
        g, r = got.float(), ref.float()
        err = float((g - r).abs().max())
        used = err / max(float(r.abs().max()), 1e-30) / tol
        return err, used, used <= 1 and bool(torch.isfinite(g).all())

    rows = {k: rel(k, v, refs[k]) for k, v in outs.items()}
    ctl = []
    for fault, frefs in faulty.items():
        res = [rel(k, outs[k], r) for k, r in frefs.items()]
        ctl.append({"fault": fault,
                    "max_abs_err": max(e for e, _, _ in res),
                    "tol_used": max(u for _, u, _ in res),
                    "caught": not all(ok for _, _, ok in res)})
    return {"max_abs_err": max(e for e, _, _ in rows.values()),
            "tol_used": max(u for _, u, _ in rows.values()),
            "ok": all(ok for _, _, ok in rows.values()),
            "outputs": {k: {"max_abs_err": e, "tol_used": u}
                        for k, (e, u, _) in rows.items()},
            "controls": ctl}


def ssd_fwd_faults(x, a, B, C, c, ry):
    """Plain forwards with a planted fault: the diagonal of L masked out
    (y without its s = l term, (C_l . B_l) x_l), and, over several chunks,
    the carried state dropped between chunks (each chunk from zero)."""
    from repro_torch.kernels.ssd_scan import ssd_fwd_ref
    diag = (C.float() * B.float()).sum(-1)[:, :, None, None] * x.float()
    out = {"diagonal of L masked out": {"y": (ry.float() - diag).to(ry.dtype)}}
    b, l = x.shape[:2]
    if l > c:
        per = [t.reshape(b * (l // c), c, *t.shape[2:]) for t in (x, a, B, C)]
        out["carried state dropped between chunks"] = {
            "y": ssd_fwd_ref(*per, c)[0].reshape(x.shape)}
    return out


def ssd_da_shifted(da, c):
    """da's reverse cumsum shifted by one row: sum over u > t within the
    chunk instead of u >= t."""
    import torch
    b, l, h = da.shape
    d = da.reshape(b, l // c, c, h)
    return torch.cat([d[:, :, 1:], torch.zeros_like(d[:, :, :1])],
                     2).reshape(b, l, h)


# planted faults of the SSD backward: the outputs each one shows in
SSD_BWD_FAULTS = {"dh_final ignored": ("dx", "da", "dB", "dC"),
                  "da's reverse cumsum shifted by one row": ("da",),
                  "dB summed over half the heads": ("dB",)}


def ssd_faulty_bwd(fault, x, a, B, C, hprev, dy, dhfin, chunk):
    """The plain SSD backward (dx, da, dB, dC), with ``fault`` (a key of
    SSD_BWD_FAULTS) planted when given; "dB summed over half the heads"
    takes dB from a backward whose odd heads' dy and dh_final are 0."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_bwd_ref
    if fault == "dh_final ignored":
        dhfin = torch.zeros_like(dhfin)
    dx, da, dB, dC = ssd_bwd_ref(x, a, B, C, hprev, dy, dhfin, chunk)
    if fault == "da's reverse cumsum shifted by one row":
        da = ssd_da_shifted(da, chunk)
    elif fault == "dB summed over half the heads":
        even = torch.arange(dy.shape[2], device=dy.device) % 2 == 0
        dB = ssd_bwd_ref(x, a, B, C, hprev, dy * even[:, None].to(dy.dtype),
                         dhfin * even[:, None, None], chunk)[2]
    return dx, da, dB, dC


def ssd_bwd_faults(x, a, B, C, hprev, dy, dhf, c):
    """{fault: {output: plain backward with the fault}} over
    SSD_BWD_FAULTS, each on the outputs it shows in."""
    names = ("dx", "da", "dB", "dC")
    out = {}
    for fault, shows in SSD_BWD_FAULTS.items():
        got = dict(zip(names, ssd_faulty_bwd(fault, x, a, B, C, hprev, dy,
                                             dhf, c)))
        out[fault] = {k: got[k] for k in shows}
    return out


def ssd_work(b, l, h, c, p=64, n=64, fp32_peak="fp32_tensor"):
    """Multiply-adds the SSD scan needs, (forward, backward), each as
    {peak: count}.  C B^T (the causal pairs times n) is shared by all
    heads (B and C have one group), so it counts once per (batch, chunk);
    the rest counts per (batch, head, chunk).  Products of two bf16
    inputs (C B^T, and backward dy x^T: the pairs times p) are priced at
    the bf16 tensor-core rate, the products with an fp32 operand (L, the
    carried state) at ``fp32_peak``: the tensor cores' rate for them
    (two bf16 products or TF32; "fp32": the CUDA cores', the bound of
    the first port's kernels): forward, the pairs times p (the weighted
    sum of x) plus 2 c p n (the carried state's two terms); backward,
    the pairs times 2 n + p (dx, dB, dC) plus 4 c p n (the carried
    state's four terms)."""
    pairs = c * (c + 1) // 2
    chunks = b * (l // c)
    cb = chunks * pairs * n
    return ({"bf16_tensor": cb,
             fp32_peak: chunks * h * (pairs * p + 2 * c * p * n)},
            {"bf16_tensor": cb + chunks * h * pairs * p,
             fp32_peak: chunks * h * (pairs * (2 * n + p) + 4 * c * p * n)})


# planted faults of the Hopper kernels' design, emulated in plain torch
SSD_FOLD_FAULT = "state fold off by one chunk"
SSD_LO_FAULT = "fp32 operand rounded to bf16 (lo half dropped)"
# bf16 terms of an fp32 operand (ssd_scan.cu: SPLIT_PARTS)
SSD_SPLIT_PARTS = 2


def _split(v, fault=None):
    """An fp32 operand as the Hopper kernels feed it to bf16 wgmma: the
    sum of SSD_SPLIT_PARTS bf16 terms, bf16(v), then bf16 of what is
    left (SSD_LO_FAULT: rounded to bf16, the lo term dropped)."""
    import torch
    out, rest = torch.zeros_like(v), v
    for _ in range(1 if fault == SSD_LO_FAULT else SSD_SPLIT_PARTS):
        term = rest.to(torch.bfloat16).float()
        out, rest = out + term, rest - term
    return out


def _ssd_chunks(x, a, B, C, chunk):
    """fp32 views by chunk: x (b, nc, c, h, p), B and C (b, nc, c, n),
    cum = cumsum(a) within each chunk (b, nc, c, h), T = cum at the
    chunk's last row (b, nc, h), and L[l, s] = exp(cum_l - cum_s) for
    l >= s, else 0 (b, nc, l, s, h)."""
    import torch
    b, l, h, p = x.shape
    nc = l // chunk
    xf = x.float().reshape(b, nc, chunk, h, p)
    Bf = B.float().reshape(b, nc, chunk, -1)
    Cf = C.float().reshape(b, nc, chunk, -1)
    cum = torch.cumsum(a.float().reshape(b, nc, chunk, h), dim=2)
    tril = torch.ones(chunk, chunk, dtype=torch.bool,
                      device=x.device).tril()[..., None]
    L = torch.where(tril, torch.exp(cum[:, :, :, None] - cum[:, :, None]),
                    0.0)
    return xf, Bf, Cf, cum, cum[:, :, -1], L


def ssd_blocked_fwd(x, a, B, C, chunk, fault=None):
    """The forward as the Hopper kernels compute it, in plain torch with
    fp32 sums: each chunk's local state from its rows weighted by
    exp(T - cum_s), split into SSD_SPLIT_PARTS bf16 terms, against B;
    h_prev folded across the chunks in chunk order; y = split((C B^T) o
    L) x + exp(cum) C split(h_prev)^T.  SSD_FOLD_FAULT: the fold starts
    one chunk late (chunk 0's state never enters); SSD_LO_FAULT: every
    split keeps its first term only.  -> (y in x.dtype, h_final, h_prev)
    as ``ssd_scan_fwd``."""
    import torch
    xf, Bf, Cf, cum, T, L = _ssd_chunks(x, a, B, C, chunk)
    b, nc = xf.shape[:2]
    w = torch.exp(T[:, :, None] - cum)[..., None]
    S = torch.einsum("bkshp,bksn->bkhpn", _split(w * xf, fault), Bf)
    hprev = torch.zeros_like(S)
    state = torch.zeros_like(S[:, 0])
    for k in range(nc):
        hprev[:, k] = state
        if not (fault == SSD_FOLD_FAULT and k == 0):
            state = torch.exp(T[:, k])[..., None, None] * state + S[:, k]
    P = _split(torch.einsum("bkln,bksn->bkls", Cf, Bf)[..., None] * L, fault)
    y = (torch.exp(cum)[..., None]
         * torch.einsum("bkln,bkhpn->bklhp", Cf, _split(hprev, fault))
         + torch.einsum("bklsh,bkshp->bklhp", P, xf))
    return y.reshape(x.shape).to(x.dtype), state, hprev


def ssd_blocked_bwd(x, a, B, C, hprev, dy, dhfin, chunk, group, fault=None):
    """The backward as the Hopper kernels compute it, in plain torch with
    fp32 sums: each chunk's local state gradient from dy weighted by
    exp(cum_l), split, against C; dh folded from dh_final through the
    later chunks in reverse; per head the products with P, L o G, h_prev
    and dh split into SSD_SPLIT_PARTS bf16 terms (hi + lo); dB and dC
    summed over the heads of each group of ``group`` in head order, the
    groups added in order.  SSD_FOLD_FAULT: the reverse fold starts one
    chunk late (the last chunk's gradient never enters); SSD_LO_FAULT:
    every split drops its lo half.  -> (dx, da, dB, dC) as
    ``ssd_scan_bwd``."""
    import torch
    xf, Bf, Cf, cum, T, L = _ssd_chunks(x, a, B, C, chunk)
    b, nc, c, h, p = xf.shape
    dyf = dy.float().reshape(xf.shape)
    ecum = torch.exp(cum)
    D = torch.einsum("bklhp,bkln->bkhpn", _split(ecum[..., None] * dyf,
                                                 fault), Cf)
    dh = torch.zeros_like(D)
    state = dhfin.float()
    for k in reversed(range(nc)):
        dh[:, k] = state
        if k > 0 and not (fault == SSD_FOLD_FAULT and k == nc - 1):
            state = torch.exp(T[:, k])[..., None, None] * state + D[:, k]
    hin, dhs = _split(hprev.float(), fault), _split(dh, fault)
    G = torch.einsum("bklhp,bkshp->bklsh", dyf, xf)
    SL = torch.einsum("bkln,bksn->bkls", Cf, Bf)[..., None] * L
    LG = L * G
    SLG = SL * G
    dx = torch.einsum("bklsh,bklhp->bkshp", _split(SL, fault), dyf)
    LGs = _split(LG, fault)
    dC = torch.einsum("bklsh,bksn->bklhn", LGs, Bf)
    dB = torch.einsum("bklsh,bkln->bkshn", LGs, Cf)
    hC = torch.einsum("bklhp,bkhpn->bklhn", dyf, hin)
    dC = dC + ecum[..., None] * hC
    dcum = (SLG.sum(3) - SLG.sum(2)
            + ecum * torch.einsum("bklhn,bkln->bklh", hC, Cf))
    de = torch.exp(T[:, :, None] - cum)
    Bdh = torch.einsum("bksn,bkhpn->bkshp", Bf, dhs)
    dx = dx + de[..., None] * Bdh
    dB = dB + de[..., None] * torch.einsum("bkshp,bkhpn->bkshn", xf, dhs)
    dde = (xf * Bdh).sum(-1)
    dcum = dcum - de * dde
    dcum[:, :, -1] += ((de * dde).sum(2) + torch.exp(T) * torch.einsum(
        "bkhpn,bkhpn->bkh", hprev.float(), dh))
    da = dcum.flip(2).cumsum(2).flip(2)

    def grouped(t):                     # (b, nc, c, h, n) -> (b, l, n)
        parts = []
        for g0 in range(0, h, group):
            part = t[:, :, :, g0]
            for j in range(g0 + 1, min(h, g0 + group)):
                part = part + t[:, :, :, j]
            parts.append(part)
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        return total.reshape(b, nc * c, -1)
    return (dx.reshape(x.shape).to(x.dtype), da.reshape(a.shape).to(a.dtype),
            grouped(dB).to(B.dtype), grouped(dC).to(C.dtype))


def ssd_design_faults(x, a, B, C, hprev, dy, dhf, c, group, outs):
    """The planted faults of the Hopper kernels' design ({fault: {output:
    emulated output}}), forward and backward: SSD_FOLD_FAULT (over
    several chunks) and SSD_LO_FAULT, each on every output it has among
    ``outs`` (the forward's)."""
    fwd, bwd = {}, {}
    for fault in (SSD_FOLD_FAULT, SSD_LO_FAULT):
        if fault == SSD_FOLD_FAULT and x.shape[1] <= c:
            continue
        y, hf, hp = ssd_blocked_fwd(x, a, B, C, c, fault)
        fwd[fault] = {k: v for k, v in (("y", y), ("h_final", hf),
                                        ("h_prev", hp)) if k in outs}
        bwd[fault] = dict(zip(("dx", "da", "dB", "dC"), ssd_blocked_bwd(
            x, a, B, C, hprev, dy, dhf, c, group, fault)))
    return fwd, bwd


def check_ssd(dev, b, l, h, c, dtype="bfloat16", train=False):
    """Forward and backward kernel against their plain functions on the
    same inputs: y, h_final and (over several chunks) h_prev; dx, da, dB,
    dC from the plain forward's h_prev, and chained from the kernel
    forward's own h_prev.  Each kernel twice on the same inputs must
    agree bitwise.  Planted faults as in ``ssd_fwd_faults`` /
    ``ssd_bwd_faults`` and, for the bf16 (Hopper) kernels, those of
    their design (``ssd_design_faults``).  The bf16 forward that saves
    h_prev (training) is the Hopper kernels; without it (serving) the
    CUDA-core kernel, whose y and h_final are held too ("serving"
    outputs).  The forward is timed as its caller runs it: saving h_prev
    for training, not for a prefill (then the Hopper forward at the same
    shape beside it, ``ms_hopper``); warm (``ms``, the same inputs again,
    in L2 where they fit) and cold (``ms_cold``, each call on its own
    copy, > COLD_BYTES between two uses).  The bound prices the products
    with an fp32 operand at the tensor cores' rate for them
    (``bound_ms``) and, as the first port's CUDA-core kernels were held,
    at the fp32 CUDA-core rate (``bound_ms_cuda_cores``)."""
    import torch
    from repro_torch.kernels.build import sm_count
    from repro_torch.kernels.ssd_scan import (ssd_bwd_ref, ssd_fwd_ref,
                                              ssd_scan)
    from repro_torch.kernels.ssd_scan.kernel import (scan_plan, ssd_scan_bwd,
                                                     ssd_scan_fwd)
    dt = getattr(torch, dtype)
    x, a, B, C, dy, dhf = ssd_inputs(dev, b, l, h, c, dt)
    y, hfin, hprev = ssd_scan_fwd(x, a, B, C, chunk=c, save_hprev=True)
    sy, sh = ssd_scan_fwd(x, a, B, C, chunk=c)         # serving
    again = (*ssd_scan_fwd(x, a, B, C, chunk=c, save_hprev=True),
             *ssd_scan_fwd(x, a, B, C, chunk=c))
    fwd_bitwise = all(torch.equal(u, v) for u, v in zip(
        (y, hfin, hprev, sy, sh), again))
    del again
    ry, rh, rhp = ssd_fwd_ref(x, a, B, C, c)
    outs = {"y": y, "h_final": hfin, "y serving": sy, "h_final serving": sh}
    refs = {"y": ry, "h_final": rh, "h_prev": rhp, "y serving": ry,
            "h_final serving": rh}
    if l > c:
        outs["h_prev"] = hprev
    plan = scan_plan(b, l, h, c, sm_count(dev))
    design_f, design_b = ({}, {}) if dt != torch.bfloat16 else \
        ssd_design_faults(x, a, B, C, rhp, dy, dhf, c, plan.group, outs)
    fwd = ssd_verdict(outs, refs, {**ssd_fwd_faults(x, a, B, C, c, ry),
                                   **design_f})
    names = ("dx", "da", "dB", "dC")
    rg = dict(zip(names, ssd_bwd_ref(x, a, B, C, rhp, dy, dhf, c)))
    got = ssd_scan_bwd(x, a, B, C, rhp, dy, dhf, chunk=c)
    bwd_bitwise = all(torch.equal(u, v) for u, v in zip(
        got, ssd_scan_bwd(x, a, B, C, rhp, dy, dhf, chunk=c)))
    bwd = ssd_verdict(dict(zip(names, got)), rg,
                      {**ssd_bwd_faults(x, a, B, C, rhp, dy, dhf, c),
                       **design_b})
    bwd["chained"] = ssd_verdict(
        dict(zip(names, ssd_scan_bwd(x, a, B, C, hprev, dy, dhf, chunk=c))),
        rg, {})
    del y, hfin, hprev, sy, sh, got, design_f, design_b
    es = x.element_size()
    f_bytes = ((2 * x.numel() + B.numel() + C.numel()) * es + a.numel() * 4
               + rh.numel() * 4 + (rhp.numel() * 4 if train else 0))
    b_bytes = ((3 * x.numel() + 2 * (B.numel() + C.numel())) * es
               + 2 * a.numel() * 4 + (rhp.numel() + dhf.numel()) * 4)
    bounds = {}
    for label, peak in (("", "fp32_tensor"), ("_cuda_cores", "fp32")):
        for kind, nbytes, work in zip(("fwd", "bwd"), (f_bytes, b_bytes),
                                      ssd_work(b, l, h, c, fp32_peak=peak)):
            bounds[kind, label] = bound(nbytes,
                                        {k: 2 * v for k, v in work.items()})
    case = f"b={b},l={l},h={h},p=64,n=64,c={c},{dtype}" + (
        ",saves h_prev (training)" if train else "")
    none = "none: no single PyTorch call computes an SSD chunk scan"
    plan_row = ({"group": plan.group, "blocks": plan.blocks,
                 "state_blocks": plan.state_blocks, "tiles": plan.tiles}
                if dt == torch.bfloat16 else
                "fp32: the CUDA-core kernels, one block per (batch, head)")
    cold = max(2, COLD_BYTES // (x.numel() * es) + 2)
    copies = [(x.clone(), a.clone(), B.clone(), C.clone(), dy.clone(),
               rhp.clone()) for _ in range(cold)]

    def timed(kind, fn, cold_fn, plain):
        ms = time_ms(fn)
        b_ms, b_by = bounds[kind, ""]
        c_ms, c_by = bounds[kind, "_cuda_cores"]
        return {"case": case, "plan": plan_row, "ms": ms,
                "ms_cold": cold_ms([lambda t=t: cold_fn(*t) for t in copies]),
                "host_ms": host_ms(fn), "plain_ms": time_ms(plain, 3),
                "library_ms": None, "library_covers": none,
                "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
                "bound_ms_cuda_cores": c_ms, "bound_by_cuda_cores": c_by,
                "bound_share_cuda_cores": c_ms / ms}

    op_host, wrapper_host = host_ms_pair(
        lambda: ssd_scan(x, a, B, C, chunk=c),
        lambda: ssd_scan_fwd(x, a, B, C, chunk=c, save_hprev=train))
    fwd.update(timed(
        "fwd", lambda: ssd_scan_fwd(x, a, B, C, chunk=c, save_hprev=train),
        lambda xc, ac, Bc, Cc, dyc, hc: ssd_scan_fwd(xc, ac, Bc, Cc, chunk=c,
                                                     save_hprev=train),
        lambda: ssd_fwd_ref(x, a, B, C, c)))
    fwd.update({"host_ms": op_host, "host_ms_wrapper": wrapper_host,
                "bitwise_repeat": fwd_bitwise,
                "ok": fwd["ok"] and fwd_bitwise,
                "forward": ("hopper" if train and dt == torch.bfloat16 else
                            "cuda cores")})
    if not train and dt == torch.bfloat16:
        fwd["ms_hopper"] = time_ms(
            lambda: ssd_scan_fwd(x, a, B, C, chunk=c, save_hprev=True))
        fwd["ms_cold_hopper"] = cold_ms([
            lambda t=t: ssd_scan_fwd(*t[:4], chunk=c, save_hprev=True)
            for t in copies])
    bwd.update(timed(
        "bwd", lambda: ssd_scan_bwd(x, a, B, C, rhp, dy, dhf, chunk=c),
        lambda xc, ac, Bc, Cc, dyc, hc: ssd_scan_bwd(xc, ac, Bc, Cc, hc, dyc,
                                                     dhf, chunk=c),
        lambda: ssd_bwd_ref(x, a, B, C, rhp, dy, dhf, c)))
    bwd.update({"bitwise_repeat": bwd_bitwise,
                "ok": bwd["ok"] and bwd_bitwise})
    del copies
    return {"ssd_scan": fwd, "ssd_scan_bwd": bwd}


def check_ssd_padded(dev, l=777, c=256, h=64):
    """A prompt length that is not a chunk multiple, through ``ops.
    ssd_scan`` (which pads to 1024 with zero x, a, B, C): y, h_final and
    the gradients of sum(y * dy) + sum(h_final * dh) through the SSDScan
    Function (both kernels) against autograd of the plain chunked scan
    on the same inputs padded by hand."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.ssm_common import ssd_chunked
    x, a, B, C, dy, dhf = ssd_inputs(dev, 1, l, h, c, torch.bfloat16)
    l_p = -(-l // c) * c

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in (x, a, B, C)]
        y, hf = fn(*leaves)
        loss = (y.float() * dy.float()).sum() + (hf * dhf).sum()
        return {"y": y.detach(), "h_final": hf.detach(),
                **dict(zip(("dx", "da", "dB", "dC"),
                           torch.autograd.grad(loss, leaves)))}

    def plain(*t):
        padded = [F.pad(v, [0, 0] * (v.dim() - 2) + [0, l_p - l]) for v in t]
        y, hf = ssd_chunked(*padded, c)
        return y[:, :l], hf

    got, ref = run(lambda *t: ssd_scan(*t, chunk=c)), run(plain)
    case = f"b=1,l={l} (padded to {l_p}),h={h},p=64,n=64,c={c},bfloat16"
    fwd = ssd_verdict({k: got[k] for k in ("y", "h_final")}, ref, {})
    bwd = ssd_verdict({k: got[k] for k in ("dx", "da", "dB", "dC")}, ref, {})
    return {"ssd_scan": {"case": case, **fwd},
            "ssd_scan_bwd": {"case": case, "reference": "autograd of the "
                             "plain chunked scan", **bwd}}


# the first case of each kernel is the training step (the row the kernel
# summary reports), then whole-prompt prefills of zamba2's serving trace
SSD_CASES = [dict(b=2, l=2048, h=64, c=256, train=True),
             dict(b=1, l=1024, h=64, c=256), dict(b=1, l=200, h=64, c=200),
             dict(b=1, l=768, h=64, c=256),
             dict(b=1, l=512, h=64, c=256, dtype="float32")]


def ssd_phase(dev):
    """Both SSD chunk-scan kernels at zamba2-1.2b's shapes (64 heads of
    64, state 64): the training step (b 2 x 2048), prefills of 1024 (4
    chunks), 200 (one chunk of 200) and 768 (the head of a 777-token
    prompt), one fp32 case, and a 777-token prompt through the padding
    wrapper."""
    cases = {"ssd_scan": [], "ssd_scan_bwd": []}
    for kw in SSD_CASES:
        for name, row in check_ssd(dev, **kw).items():
            cases[name].append(row)
    for name, row in check_ssd_padded(dev).items():
        cases[name].append(row)
    return cases


# ------------------------------- end to end ---------------------------------


# the profiled serving run (``profiled``) takes the trace's first 4
# requests: the profiler's processing costs ~30-40 s for the whole trace
# (PERF.md §6)
PROFILE_REQUESTS = 4


def request_set(vocab, seed=SEED):
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = [64, 1024, 200, 512, 96, 777, 333, 640]
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in lens]
    arrivals = [0, 0, 1, 3, 5, 8, 12, 16]
    return prompts, arrivals


def e2e_run(model, params, prompts, arrivals, dev, prefill_chunk, gen=32,
            kernels=DENSE_SERVING_KERNELS):
    """One serving run of the trace with the launch counters zeroed
    before and read after; fails if a kernel of ``kernels`` never
    launched."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import serve_paged
    n_blocks = 2 * sum(-(-(len(p) + gen) // 16) for p in prompts) + 1
    torch.cuda.synchronize()
    reset_launch_counts()
    res = serve_paged(model, params, prompts, gen, arrivals=arrivals,
                      device=dev, n_blocks=n_blocks, block_size=16,
                      max_slots=8, prefill_chunk=prefill_chunk)
    torch.cuda.synchronize()
    counts = launch_counts()
    eng = res["engine"]
    steps = eng.step_count
    m = eng.request_metrics()
    n_tok = sum(len(t) for t in res["tokens"])
    out = {"prefill_chunk": prefill_chunk, "requests": len(prompts),
           "new_tokens_each": gen, "launches": counts,
           "launches_per_step": {k: v / steps for k, v in counts.items()},
           "seconds": res["seconds"], "tokens_per_s": n_tok / res["seconds"],
           "ttft_p50_s": m["ttft"]["p50_s"], "ttft_p95_s": m["ttft"]["p95_s"],
           "tpot_p50_s": m["tpot"]["p50_s"], "tpot_p95_s": m["tpot"]["p95_s"],
           "engine_steps": steps,
           "evictions": eng.evictions}
    if any(len(t) != gen for t in res["tokens"]):
        raise AssertionError(f"wrong token counts: "
                             f"{[len(t) for t in res['tokens']]}")
    dead = [k for k in kernels if counts[k] <= 0]
    if dead:
        raise AssertionError(f"kernels never launched on the serving path "
                             f"(prefill_chunk={prefill_chunk}): {dead}")
    return out, res["tokens"]


def cat_batch(trees):
    """Per-sequence state trees (batch 1 each) joined along the batch."""
    import torch
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: cat_batch([t[k] for t in trees]) for k in t0}
    if isinstance(t0, list):
        return [cat_batch([t[i] for t in trees]) for i in range(len(t0))]
    return torch.cat(trees, 0)


def teacher_forced(model, params, prompts, forced, dev, n_ticks=4, bs=16,
                   prefill_chunk=0):
    """First-token logits (fresh or chunked prefill) and ``n_ticks``
    decode ticks fed ``forced`` tokens through a fragmented paged pool;
    returns fp32 logits (1 + n_ticks, b, V).  Prefill follows the
    engine: attention-only families pad to a power-of-two bucket, the
    hybrid runs exact-length chunks and its mamba states ride into the
    decode ticks beside the pool."""
    import numpy as np
    import torch
    from repro_torch.serving.paged_cache import PagedKVCache
    cfg = model.cfg
    b = len(prompts)
    lens = [len(p) for p in prompts]
    need = [-(-(n + n_ticks) // bs) for n in lens]
    cache = PagedKVCache(layers=model.paged_kv_layers,
                         n_blocks=sum(need) + 1, block_size=bs,
                         kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                         device=dev)
    keys = tuple(model.paged_state_extras(1, device=dev))
    perm = (np.random.default_rng(5).permutation(sum(need)) + 1).tolist()
    blocks = [[perm.pop() for _ in range(n)] for n in need]
    first, extras = [], []
    for p, blk in zip(prompts, blocks):
        s = len(p)
        if model.prefill_padding_ok:
            cap = 1 << max(4, (s - 1).bit_length())
            C = min(prefill_chunk or cap, cap)
            cap = -(-cap // C) * C
        else:
            cap, C = s, prefill_chunk or s
        state = model.init_seq_state(params, cap, batch_size=1,
                                     dtype=cfg.compute_dtype, device=dev)
        toks = torch.zeros(1, cap, dtype=torch.int32, device=dev)
        toks[0, :s] = torch.as_tensor(p, device=dev)
        pos = torch.arange(cap, dtype=torch.int32, device=dev)[None]
        pos = torch.where(pos < s, pos, torch.full_like(pos, -1))
        for lo in range(0, cap, C):
            state, logits = model.forward(params, state, toks[:, lo:lo + C],
                                          pos[:, lo:lo + C], fresh=lo == 0)
            if lo + C >= s:
                break
        first.append(logits[0].float())
        extras.append({k: state[k] for k in keys})
        cache.write_prompt(state["k"][:, 0, :s], state["v"][:, 0, :s],
                           blk[:-(-s // bs)])
        del state
    extras = cat_batch(extras) if keys else {}
    out = [torch.stack(first)]
    width = 1 << (max(need) - 1).bit_length()
    tables = np.zeros((b, width), np.int32)
    for i, blk in enumerate(blocks):
        tables[i, :len(blk)] = blk
    bt = torch.as_tensor(tables, device=dev)
    for t in range(n_ticks):
        tok = torch.as_tensor([[int(f[t])] for f in forced],
                              dtype=torch.int32, device=dev)
        ln = torch.as_tensor([n + t for n in lens], dtype=torch.int32,
                             device=dev)
        state = {"k": cache.k, "v": cache.v, "block_tables": bt,
                 "lengths": ln, **extras}
        state, logits = model.forward(params, state, tok, ln[:, None])
        extras = {k: state[k] for k in keys}
        out.append(logits.float())
    return torch.stack(out)


def profiled(run, top=12, against_key_averages=False):
    """``run()`` once more under torch.profiler: the device's busy share
    of the traced wall time, the device operations by time, and the
    device time of the port's attention kernels and of its rmsnorm
    backward (the row kernel and its dw combine; the combine, launched
    early as a programmatic dependent, also counts the time it waits).
    Only the device's activity is traced: every number here reads
    device rows, and tracing the host's operations too cost 76-103 s of
    host time a serving phase and stretched the wall (PERF.md §6).  The
    device rows are summed by name straight from the profiler's raw
    Kineto events (``processing_s``: the seconds that takes), not
    through ``key_averages``, whose parse of every event into a
    ``FunctionEvent`` cost tens of seconds a phase.
    ``against_key_averages``: the busy time summed as before too (the
    self device time of ``key_averages``' device rows), with the seconds
    that takes, to show that the two sums agree."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.telemetry import now
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = now()
        run()
        torch.cuda.synchronize()
        wall_ms = (now() - t0) * 1e3
    t1 = now()
    # device-side events only (kernels, copies, memsets): one stream, so
    # their sum is the time the card was busy
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            rec = by_name.setdefault(e.name(), [0, 0])
            rec[0] += 1
            rec[1] += e.duration_ns()
    rows = sorted(({"op": k[:80], "calls": c, "device_ms": ns / 1e6}
                   for k, (c, ns) in by_name.items()),
                  key=lambda r: r["device_ms"], reverse=True)
    busy_ms = sum(r["device_ms"] for r in rows)
    processing_s = now() - t1
    check = None
    if against_key_averages:
        t2 = now()
        ka = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
        ka_ms = sum(getattr(e, "self_device_time_total", 0.0)
                    for e in ka) / 1e3
        check = {"key_averages_busy_ms": ka_ms,
                 "raw_events_busy_ms": busy_ms,
                 "rel_diff": abs(ka_ms - busy_ms) / max(ka_ms, 1e-9),
                 "key_averages_calls": sum(e.count for e in ka),
                 "raw_events_calls": sum(c for c, _ in by_name.values()),
                 "key_averages_s": now() - t2}

    def part(match):
        ops = [r for r in rows if match(r["op"])]
        ms = sum(r["device_ms"] for r in ops)
        return {"device_ms": ms, "share_of_busy": ms / busy_ms if busy_ms
                else 0.0, "ops": ops}
    # the port's attention kernels (flash forward and backward, the paged
    # split and combine)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "processing_s": processing_s, "top": rows[:top],
            "against_key_averages": check,
            "attention": part(lambda k: "flash_" in k or "paged_" in k),
            "rmsnorm_bwd": part(lambda k: "rmsnorm_bwd_kernel" in k
                                or "rmsnorm_dw_combine" in k)}


def e2e_phase(dev):
    import torch
    from repro_torch.launch.serve import build
    from repro_torch.models import build_model
    cfg, model, params = build(ARCH, device=dev, seed=SEED)
    n_params = sum(v.numel() for v in params["layers"].values()) + \
        params["embed"].numel() + params["final_norm_scale"].numel()
    prompts, arrivals = request_set(cfg.vocab_size)
    # warm-up (cuBLAS handles, allocator): two short requests, not kept
    e2e_run(model, params, [prompts[0][:64], prompts[4][:80]], [0, 0], dev,
            0, gen=4)
    runs, tokens = [], None
    for chunk in (0, 256):
        out, toks = e2e_run(model, params, prompts, arrivals, dev, chunk)
        runs.append(out)
        tokens = tokens or toks
        print(json.dumps({"e2e": out}), flush=True)
    # kernel path vs plain path on the same prompts and forced tokens
    plain = build_model(dataclasses.replace(cfg, attn_impl="ref",
                                             norm_impl="ref"))
    cmp = []
    for chunk in (0, 256):
        got = teacher_forced(model, params, prompts, tokens, dev,
                             prefill_chunk=chunk)
        ref = teacher_forced(plain, params, prompts, tokens, dev,
                             prefill_chunk=chunk)
        cmp += logit_rows(got, ref, E2E_REL_TOL, prefill_chunk=chunk)
        del got, ref
    for c in cmp:
        print(json.dumps({"e2e_vs_plain": c}), flush=True)
    # speculation, the cluster and the prefix store on the same trace
    spec, spec_failures = spec_phase_checks(model, params, cfg, prompts,
                                            arrivals, tokens, dev)
    # where the whole-prompt cell's time goes (profiler on, so its wall
    # time is not the measurement above)
    prof = profiled(lambda: e2e_run(model, params,
                                    prompts[:PROFILE_REQUESTS],
                                    arrivals[:PROFILE_REQUESTS], dev, 0))
    print(json.dumps({"profile": prof}), flush=True)
    return {"arch": ARCH, "params": n_params,
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "runs": runs, "vs_plain": cmp, "rel_tol": E2E_REL_TOL,
            "profile": prof, "spec": spec, "spec_failures": spec_failures}


# ------------------------ speculation and the cluster ------------------------

SPEC_K = 4                      # drafts a verify window: T = SPEC_K + 1
# the self-draft's dense cache covers the longest prompt + 32 tokens + k
# (a multiple of 64); at the default 512 it would propose nothing for
# the long prompts
SPEC_DRAFT_MAX_LEN = 1088
SPEC_ROOT = ROOT / "build" / "spec_phase"
SPEC_KERNELS = DENSE_SERVING_KERNELS


class OracleDrafter:
    """Proposes ``good`` tokens of a recorded stream, then ``junk`` wrong
    ones (the previous token + 1): partial acceptance on every tick."""

    def __init__(self, prompts, truth, vocab, good, junk):
        self.truth = {tuple(int(t) for t in p): [int(t) for t in s]
                      for p, s in zip(prompts, truth)}
        self.vocab, self.good, self.junk = vocab, good, junk

    def propose(self, rid, history, k):
        h = [int(t) for t in history]
        for p, toks in self.truth.items():
            if tuple(h[:len(p)]) == p:
                done = len(h) - len(p)
                prop = toks[done:done + min(self.good, k)]
                while len(prop) < min(self.good + self.junk, k):
                    prop.append((h[-1] + 1) % self.vocab)
                return prop
        return []

    def release(self, rid):
        pass


def accept_one_more():
    """The planted acceptance fault: the first mismatching draft is
    accepted too (and the bonus read from the row after it)."""
    from repro_torch.serving import engine as eng_mod
    from repro_torch.serving.speculative import longest_accept

    def one_more(greedy, drafts, gn, acc, rej, plain):
        out = longest_accept(greedy, drafts, gn, acc, rej, plain)
        m = len(out) - 1
        if m < len(drafts):
            out = list(drafts[:m + 1]) + [int(gn[m + 1])]
        return out
    return [(eng_mod, "longest_accept", one_more)]


def rollback_keeps_tail():
    """The planted rollback fault: the rejected tail's blocks stay."""
    from repro_torch.serving.paged_cache import PagedKVCache
    return [(PagedKVCache, "rollback", lambda self, blocks, n: list(blocks))]


def fixup_skipped():
    """The planted hybrid fault: the correction pass skipped."""
    from repro_torch.serving.engine import ServingEngine
    return [(ServingEngine, "_spec_fixup", lambda self, *a: None)]


def spec_run(model, params, prompts, arrivals, dev, *, gen=32,
             kernels=SPEC_KERNELS, drafter=None, patches=(), **engine_kw):
    """One speculative serving run through ``ServingEngine`` (8 slots,
    block 16, whole-prompt prefill) with the launch counters zeroed
    before it; ``drafter`` replaces the engine's own.  Each spec tick is
    wrapped: its paged-kernel launches, its fix-up passes, and the block
    tables after it (every running request must hold exactly
    ``blocks_for(length)`` blocks: the rejected tail's are dropped).
    Returns (record, tokens); fails if a kernel of ``kernels`` never
    launched."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import engine as eng_mod
    from repro_torch.telemetry import now
    Engine = eng_mod.ServingEngine
    n_blocks = 2 * sum(-(-(len(p) + gen + SPEC_K) // 16) for p in prompts) + 1
    tick = {"n": 0, "paged": 0, "fixups": 0, "bad_tables": []}
    step, fixup = Engine._spec_step, Engine._spec_fixup

    def counted(self):
        before = launch_counts()["paged_chunk_attention"]
        out = step(self)
        tick["n"] += 1
        tick["paged"] += launch_counts()["paged_chunk_attention"] - before
        tick["bad_tables"] += [
            (r.rid, r.length, len(r.blocks)) for r in self._slots
            if r is not None and len(r.blocks) !=
            self.cache.blocks_for(r.length)]
        return out

    def fix(self, *a):
        tick["fixups"] += 1
        return fixup(self, *a)

    def run():
        eng = Engine(model, params, device=dev, n_blocks=n_blocks,
                     block_size=16, max_slots=8, **engine_kw)
        if drafter is not None:
            eng.drafter = drafter
        t0 = now()
        rids = [eng.submit(p, gen, arrival=a)
                for p, a in zip(prompts, arrivals)]
        outs = eng.run()
        torch.cuda.synchronize()
        return eng, [outs[r] for r in rids], now() - t0
    torch.cuda.synchronize()
    reset_launch_counts()
    # the counting wrappers first: a planted fault on _spec_fixup
    # replaces the counted one
    eng, toks, secs = with_patches(
        [(Engine, "_spec_step", counted), (Engine, "_spec_fixup", fix)]
        + list(patches), run)
    counts = launch_counts()
    m, st = eng.request_metrics(), eng.stats
    n_tok = sum(len(t) for t in toks)
    rec = {"requests": len(prompts), "new_tokens_each": gen,
           "verify_T": SPEC_K + 1, "seconds": secs,
           "tokens_per_s": n_tok / secs,
           "ttft_p50_s": m["ttft"]["p50_s"], "ttft_p95_s": m["ttft"]["p95_s"],
           "tpot_p50_s": m["tpot"]["p50_s"], "tpot_p95_s": m["tpot"]["p95_s"],
           "tokens_per_verify_step": st["tokens_per_step"],
           "accept_rate": st.get("spec_accept_rate"),
           "spec_ticks": tick["n"], "fixup_passes": tick["fixups"],
           "paged_launches_per_spec_tick": tick["paged"] / max(tick["n"], 1),
           "tables_past_accepted": len(tick["bad_tables"]),
           "engine_steps": eng.step_count, "evictions": eng.evictions,
           "launches": counts}
    if any(len(t) != gen for t in toks):
        raise AssertionError(f"wrong token counts: {[len(t) for t in toks]}")
    dead = [k for k in kernels if counts[k] <= 0]
    if dead:
        raise AssertionError(f"kernels never launched on the spec path: "
                             f"{dead}")
    return rec, toks


def stream_gate(model, params, prompts, plain, streams, dev, tol,
                forced=None, **labels):
    """Gate (i): a greedy stream against the plain engine's stream of the
    same prompts.  Equal to the end passes.  Else, at the first
    differing position, the plain path (the stream teacher-forced
    through ``teacher_forced``, or ``forced(requests, streams, n_ticks)``
    where given) must have a near-tie somewhere at or before it (top-two
    logit gap within ``tol`` of max |logit|), and from there on every
    token of the stream, teacher-forced along the stream itself, must
    lie within ``tol`` of max |logit| of that position's largest
    logit."""
    import numpy as np
    import torch
    diff = [i for i, (p, s) in enumerate(zip(plain, streams))
            if not np.array_equal(p, s)]
    rows = []
    if diff:
        n = len(plain[diff[0]])
        if forced is None:
            sub = [prompts[i] for i in diff]

            def forced(_, toks, ticks):
                return teacher_forced(model, params, sub, toks, dev,
                                      n_ticks=ticks)
        lp = forced(diff, [plain[i] for i in diff], n - 1)
        ls = forced(diff, [streams[i] for i in diff], n - 1)
        for j, i in enumerate(diff):
            first = int(np.flatnonzero(np.asarray(plain[i])
                                       != np.asarray(streams[i]))[0])
            top2 = lp[:, j].topk(2, dim=-1).values
            scale = lp[:, j].abs().amax(-1)
            near = ((top2[:, 0] - top2[:, 1]) <= tol * scale).cpu()
            t_near = int(torch.nonzero(near)[0]) if bool(near.any()) else n
            tok = torch.as_tensor(np.asarray(streams[i]), device=dev).long()
            own = ls[:, j].gather(1, tok[:, None])[:, 0]
            lag = ((ls[:, j].amax(-1) - own)
                   / ls[:, j].abs().amax(-1)).cpu()
            worst = float(lag[first:].max())
            rows.append({"request": i, "first_difference": first,
                         "first_near_tie": t_near,
                         "max_lag_from_first_difference": worst,
                         "ok": t_near <= first and worst <= tol})
        del lp, ls
    return {**labels, "streams": len(streams),
            "equal_to_end": len(streams) - len(diff), "tol": tol,
            "differing": rows, "ok": all(r["ok"] for r in rows)}


def store_roundtrip(model, params, prompt, dev, kv_dtype, root, flip=False):
    """Gate (ii): a prefill's blocks exported on one engine, published
    to a 3FS prefix store, fetched and imported by another engine's
    store restore, re-exported: bitwise equal to the export (codes and
    scale rows).  ``flip``: one byte of the fetched artifact flipped,
    the last byte of its last array's data (the artifact ends with the
    key "extras" and an empty map, 8 bytes); a planted fault."""
    import shutil

    import torch
    from repro_torch.fs3 import FS3KV, FS3Client, FS3Cluster
    from repro_torch.serve_lib import _prefix_key
    from repro_torch.serving import FS3PrefixStore, ServingEngine
    shutil.rmtree(root, ignore_errors=True)
    store = FS3PrefixStore(FS3KV(FS3Client(FS3Cluster(
        str(root), n_nodes=2, targets_per_node=1, replication=1))),
        tag=f"phi4_{kv_dtype}")
    kw = dict(device=dev, n_blocks=2 * -(-len(prompt) // 16) + 2,
              block_size=16, max_slots=1, kv_dtype=kv_dtype)
    src = ServingEngine(model, params, prefill_role=True, **kw)
    rid = src.submit(prompt, 1, keep_blocks=True)
    while rid not in src._done:
        src.step()
    art = src.export_request(rid)
    key = _prefix_key(prompt)
    store.publish(key, {"length": art["length"],
                        "first_token": art["first_token"],
                        "blocks": art["blocks"], "extras": {}})
    nbytes = sum(t.numel() * t.element_size()
                 for t in art["blocks"].values())
    if flip:
        get = store.kv.get

        def flipped(path, default=None):
            raw = bytearray(get(path, default))
            raw[-9] ^= 0xFF
            return bytes(raw)
        store.kv.get = flipped
    dst = ServingEngine(model, params, prefix_store=store, **kw)
    restored = dst._restore_from_store(prompt)
    ids = dst.cache._prefix[key][0]
    back = dst.cache.export_blocks(ids)
    same = restored and list(back) == list(art["blocks"]) and all(
        torch.equal(back[k].view(torch.uint8), art["blocks"][k].view(
            torch.uint8)) for k in back)
    shutil.rmtree(root, ignore_errors=True)
    return {"kv_dtype": kv_dtype, "flipped_byte": flip,
            "arrays": sorted(back), "bytes": nbytes, "bitwise": bool(same)}


def cluster_run(model, params, prompts, arrivals, dev, gen=32):
    """(c): a ``ServingCluster`` of 2 prefill and 2 decode engines (one
    params tree, 8 slots each, block 16) serves the trace with its
    arrivals, every handoff timed (export, import; each ends in a
    synchronise) and its imported blocks held bitwise against the
    export; then every replica's prefixes are flushed to a 3FS prefix
    store and prompt 2 is served again: one store hit on a prefill
    replica, the same stream.  The store's root is removed after."""
    import shutil

    import numpy as np
    import torch
    from repro_torch.fs3 import FS3KV, FS3Client, FS3Cluster
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import (FS3PrefixStore, PagedKVCache,
                                     ServingCluster, ServingEngine)
    from repro_torch.telemetry import now
    root = SPEC_ROOT / "cluster_store"
    shutil.rmtree(root, ignore_errors=True)
    store = FS3PrefixStore(FS3KV(FS3Client(FS3Cluster(
        str(root), n_nodes=2, targets_per_node=1, replication=1))),
        tag="phi4")
    hand = {"export_s": [], "import_s": [], "bytes": [], "imports": 0,
            "import_mismatch": 0}
    export, imp = ServingEngine.export_request, PagedKVCache.import_blocks

    def timed_export(self, rid):
        torch.cuda.synchronize()
        t0 = now()
        art = export(self, rid)
        hand["export_s"].append(now() - t0)
        hand["bytes"].append(sum(t.numel() * t.element_size()
                                 for t in art["blocks"].values()))
        return art

    def checked_import(self, ids, data):
        torch.cuda.synchronize()
        t0 = now()
        imp(self, ids, data)
        torch.cuda.synchronize()
        hand["import_s"].append(now() - t0)
        hand["imports"] += 1
        back = self.export_blocks(ids)
        if not all(torch.equal(back[k].view(torch.uint8),
                               torch.as_tensor(data[k]).view(torch.uint8))
                   for k in back):
            hand["import_mismatch"] += 1

    n_blocks = 2 * sum(-(-(len(p) + gen) // 16) for p in prompts) + 1

    def run():
        clu = ServingCluster(model, params, prefill_replicas=2,
                             decode_replicas=2, prefix_store=store,
                             engine_kwargs=dict(n_blocks=n_blocks,
                                                block_size=16, max_slots=8),
                             device=dev)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = now()
        crids = [clu.submit(p, gen, arrival=a)
                 for p, a in zip(prompts, arrivals)]
        outs = clu.run()
        torch.cuda.synchronize()
        secs = now() - t0
        counts = launch_counts()
        flushed = clu.flush_prefixes()
        hits0 = clu.stats()["store_hits"]
        again = clu.submit(prompts[2], gen)
        out2 = clu.run()[again]
        return clu, [outs[c] for c in crids], secs, counts, flushed, \
            clu.stats()["store_hits"] - hits0, out2
    clu, toks, secs, counts, flushed, hits, out2 = with_patches(
        [(ServingEngine, "export_request", timed_export),
         (PagedKVCache, "import_blocks", checked_import)], run)
    shutil.rmtree(root, ignore_errors=True)
    m, st = clu.request_metrics(), clu.stats()
    n_tok = sum(len(t) for t in toks)
    rec = {"prefill_replicas": 2, "decode_replicas": 2,
           "requests": len(prompts), "new_tokens_each": gen,
           "seconds": secs, "tokens_per_s": n_tok / secs,
           "ttft_p50_s": m["ttft"]["p50_s"], "ttft_p95_s": m["ttft"]["p95_s"],
           "tpot_p50_s": m["tpot"]["p50_s"], "tpot_p95_s": m["tpot"]["p95_s"],
           "cluster_steps": clu.step_count, "evictions": st["evictions"],
           "handoffs": len(hand["export_s"]),
           "export_s": hand["export_s"], "import_s": hand["import_s"],
           "handoff_bytes": hand["bytes"],
           "imports_checked": hand["imports"],
           "imports_bitwise": hand["import_mismatch"] == 0,
           "prefixes_flushed": flushed,
           "store_publishes": store.publishes, "store_hits": hits,
           "store_hit_stream_equal": bool(np.array_equal(out2, toks[2])),
           "launches": counts}
    return rec, toks


def spec_phase_checks(model, params, cfg, prompts, arrivals, plain, dev):
    """The phi4 serving phase's speculative and cluster checks on the
    trace (``plain``: the plain engine's streams of this phase): (a)
    n-gram drafting, (b) the target as its own draft model, (c) the
    cluster with a cross-replica store hit; gates (i) on every stream,
    (ii) the store round trip in bf16 and e4m3, (iii) the planted
    faults (one draft accepted past the first mismatch, a rollback that
    keeps the tail's blocks, one flipped byte in a fetched artifact).
    Returns (record, failures)."""
    failures, out = [], {}
    runs = {}
    for label, kw in (("ngram", dict(spec_mode="ngram", draft_k=SPEC_K)),
                      ("draft-model", dict(
                          spec_mode="draft-model", draft_k=SPEC_K,
                          draft_model=model, draft_params=params,
                          draft_max_len=SPEC_DRAFT_MAX_LEN))):
        rec, toks = spec_run(model, params, prompts, arrivals, dev, **kw)
        rec["gate_i"] = stream_gate(model, params, prompts, plain, toks, dev,
                                    E2E_REL_TOL, run=label)
        runs[label] = rec
        print(json.dumps({"spec": {"mode": label, **rec}}), flush=True)
    rec, toks = cluster_run(model, params, prompts, arrivals, dev)
    rec["gate_i"] = stream_gate(model, params, prompts, plain, toks, dev,
                                E2E_REL_TOL, run="cluster")
    runs["cluster"] = rec
    print(json.dumps({"cluster": rec}), flush=True)
    for label, r in runs.items():
        if not r["gate_i"]["ok"]:
            failures.append(f"phi4 {label}: gate (i) failed: {r['gate_i']}")
        if label != "cluster":
            if r["paged_launches_per_spec_tick"] <= 0:
                failures.append(f"phi4 {label}: no paged launch a spec tick")
            if r["tables_past_accepted"]:
                failures.append(f"phi4 {label}: block tables past the "
                                f"accepted tokens after a tick")
    c = runs["cluster"]
    if not (c["imports_bitwise"] and c["store_hits"] == 1
            and c["store_hit_stream_equal"] and c["imports_checked"] > 0):
        failures.append(f"phi4 cluster: handoff / store gate failed: {c}")
    # gate (ii) in bf16 and e4m3, and the flipped byte
    store = [store_roundtrip(model, params, prompts[2], dev, kv, SPEC_ROOT
                             / "store") for kv in (None, "float8_e4m3")]
    flipped = store_roundtrip(model, params, prompts[2], dev, "float8_e4m3",
                              SPEC_ROOT / "store", flip=True)
    print(json.dumps({"spec_store_roundtrip": store + [flipped]}),
          flush=True)
    failures += [f"phi4 store round trip not bitwise: {r}" for r in store
                 if not r["bitwise"]]
    # planted faults on 2 requests (prompts 0 and 4, 64 and 96 tokens),
    # an oracle proposing 1 true token then junk: partial acceptance on
    # every tick, and over 32 tokens rejected tails that cross a block
    # boundary in both
    sub = [prompts[0], prompts[4]]
    truth = [plain[0], plain[4]]
    controls = []
    for fault, patches in (("none (the control)", ()),
                           ("one draft accepted past the first mismatch",
                            accept_one_more()),
                           ("rollback keeps the rejected tail's blocks",
                            rollback_keeps_tail())):
        rec, toks = spec_run(
            model, params, sub, [0, 0], dev,
            drafter=OracleDrafter(sub, truth, cfg.vocab_size, 1, 3),
            patches=patches, spec_mode="ngram", draft_k=SPEC_K)
        gate = stream_gate(model, params, sub, truth, toks, dev,
                           E2E_REL_TOL, run=fault)
        ok = gate["ok"] and rec["tables_past_accepted"] == 0
        controls.append({"fault": fault, "gate_i_ok": gate["ok"],
                         "tables_past_accepted":
                         rec["tables_past_accepted"],
                         "accept_rate": rec["accept_rate"],
                         "caught": not ok})
    controls.append({"fault": "one byte of a fetched artifact flipped",
                     "caught": not flipped["bitwise"]})
    print(json.dumps({"spec_controls": controls}), flush=True)
    if controls[0]["caught"]:
        failures.append(f"phi4 oracle speculation (no fault) failed its "
                        f"gates: {controls[0]}")
    failures += [f"phi4 spec: planted fault '{c['fault']}' passed"
                 for c in controls[1:] if not c["caught"]]
    out = {"runs": runs, "store_roundtrip": store, "controls": controls}
    return out, failures


# -------------------------------- training ----------------------------------


def train_faults():
    """Planted faults of the training path at full width, each through
    the kernel path's autograd Functions: {fault: (gating, [(module,
    name, replacement), ...])}, the ops modules' kernel wrappers swapped
    for one loss-and-gradients run.  Gating faults touch every row (a
    wiring fault: a mask off by one, a wrong GQA head, a dropped or
    wrong residual) and must fail the gates.  The others touch one key
    tile of 32 or one block of 64 rows of 4096, and are recorded to show
    what the whole-model gates resolve; the kernel cases hold those."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rmsnorm import ops as rops
    fwd, dkv, dq = (fops.flash_attention_fwd, fops.flash_attention_bwd_dkv,
                    fops.flash_attention_bwd_dq)
    bwd = rops.rmsnorm_bwd

    def short(k, kw):                       # one key tile fewer
        kv = k.shape[2] if kw.get("kv_len") is None else kw["kv_len"]
        return {**kw, "kv_len": kv - KEY_TILE}

    def own_masked(q, k, kw):               # every row's own key masked
        off = k.shape[2] - q.shape[2] if kw.get("q_offset") is None \
            else kw["q_offset"]
        return {**kw, "q_offset": off - 1}

    def rolled(k, v):                       # query head h reads kv head
        return k.roll(1, dims=1), v.roll(1, dims=1)   # h // group - 1

    def dkv_rolled(q, k, v, do, lse, delta, **kw):
        dk_, dv_ = dkv(q, *rolled(k, v), do, lse, delta, **kw)
        return dk_.roll(-1, dims=1), dv_.roll(-1, dims=1)
    return {
        "delta dropped": (True, [
            (fops, "flash_attention_bwd_dkv",
             lambda q, k, v, do, lse, delta, **kw: dkv(
                 q, k, v, do, lse, torch.zeros_like(delta), **kw)),
            (fops, "flash_attention_bwd_dq",
             lambda q, k, v, do, lse, delta, **kw: dq(
                 q, k, v, do, lse, torch.zeros_like(delta), **kw))]),
        "causal mask off by one (own key masked) in all three flash "
        "kernels": (True, [
            (fops, "flash_attention_fwd",
             lambda q, k, v, **kw: fwd(q, k, v, **own_masked(q, k, kw))),
            (fops, "flash_attention_bwd_dkv",
             lambda q, k, v, do, lse, delta, **kw: dkv(
                 q, k, v, do, lse, delta, **own_masked(q, k, kw))),
            (fops, "flash_attention_bwd_dq",
             lambda q, k, v, do, lse, delta, **kw: dq(
                 q, k, v, do, lse, delta, **own_masked(q, k, kw)))]),
        "kv heads rolled by one in all three flash kernels": (True, [
            (fops, "flash_attention_fwd",
             lambda q, k, v, **kw: fwd(q, *rolled(k, v), **kw)),
            (fops, "flash_attention_bwd_dkv", dkv_rolled),
            (fops, "flash_attention_bwd_dq",
             lambda q, k, v, do, lse, delta, **kw: dq(
                 q, *rolled(k, v), do, lse, delta, **kw))]),
        "rmsnorm backward fed rstd = 1": (True, [
            (rops, "rmsnorm_bwd",
             lambda x, w, dy, rstd: bwd(x, w, dy, torch.ones_like(rstd)))]),
        "flash forward without the last key tile": (False, [
            (fops, "flash_attention_fwd",
             lambda q, k, v, **kw: fwd(q, k, v, **short(k, kw)))]),
        "dQ without the last key tile": (False, [
            (fops, "flash_attention_bwd_dq",
             lambda q, k, v, do, lse, delta, **kw: dq(
                 q, k, v, do, lse, delta, **short(k, kw)))]),
        "dw without its last row block": (False, [
            (rops, "rmsnorm_bwd",
             lambda x, w, dy, rstd: (
                 bwd(x, w, dy, rstd)[0],
                 bwd(x[:-DW_FAULT_ROWS], w, dy[:-DW_FAULT_ROWS],
                     rstd[:-DW_FAULT_ROWS])[1]))])}


def rel_by_leaf(got, ref, name=""):
    """{leaf: |got - ref| / |ref|} (Frobenius norms, fp32, in chunks of
    16 M elements) over two gradient trees."""
    import torch
    if isinstance(got, dict):
        out = {}
        for k in sorted(got):
            out.update(rel_by_leaf(got[k], ref[k], f"{name}{k}/"))
        return out
    diff = sum(float(torch.sum(torch.square(x.float() - y.float())))
               for x, y in zip(got.reshape(-1).split(1 << 24),
                               ref.reshape(-1).split(1 << 24)))
    norm = sum(float(torch.sum(torch.square(y.float())))
               for y in ref.reshape(-1).split(1 << 24))
    return {name[:-1]: (diff / max(norm, 1e-30)) ** 0.5}


def with_patches(patches, fn):
    """``fn()`` with each (module, name, replacement) of ``patches``
    swapped in for the call."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, new in patches:
        setattr(mod, name, new)
    try:
        return fn()
    finally:
        for mod, name, old in saved:
            setattr(mod, name, old)


def loss_grads_against(model, params, batch, ref_loss, ref_grads,
                       patches=(), loss_tol=TRAIN_LOSS_REL_TOL,
                       grad_tol=TRAIN_GRAD_REL_TOL, leaves=None,
                       leaf_tol=None):
    """The loss and every gradient of ``model`` on ``batch``, with the
    ``patches`` [(module, name, replacement)] swapped in for the run,
    against ``ref_loss`` / ``ref_grads``: the loss's relative difference
    and per leaf |g - g_ref| / |g_ref|.  ``within``: the loss within
    ``loss_tol`` and every leaf (or every leaf named in ``leaves``)
    within ``grad_tol``, or within its own tolerance in ``leaf_tol``.
    The worst leaf is the one that uses the most of its tolerance."""
    from repro_torch.train_lib import loss_and_grads
    lk, _, gk = with_patches(patches, lambda: loss_and_grads(model, params,
                                                             batch))
    rel = rel_by_leaf(gk, ref_grads)
    del gk
    tol = {k: (leaf_tol or {}).get(k, grad_tol) for k in rel
           if leaves is None or k in leaves}
    worst = max(tol, key=lambda k: rel[k] / tol[k])
    lk = float(lk)
    loss_rel = abs(lk - ref_loss) / abs(ref_loss)
    return {"loss_kernel": lk, "loss_ref": ref_loss, "loss_rel": loss_rel,
            "loss_rel_tol": loss_tol, "grad_rel": rel,
            "grad_rel_max": rel[worst], "grad_rel_max_leaf": worst,
            "grad_rel_tol": tol[worst],
            "within": (loss_rel <= loss_tol and rel[worst] <= tol[worst]
                       and math.isfinite(lk))}


def fault_row(fault, gating, r):
    row = {"fault": fault, "gating": gating, "caught": not r.pop("within"),
           **{k: r[k] for k in ("loss_rel", "grad_rel_max",
                                "grad_rel_max_leaf")}}
    print(json.dumps({"train_fault": row}), flush=True)
    return row


def train_steps(model, params, cfg, dev, kernels, n_flop_params, label,
                attn_layers=None, extra_flops=0, steps=TRAIN_STEPS,
                batch_fn=None, tokens=None, flops=None,
                against_key_averages=False):
    """AdamW (warmup_cosine(3e-4, 2, steps), fp32 masters and moments)
    for ``steps`` steps of ``batch_fn(i)`` (default TRAIN_BATCH x
    TRAIN_SEQ synthetic tokens, ``tokens`` a step) through
    ``parallel.plan.make_train_step``, the launch counters zeroed before
    and read after, then one step under the profiler.  MFU counts
    ``flops`` a step, by default 6 * n_flop_params * tokens + 12 * L * h
    * d * causal pairs (L: ``attn_layers``, default every layer) +
    ``extra_flops``.  ``against_key_averages`` goes to ``profiled``.
    Returns (results, failures); frees the state."""
    import statistics

    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.parallel import ParallelPlan, init_state, \
        make_train_step
    from repro_torch.telemetry import now
    B, S = TRAIN_BATCH, TRAIN_SEQ
    if batch_fn is None:
        def batch_fn(i):
            return train_batch(cfg, dev, i)
    opt = AdamW(lr=warmup_cosine(3e-4, 2, steps))
    plan = ParallelPlan(mode="gspmd")
    state = init_state(plan, opt, params)
    del params
    step = make_train_step(plan, model, opt, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    losses, times = [], []
    for i in range(steps):
        b = batch_fn(i)
        torch.cuda.synchronize()
        t0 = now()
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))      # synchronises
        times.append(now() - t0)
        print(json.dumps({f"{label}_step": i, "loss": losses[-1],
                          "seconds": times[-1]}), flush=True)
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    tokens = B * S if tokens is None else tokens
    med = statistics.median(times)
    if flops is None:
        pairs = B * causal_pairs(S, S, 0, S)
        L = cfg.n_layers if attn_layers is None else attn_layers
        flops = 6 * n_flop_params * tokens + \
            12 * L * cfg.n_heads * cfg.head_dim * pairs + extra_flops
    prof = profiled(lambda: float(step(state, batch_fn(steps))[1]["loss"]),
                    against_key_averages=against_key_averages)
    out = {"batch": B, "seq": S, "steps": steps, "losses": losses,
           "step_s": times, "median_step_s": med,
           "tokens_per_s": tokens / med, "model_flops_per_step": flops,
           "mfu_vs_bf16_dense_peak": flops / med / PEAK["bf16_tensor"],
           "peak_mem_gb": peak / 1e9, "launches": counts,
           "launches_per_step": {k: v / steps for k, v in counts.items()},
           "profile": prof}
    del state
    torch.cuda.empty_cache()
    failures = []
    if not all(math.isfinite(x) for x in losses):
        failures.append(f"{label}: losses not finite: {losses}")
    dead = [k for k in kernels if counts[k] <= 0]
    if dead:
        failures.append(f"{label}: kernels never launched on the training "
                        f"path: {dead}")
    return out, failures


def train_batch(cfg, dev, i):
    import torch
    from repro_torch.data.synthetic import batch_for_model
    return {k: torch.as_tensor(v, device=dev) for k, v in batch_for_model(
        cfg, "train", i, TRAIN_BATCH, TRAIN_SEQ, seed=SEED).items()}


def train_phase(dev):
    """phi4-mini-3.8b at full width trains on the card: random bf16
    weights drawn on the card from SEED, synthetic batches of
    TRAIN_BATCH x TRAIN_SEQ tokens.  First the kernel path and the plain
    path (attn_impl / norm_impl "ref") take the loss and every gradient
    of one batch, before any optimizer state exists, and so do the
    kernel path's planted faults (``train_faults``); then
    ``train_steps``."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.train_lib import loss_and_grads
    cfg = get_arch(ARCH)
    model = build_model(cfg)
    params = model.init(SEED, device=dev, dtype="bfloat16")
    n_params = sum(p.numel() for p in tree_leaves(params))
    b0 = train_batch(cfg, dev, 0)

    # 1. kernel path against plain path on one batch, then the kernel
    # path with each planted fault against the same plain path
    plain = build_model(dataclasses.replace(cfg, attn_impl="ref",
                                            norm_impl="ref"))
    lp, _, gp = loss_and_grads(plain, params, b0)
    lp = float(lp)
    vs_plain = loss_grads_against(model, params, b0, lp, gp)
    vs_plain["ok"] = vs_plain.pop("within") and math.isfinite(lp)
    print(json.dumps({"train_vs_plain": vs_plain}), flush=True)
    vs_plain["controls"] = [
        fault_row(fault, gating, loss_grads_against(model, params, b0, lp,
                                                    gp, patches))
        for fault, (gating, patches) in train_faults().items()]
    del gp

    # 2. training
    out, failures = train_steps(model, params, cfg, dev, TRAIN_KERNELS,
                                n_params, "train",
                                against_key_averages=True)
    out = {"arch": ARCH, "params": n_params, **out, "vs_plain": vs_plain}
    if not vs_plain["ok"]:
        failures.append(f"training kernel vs plain: loss_rel "
                        f"{vs_plain['loss_rel']}, worst grad_rel "
                        f"{vs_plain['grad_rel_max']} "
                        f"({vs_plain['grad_rel_max_leaf']})")
    failures += [f"training: planted fault '{f['fault']}' passed the "
                 f"gates" for f in vs_plain["controls"]
                 if f["gating"] and not f["caught"]]
    return out, failures


# -------------------------------- checkpoint --------------------------------

# phi4-mini-3.8b at full width with its 32 layers cut to CKPT_LAYERS:
# ~0.82 B parameters, ~11.4 GB of training state (bf16 params, fp32
# master, m, v), ~23 GB on disk at the 3FS backend's replication 2 (the
# full depth would be ~54 GB of state, ~108 GB on disk)
CKPT_LAYERS = 2
CKPT_STEPS, CKPT_SAVE_AT = 6, 3        # run A's steps; run B saves after 3
CKPT_FREE_FACTOR = 3                   # free disk wanted, in state bytes
CKPT_ROOT = ROOT / "build" / "ckpt_phase"
CKPT_FAULTS = {
    "snapshot": "the snapshot holds references, not copies",
    "offset": "a restore with one master offset shifted by one element",
    "shard": "a ZeRO-1 restore missing one shard",
    "loader": "a resume whose loader restarts at step 0",
}


def _clone_tree(state):
    from repro_torch.ckpt.manager import named_leaves, unflatten_like
    return unflatten_like(state, [t.clone() for _, t in named_leaves(state)])


def leaves_differing(got, ref):
    """Names of the leaves of ``got`` whose dtype, shape or any bit
    differs from ``ref``'s (every leaf of both, ``step`` included)."""
    import torch
    from repro_torch.ckpt.manager import named_leaves
    g, r = dict(named_leaves(got)), dict(named_leaves(ref))
    if sorted(g) != sorted(r):
        return sorted(set(g) ^ set(r))
    return [n for n in sorted(g) if g[n].dtype != r[n].dtype
            or g[n].shape != r[n].shape or not torch.equal(
                g[n].view(torch.uint8) if g[n].dim() else g[n],
                r[n].view(torch.uint8) if r[n].dim() else r[n])]


def max_abs_apart(got, ref):
    """The largest |got - ref| over every float leaf (fp32)."""
    from repro_torch.ckpt.manager import named_leaves
    r = dict(named_leaves(ref))
    return max((float((t.float() - r[n].float()).abs().max())
                for n, t in named_leaves(got) if t.is_floating_point()),
               default=0.0)


def ckpt_steps(step_fn, state, cfg, dev, start, n):
    """``n`` steps from loader step ``start``: ``PrefetchLoader`` yields
    host numpy batches from its thread, this thread moves them to the
    card.  Returns (state, losses)."""
    import torch
    from repro_torch.data import make_synthetic_loader
    loader = make_synthetic_loader(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED,
                                   start_step=start)
    losses = []
    try:
        for _, batch in loader:
            if len(losses) == n:
                break
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in batch.items()}
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
    finally:
        loader.stop()
    return state, losses


def _du(path):
    return sum(p.stat().st_size for p in Path(path).rglob("*")
               if p.is_file())


def _patched_manifest(ck, edit):
    """``ck.load_manifest`` with ``edit(manifest)`` applied (a planted
    fault in what the restore reads)."""
    load = ck.load_manifest

    def planted(step):
        man = load(step)
        edit(man)
        return man
    ck.load_manifest = planted
    return ck


def ckpt_cli(root):
    """The launcher's checkpoint flags on the card: ``python -m
    repro_torch.launch.train`` run as ``-m`` runs it (``runpy``, in this
    process: a second interpreter spends ~15 s reaching the card), 4
    steps with a 3FS checkpoint every 2, then ``--resume`` to 6.  A run
    exits 0 when the module returns; an exception or ``SystemExit`` is
    its failure.  The first run also takes ``--trace``: its Chrome-trace
    JSON must load and hold ``train.step`` and ``ckpt.*`` events."""
    import contextlib
    import io
    import runpy
    base = ["--arch", ARCH, "--smoke", "--batch", "4", "--seq", "128",
            "--ckpt-dir", str(root), "--ckpt-fs3", "--log-every", "1"]
    trace = Path(root).parent / "ckpt_cli_trace.json"
    out, argv = [], sys.argv
    for extra in (["--ckpt-every", "2", "--steps", "4", "--trace",
                   str(trace)],
                  ["--resume", "--steps", "6"]):
        buf, rc = io.StringIO(), 0
        sys.argv = ["-m"] + base + extra
        try:
            with contextlib.redirect_stdout(buf):
                runpy.run_module("repro_torch.launch.train",
                                 run_name="__main__", alter_sys=True)
        except SystemExit as e:               # as the interpreter reads it
            rc = e.code if isinstance(e.code, int) else int(
                e.code is not None)
        except Exception:
            rc, buf = 1, io.StringIO(buf.getvalue() + traceback.format_exc())
        finally:
            sys.argv = argv
        out.append({"argv": extra, "rc": rc,
                    "stdout": buf.getvalue()[-2000:]})
    ok = all(r["rc"] == 0 for r in out) and \
        "resumed from step 4" in out[1]["stdout"]
    return {"runs": out, "trace": trace_summary(trace, "train.step",
                                                "ckpt."), "ok": ok}


def trace_summary(path, *wanted):
    """What a launcher's ``--trace`` JSON holds: its complete events by
    name; ``ok`` when it loads as Chrome-trace JSON (a process-name
    record first, every "X" event with its keys) and holds an event
    named or prefixed by each of ``wanted``."""
    try:
        doc = json.loads(Path(path).read_text())
        evs = doc["traceEvents"]
        xs = [e for e in evs if e["ph"] == "X"]
        ok = evs[0]["ph"] == "M" and all(
            {"name", "ph", "ts", "dur", "pid", "tid"} <= set(e) and
            e["dur"] >= 0 for e in xs)
    except (OSError, ValueError, KeyError, IndexError) as e:
        return {"ok": False, "error": repr(e)}
    names = {}
    for e in xs:
        names[e["name"]] = names.get(e["name"], 0) + 1
    ok = ok and all(any(n.startswith(w) for n in names) for w in wanted)
    return {"ok": ok, "events": len(evs), "complete": names}


def ckpt_phase(dev):
    """Checkpoints on the training path, at phi4-mini-3.8b's full width
    with CKPT_LAYERS layers (bf16 weights drawn on the card from SEED;
    AdamW with fp32 masters and moments; plan gspmd; batches of
    TRAIN_BATCH x TRAIN_SEQ from the port's ``PrefetchLoader``).

    A probe (one step twice from two card-side clones of one state),
    run A (CKPT_STEPS straight), run B (CKPT_SAVE_AT steps, an async
    ``ElasticCheckpointer`` save to a 3FS root, a clone of the state at
    the save, two more steps while the write is in flight, ``wait``),
    a restart (state, model, checkpointer and cluster dropped; a fresh
    3FS backend over the root; ``restore_latest``), the remaining steps
    from the restored state (launch counters zeroed before, read
    after), then ``restore_for`` onto ddp + ZeRO-1 over a one-rank gloo
    grid, that state saved as ``zero1_flat`` (plain files) and
    resharded back to a tree, and the launcher's checkpoint flags
    (``ckpt_cli``).  Gates:
    the restored state bitwise equal to the clone at the save, the
    resumed losses and final state bitwise equal to run A's (or, if the
    probe shows the step itself does not repeat, within the probe's
    spread), the tree -> ZeRO-1 -> tree round trip bitwise, the training
    kernels launched in the resumed steps, each of CKPT_FAULTS caught.
    Prints the seconds of each step (``ckpt_seconds``).  Returns
    (results, failures); removes its roots."""
    import shutil
    import threading

    import torch
    import torch.distributed as dist
    from repro_torch.ckpt import fs3_backend
    from repro_torch.ckpt import manager as manager_lib
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.grid import Grid, free_port
    from repro_torch.data.synthetic import batch_for_model
    from repro_torch.elastic import ElasticCheckpointer, reshard, \
        snapshot_sharded
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.parallel import ParallelPlan, init_state, \
        make_train_step
    from repro_torch.telemetry import get_registry, now
    t_phase = now()
    marks, last = {}, [t_phase]
    read_h = get_registry().histogram("span.ckpt.read")

    def mark(label):
        """Seconds since the previous mark, under ``label``."""
        t = now()
        marks[label] = t - last[0]
        last[0] = t
    cfg = dataclasses.replace(get_arch(ARCH), n_layers=CKPT_LAYERS)
    opt = AdamW(lr=warmup_cosine(3e-4, 2, CKPT_STEPS))
    plan = ParallelPlan(mode="gspmd")
    zplan = ParallelPlan(mode="ddp", zero1=True, overlap=False)
    failures, out = [], {"arch": ARCH, "layers": CKPT_LAYERS,
                         "batch": TRAIN_BATCH, "seq": TRAIN_SEQ}

    def build():
        model = build_model(cfg)
        return model, make_train_step(plan, model, opt, device=dev)

    def fresh(model):
        return init_state(plan, opt, model.init(SEED, device=dev,
                                                dtype="bfloat16"))

    def sync():
        torch.cuda.synchronize(dev)

    model, step_fn = build()
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    CKPT_ROOT.mkdir(parents=True)
    roots = [CKPT_ROOT / n for n in ("tree", "zero1", "fault", "cli")]

    # 0. the state's bytes, and free disk for them
    probe_a = fresh(model)
    nbytes = sum(t.numel() * t.element_size()
                 for _, t in manager_lib.named_leaves(probe_a))
    free = shutil.disk_usage(CKPT_ROOT).free
    out.update(state_bytes=nbytes, free_disk_bytes=free, params=sum(
        t.numel() for _, t in manager_lib.named_leaves(probe_a["params"])))
    print(json.dumps({"ckpt_disk": {"state_bytes": nbytes,
                                    "free_bytes": free,
                                    "wanted": CKPT_FREE_FACTOR * nbytes}}),
          flush=True)
    if free < CKPT_FREE_FACTOR * nbytes:
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
        return out, [f"checkpoint: {free} bytes free under {CKPT_ROOT}, "
                     f"{CKPT_FREE_FACTOR} x the state's {nbytes} wanted"]

    # 1. probe: one step twice from two card-side clones of one state
    probe_b = _clone_tree(probe_a)
    b0 = {k: torch.as_tensor(v, device=dev) for k, v in batch_for_model(
        cfg, "train", 0, TRAIN_BATCH, TRAIN_SEQ, seed=SEED).items()}
    probe_a, ma = step_fn(probe_a, b0)
    probe_b, mb = step_fn(probe_b, b0)
    la, lb = float(ma["loss"]), float(mb["loss"])
    probe = {"bitwise": la == lb and not leaves_differing(probe_a, probe_b),
             "loss_spread": abs(la - lb),
             "state_spread": max_abs_apart(probe_a, probe_b),
             "leaves_apart": leaves_differing(probe_a, probe_b)[:8]}
    out["probe"] = probe
    print(json.dumps({"ckpt_probe": probe}), flush=True)
    del probe_a, probe_b, ma, mb, b0
    mark("model, probe")

    def same_trajectory(losses, state, ref_losses, ref_state):
        """Bitwise, or within the probe's spread where the step does not
        repeat bitwise (4x, the spread of one step over 3)."""
        if probe["bitwise"]:
            return losses == ref_losses and \
                not leaves_differing(state, ref_state)
        return max(abs(a - b) for a, b in zip(losses, ref_losses)) <= \
            4 * probe["loss_spread"] and \
            max_abs_apart(state, ref_state) <= 4 * probe["state_spread"]

    # 2. run A: CKPT_STEPS steps straight
    run_a, losses_a = ckpt_steps(step_fn, fresh(model), cfg, dev, 0,
                                 CKPT_STEPS)
    mark("run A")

    # 3. run B: CKPT_SAVE_AT steps, an async save, two steps in flight
    state, losses_b = ckpt_steps(step_fn, fresh(model), cfg, dev, 0,
                                 CKPT_SAVE_AT)
    ck = ElasticCheckpointer(fs3_backend(str(roots[0])), plan)
    sync()
    mark("run B to the save")
    t0 = now()
    ck.save(state, CKPT_SAVE_AT, blocking=False)
    blocked = now() - t0
    at_save = _clone_tree(state)
    t0 = now()
    state, losses_b2 = ckpt_steps(step_fn, state, cfg, dev, CKPT_SAVE_AT, 2)
    steps_in_flight = now() - t0
    ck.wait()
    mark("save, steps in flight, wait")
    wrote = ck.seconds["write"]
    index = json.loads(ck.backend.read(f"step_{CKPT_SAVE_AT}/index.json"))
    ckpt_bytes = sum(r["size"] for r in index["tensors"].values())
    save = {"bytes": ckpt_bytes, "chunks": len(index["chunks"]),
            "disk_bytes": _du(roots[0]), "blocked_s": blocked,
            "write_s": wrote, "steps_in_flight_s": steps_in_flight,
            "blocked_gb_per_s": ckpt_bytes / blocked / 1e9,
            "write_gb_per_s": ckpt_bytes / wrote / 1e9}
    out["save"] = save
    print(json.dumps({"ckpt_save": save}), flush=True)
    if losses_b != losses_a[:CKPT_SAVE_AT]:
        failures.append(f"checkpoint: run B's first steps {losses_b} are "
                        f"not run A's {losses_a[:CKPT_SAVE_AT]}")

    # 4. restart: state, model, checkpointer and cluster dropped
    del state, ck, model, step_fn
    torch.cuda.empty_cache()
    model, step_fn = build()
    ck = ElasticCheckpointer(fs3_backend(str(roots[0])), plan)
    template = fresh(model)
    sync()
    mark("restart")
    read0, t0 = read_h.sum, now()
    restored, step = ck.restore_latest(template)
    sync()
    restore_s = now() - t0
    read_s = read_h.sum - read0
    del template
    mark("restore")
    apart = leaves_differing(restored, at_save)
    out["restore"] = {"step": step, "seconds": restore_s,
                      "gb_per_s": ckpt_bytes / restore_s / 1e9,
                      "read_s": read_s, "leaves_differing": apart}
    print(json.dumps({"ckpt_restore": out["restore"]}), flush=True)
    if step != CKPT_SAVE_AT or apart:
        failures.append(f"checkpoint: restored step {step} differs from "
                        f"the state at the save in {apart[:8]}")

    # 5. the remaining steps from the restored state
    sync()
    reset_launch_counts()
    restored, losses_r = ckpt_steps(step_fn, restored, cfg, dev, step,
                                    CKPT_STEPS - step)
    sync()
    counts = launch_counts()
    resume_ok = same_trajectory(losses_r, restored, losses_a[step:], run_a)
    out["resume"] = {"losses": losses_r, "run_a": losses_a,
                     "ok": resume_ok, "launches": counts,
                     "state_apart": max_abs_apart(restored, run_a)}
    print(json.dumps({"ckpt_resume": out["resume"]}), flush=True)
    if not resume_ok:
        failures.append(f"checkpoint: resumed losses {losses_r} against "
                        f"run A's {losses_a[step:]} (probe {probe})")
    dead = [k for k in TRAIN_KERNELS if counts[k] <= 0]
    if dead:
        failures.append(f"checkpoint: kernels never launched in the "
                        f"resumed steps: {dead}")
    del restored
    mark("resumed steps")
    faults = {}

    # fault: one master offset shifted by one element
    def shift(man):
        path = next(iter(man["master"]["offsets"]))
        man["master"]["offsets"][path] = [
            s + 1 for s in man["master"]["offsets"][path]]
    bad = _patched_manifest(ElasticCheckpointer(
        fs3_backend(str(roots[0])), plan), shift).restore(
        CKPT_SAVE_AT, {"params": run_a["params"]})
    faults["offset"] = bool(leaves_differing(bad, at_save))
    del bad
    mark("fault: offset")

    # 6. cross-plan: ZeRO-1 over a one-rank gloo grid and back to a tree
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        grid = Grid(1, 1, staging="host")
        t0 = now()
        z, _ = ElasticCheckpointer(fs3_backend(str(roots[0])),
                                   plan).restore_for(zplan, grid,
                                                     run_a["params"])
        sync()
        cross_s = now() - t0
        mark("restore_for ZeRO-1")
        # the 3FS root's thousands of files go while the ZeRO-1 state is
        # saved (plain files: the round trip is the layout's)
        gone = threading.Thread(target=shutil.rmtree, args=(roots[0],))
        gone.start()
        zk = ElasticCheckpointer(str(roots[1]), zplan, grid)
        t0 = now()
        zk.save(z, CKPT_SAVE_AT, blocking=False)
        zblocked = now() - t0
        zk.wait()
        mark("ZeRO-1 save")
        t0 = now()               # the snapshot again, its buffer cached
        snap, _ = snapshot_sharded(z, zplan, grid, CKPT_SAVE_AT,
                                   zk.snapshot)
        warm = now() - t0
        del snap, z

        def drop_shard(man):
            man["flat"]["master"]["shards"].pop()
        try:
            _patched_manifest(ElasticCheckpointer(str(roots[1]), zplan,
                                                  grid),
                drop_shard).restore(CKPT_SAVE_AT,
                                    {"params": run_a["params"]})
            faults["shard"] = False
        except ValueError:
            faults["shard"] = True
        mark("fault: shard")
        t0 = now()
        back, _ = reshard(ElasticCheckpointer(str(roots[1]), zplan, grid),
                          plan, None, run_a["params"], step=CKPT_SAVE_AT)
        sync()
        back_s = now() - t0
        mark("reshard back")
    finally:
        dist.destroy_process_group()
    shutil.rmtree(roots[1])
    gone.join()
    apart = leaves_differing(back, at_save)
    out["cross_plan"] = {
        "restore_for_s": cross_s, "zero1_blocked_s": zblocked,
        "zero1_write_s": zk.seconds["write"], "zero1_snapshot_warm_s": warm,
        "zero1_snapshot_warm_gb_per_s": ckpt_bytes / warm / 1e9,
        "reshard_back_s": back_s, "leaves_differing": apart}
    print(json.dumps({"ckpt_cross_plan": out["cross_plan"]}), flush=True)
    if apart:
        failures.append(f"checkpoint: tree -> ZeRO-1 -> tree differs in "
                        f"{apart[:8]}")
    del back, zk

    # fault: the snapshot holds references; the writer reaches the data
    # after the next two steps (a real write is slower than two steps).
    # Plain files: the fault is the snapshot's, whatever the backend
    gate = threading.Event()
    pack = manager_lib.pack_named

    def held_pack(*a, **k):
        gate.wait(timeout=600)
        return pack(*a, **k)
    manager_lib.pack_named = held_pack
    try:
        fk = ElasticCheckpointer(str(roots[2]), plan)
        fk.snapshot = list                   # the live tensors themselves
        live = _clone_tree(at_save)
        fk.save(live, CKPT_SAVE_AT, blocking=False)
        live, _ = ckpt_steps(step_fn, live, cfg, dev, CKPT_SAVE_AT, 2)
        gate.set()
        fk.wait()
    finally:
        gate.set()
        manager_lib.pack_named = pack
    del live
    mark("fault: snapshot, save")
    bad = ElasticCheckpointer(str(roots[2]), plan).restore(
        CKPT_SAVE_AT, {"params": run_a["params"]})
    faults["snapshot"] = bool(leaves_differing(bad, at_save))
    del bad
    shutil.rmtree(roots[2])
    mark("fault: snapshot, restore")

    # fault: the resumed steps with the loader restarted at step 0 (from
    # the state at the save, which the restored state equals bitwise)
    at_save, losses_0 = ckpt_steps(step_fn, at_save, cfg, dev, 0,
                                   CKPT_STEPS - CKPT_SAVE_AT)
    faults["loader"] = not same_trajectory(losses_0, at_save,
                                           losses_a[CKPT_SAVE_AT:], run_a)
    del at_save, run_a, model, step_fn
    torch.cuda.empty_cache()
    mark("fault: loader")
    out["faults"] = [{"fault": CKPT_FAULTS[k], "caught": v}
                     for k, v in faults.items()]
    print(json.dumps({"ckpt_faults": out["faults"]}), flush=True)
    failures += [f"checkpoint: planted fault '{CKPT_FAULTS[k]}' passed "
                 "the gates" for k, v in faults.items() if not v]

    # 7. the launcher's checkpoint flags, two processes
    out["cli"] = ckpt_cli(roots[3])
    mark("cli")
    print(json.dumps({"ckpt_cli": out["cli"]}), flush=True)
    if not out["cli"]["ok"]:
        failures.append(f"checkpoint: the launcher's --ckpt-fs3 / --resume "
                        f"runs failed: {out['cli']['runs']}")
    if not out["cli"]["trace"]["ok"]:
        failures.append(f"checkpoint: the launcher's --trace JSON lacks "
                        f"train.step / ckpt.* events or does not load: "
                        f"{out['cli']['trace']}")
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    mark("clean up")
    out["seconds"] = now() - t_phase
    out["seconds_by_step"] = marks
    print(json.dumps({"ckpt_seconds": marks}), flush=True)
    return out, failures


# ----------------------------------- MoE ------------------------------------


def bf16_ulp(x):
    """The spacing of bfloat16 numbers at magnitude ``x`` > 0."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def logit_rows(got, ref, rel_tol=None, bf16_ulps=None, same_argmax=False,
               **labels):
    """One comparison row per logits set (first token, 4 decode ticks):
    max |got - ref| against ``rel_tol`` times max |ref|, or against
    ``bf16_ulps`` bf16 ulps of max |ref| (and, with ``same_argmax``,
    every greedy token identical)."""
    import torch
    rows = []
    for i, name in enumerate(["first_token"] +
                             [f"tick_{t}" for t in range(1, len(got))]):
        d = float((got[i] - ref[i]).abs().max())
        scale = float(ref[i].abs().max())
        tol = rel_tol * scale if bf16_ulps is None else \
            bf16_ulps * bf16_ulp(scale)
        agree = float((got[i].argmax(-1) == ref[i].argmax(-1))
                      .float().mean())
        finite = bool(torch.isfinite(got[i]).all())
        ok = d <= tol and finite
        if same_argmax:
            ok = ok and agree == 1.0
        rows.append({**labels, "logits": name, "max_abs_diff": d,
                     "max_abs_ref": scale, "rel": d / scale,
                     "tol_used": d / tol, "argmax_agree": agree,
                     "finite": finite, "ok": ok})
    return rows


def rolled_experts_patch():
    """The planted wiring fault of the MoE path: the gating kernel's
    experts rolled by one (expert e's tokens go to expert e + 1)."""
    from repro_torch.kernels import topk_gating as gating
    gate = gating.topk_gating

    def rolled(logits, *, k, renorm=True, impl="auto"):
        w, e = gate(logits, k=k, renorm=renorm, impl=impl)
        return w, (e + 1) % logits.shape[-1]
    return [(gating, "topk_gating", rolled)]


def moe_layer_check(cfg, params, dev):
    """Layer 0's routed experts of the full-width model (its bf16
    weights; shared experts off, so y is the routed part alone) on
    unit-RMS inputs: the gating kernel route against the plain route
    (gate_impl "ref") at a decode tick (8 tokens) and a prefill bucket
    (1024), dropless, and at the training step (4096, capacity-limited),
    within MOE_LAYER_TOL of max |y|; experts rolled by one in the
    kernel's output must fail that gate."""
    import torch
    from repro_torch.models.moe import apply_moe
    routed = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                              d_shared=0))
    plain = dataclasses.replace(routed, gate_impl="ref")
    lp = {k[4:]: v[0] for k, v in params["layers"].items()
          if k.startswith("moe_")}
    g = torch.Generator(device=dev).manual_seed(11)
    rows = []
    with torch.no_grad():
        for T, dropless in ((8, True), (1024, True), (4096, False)):
            h = torch.randn(1, T, cfg.d_model, device=dev,
                            generator=g).bfloat16()

            def y(c):
                return apply_moe(c, lp, h, dropless=dropless, _aux=False)[0]
            got, ref = y(routed), y(plain)
            bad = with_patches(rolled_experts_patch(), lambda: y(routed))
            scale = float(ref.abs().max())
            d, f = (float((x - ref).abs().max()) for x in (got, bad))
            rows.append({"tokens": T, "dropless": dropless,
                         "max_abs_diff": d, "max_abs_ref": scale,
                         "rel": d / scale, "tol": MOE_LAYER_TOL,
                         "fault_rel": f / scale,
                         "ok": d <= MOE_LAYER_TOL * scale,
                         "fault_caught": f > MOE_LAYER_TOL * scale})
            print(json.dumps({"moe_layer_vs_plain": rows[-1]}), flush=True)
    return rows


def moe_serve_phase(dev):
    """qwen2-moe-a2.7b at full width (24 layers, random bf16 weights
    drawn on the card from SEED, not cut) serves the phi4 trace over its
    own vocabulary, whole-prompt and in prefill chunks of 256; every
    serving kernel, the gating kernel included, must launch.  Then the
    kernel path against two references on the same prompts and forced
    tokens (first-token logits and 4 decode ticks through a fragmented
    paged pool): gating only (gate_impl "ref", every other kernel on)
    within MOE_GATE_LOGIT_ULPS bf16 ulps with identical greedy tokens,
    and the whole plain path within MOE_E2E_REL_TOL.  The planted fault
    (experts rolled by one) is recorded against the whole plain path and
    must fail ``moe_layer_check``."""
    import torch
    from repro_torch.launch.serve import build
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_leaves
    torch.cuda.reset_peak_memory_stats(dev)
    cfg, model, params = build(MOE_ARCH, device=dev, seed=SEED)
    n_params = sum(p.numel() for p in tree_leaves(params))
    prompts, arrivals = request_set(cfg.vocab_size)
    e2e_run(model, params, [prompts[0][:64], prompts[4][:80]], [0, 0], dev,
            0, gen=4, kernels=SERVING_KERNELS)
    runs, tokens = [], None
    for chunk in (0, 256):
        out, toks = e2e_run(model, params, prompts, arrivals, dev, chunk,
                            kernels=SERVING_KERNELS)
        runs.append(out)
        tokens = tokens or toks
        print(json.dumps({"moe_e2e": out}), flush=True)
    gate_ref = build_model(dataclasses.replace(cfg, gate_impl="ref"))
    plain = build_model(dataclasses.replace(cfg, attn_impl="ref",
                                            norm_impl="ref",
                                            gate_impl="ref"))
    cmp, plain0 = [], None
    for chunk in (0, 256):
        got = teacher_forced(model, params, prompts, tokens, dev,
                             prefill_chunk=chunk)
        ref = teacher_forced(gate_ref, params, prompts, tokens, dev,
                             prefill_chunk=chunk)
        cmp += logit_rows(got, ref, bf16_ulps=MOE_GATE_LOGIT_ULPS,
                          same_argmax=True, route="gating only",
                          prefill_chunk=chunk)
        ref = teacher_forced(plain, params, prompts, tokens, dev,
                             prefill_chunk=chunk)
        cmp += logit_rows(got, ref, MOE_E2E_REL_TOL, route="whole path",
                          prefill_chunk=chunk)
        plain0 = ref if chunk == 0 else plain0
        del got
    bad = with_patches(rolled_experts_patch(), lambda: teacher_forced(
        model, params, prompts, tokens, dev))
    fault = logit_rows(bad, plain0, MOE_E2E_REL_TOL,
                       route="experts rolled by one (planted fault, "
                             "recorded)", prefill_chunk=0)
    del bad, plain0
    for c in cmp + fault:
        print(json.dumps({"moe_e2e_vs_plain": c}), flush=True)
    # n-gram speculation on 4 requests of the trace, gate (i)
    spec, toks = spec_run(model, params, prompts[:4], arrivals[:4], dev,
                          kernels=SERVING_KERNELS, spec_mode="ngram",
                          draft_k=SPEC_K)
    spec["gate_i"] = stream_gate(model, params, prompts[:4], tokens[:4],
                                 toks, dev, MOE_E2E_REL_TOL, run="moe ngram")
    print(json.dumps({"moe_spec": spec}), flush=True)
    layer = moe_layer_check(cfg, params, dev)
    prof = profiled(lambda: e2e_run(model, params,
                                    prompts[:PROFILE_REQUESTS],
                                    arrivals[:PROFILE_REQUESTS], dev, 0,
                                    kernels=SERVING_KERNELS))
    print(json.dumps({"moe_profile": prof}), flush=True)
    out = {"arch": MOE_ARCH, "params": n_params,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "runs": runs, "vs_plain": cmp, "gate_only_bf16_ulps":
           MOE_GATE_LOGIT_ULPS, "rel_tol": MOE_E2E_REL_TOL,
           "fault_rel_max": max(r["rel"] for r in fault),
           "layer_vs_plain": layer, "profile": prof, "spec": spec}
    del params
    torch.cuda.empty_cache()
    failures = [f"moe serving {c['route']}: {c}" for c in cmp if not c["ok"]]
    if not (spec["gate_i"]["ok"] and spec["paged_launches_per_spec_tick"] > 0
            and spec["tables_past_accepted"] == 0):
        failures.append(f"moe speculation: {spec}")
    failures += [f"moe layer, {r['tokens']} tokens: {r}" for r in layer
                 if not r["ok"] or not r["fault_caught"]]
    return out, failures


def gating_train_faults():
    """Planted faults of the gating backward on the training path: the
    TopKGating Function's kernel swapped for the plain backward with
    one fault ("c term dropped" is invisible with renorm)."""
    from repro_torch.kernels.topk_gating import ops
    return {f: [(ops, "topk_gating_bwd",
                 lambda logits, experts, dw, k, renorm, f=f:
                 _gating_bwd_faulty(logits, experts, dw, renorm, f))]
            for f in ("renorm Jacobian dropped", "scattered to index + 1")}


def moe_train_phase(dev):
    """qwen2-moe-a2.7b at full widths with its depth cut to
    MOE_TRAIN_LAYERS trains on the card (capacity-limited dispatch,
    groups of 512, cap 42).  On one batch, the kernel path against:
    (1) the plain path (attention, rmsnorm and gating "ref") at the
    training gates, the routed leaves at MOE_ROUTED_GRAD_TOL; (2) the
    gating-only reference (gate_impl "ref", every other kernel on): loss
    within MOE_GATE_LOSS_TOL, ``moe_router`` within MOE_ROUTED_GRAD_TOL;
    (3) the kernel forward with the plain gating backward (the forward
    bitwise the same): ``moe_router`` within MOE_GATE_ROUTER_TOL, which
    the planted gating-backward faults must fail.  Then ``train_steps``."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.topk_gating import ops as gating_ops
    from repro_torch.kernels.topk_gating import topk_gating_bwd_ref
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.train_lib import loss_and_grads
    cfg = dataclasses.replace(get_arch(MOE_ARCH), n_layers=MOE_TRAIN_LAYERS)
    model = build_model(cfg)
    params = model.init(SEED, device=dev, dtype="bfloat16")
    n_params = sum(p.numel() for p in tree_leaves(params))
    n_active = cfg.active_param_count()
    b0 = train_batch(cfg, dev, 0)
    router = ("layers/moe_router",)
    routed_tol = {k: MOE_ROUTED_GRAD_TOL for k in MOE_ROUTED_LEAVES}
    checks = {}
    for name, ref_model, patches, kw in (
            ("vs_plain", build_model(dataclasses.replace(
                cfg, attn_impl="ref", norm_impl="ref", gate_impl="ref")),
             (), dict(leaf_tol=routed_tol)),
            ("vs_gate_ref", build_model(dataclasses.replace(
                cfg, gate_impl="ref")), (),
             dict(loss_tol=MOE_GATE_LOSS_TOL, grad_tol=MOE_ROUTED_GRAD_TOL,
                  leaves=router)),
            ("vs_plain_gating_backward", model,
             [(gating_ops, "topk_gating_bwd", topk_gating_bwd_ref)],
             dict(loss_tol=MOE_GATE_LOSS_TOL, grad_tol=MOE_GATE_ROUTER_TOL,
                  leaves=router))):
        lr, _, gr = with_patches(patches, lambda: loss_and_grads(
            ref_model, params, b0))
        lr = float(lr)
        r = loss_grads_against(model, params, b0, lr, gr, **kw)
        r["ok"] = r.pop("within") and math.isfinite(lr)
        print(json.dumps({f"moe_train_{name}": r}), flush=True)
        if name == "vs_plain_gating_backward":
            r["controls"] = [
                fault_row(fault, True, loss_grads_against(
                    model, params, b0, lr, gr, fault_patches, **kw))
                for fault, fault_patches in gating_train_faults().items()]
        checks[name] = r
        del gr
    out, failures = train_steps(model, params, cfg, dev, MOE_TRAIN_KERNELS,
                                n_active, "moe_train")
    out = {"arch": MOE_ARCH, "n_layers": MOE_TRAIN_LAYERS,
           "params": n_params, "active_params": n_active, **out, **checks}
    for name, r in checks.items():
        if not r["ok"]:
            failures.append(f"moe training {name}: loss_rel {r['loss_rel']}"
                            f", worst grad_rel {r['grad_rel_max']} "
                            f"({r['grad_rel_max_leaf']})")
    failures += [f"moe training: planted fault '{f['fault']}' passed the "
                 f"gating backward gate"
                 for f in checks["vs_plain_gating_backward"]["controls"]
                 if not f["caught"]]
    return out, failures


# --------------------------------- hybrid -----------------------------------


def ssd_carry_dropped(fwd):
    """The planted fault of the hybrid serving path: the SSD forward
    ``fwd`` run on each chunk alone (the carried state dropped between
    chunks; h_final is the last chunk's)."""
    def dropped(x, a, B, C, *, chunk, save_hprev=False):
        b, l = x.shape[:2]
        per = [t.reshape(b * (l // chunk), chunk, *t.shape[2:])
               for t in (x, a, B, C)]
        y, hf = fwd(*per, chunk=chunk)
        return y.reshape(x.shape), hf.reshape(b, l // chunk,
                                              *hf.shape[1:])[:, -1]
    return dropped


def ssd_forward_probe(fwd):
    """A stand-in for ``ops.ssd_scan_fwd`` on the serving path: each call
    runs ``fwd`` (the kernel, or one with a planted fault) and the plain
    forward on the same inputs, records y and h_final against the plain
    ones (``ssd_verdict``) and returns ``fwd``'s.  Returns (stand-in,
    list of per-call verdicts)."""
    from repro_torch.kernels.ssd_scan import ssd_fwd_ref
    calls = []

    def probe(x, a, B, C, *, chunk, save_hprev=False):
        got = fwd(x, a, B, C, chunk=chunk, save_hprev=save_hprev)
        ry, rh = ssd_fwd_ref(x, a, B, C, chunk)[:2]
        calls.append(ssd_verdict({"y": got[0], "h_final": got[1]},
                                 {"y": ry, "h_final": rh}, {}))
        return got
    return probe, calls


def ssd_exact(x, a, B, C, chunk):
    """The chunked scan in fp64 (y in x.dtype, rounded once; h_final
    fp32): the SSD outputs the serving-gate probe substitutes."""
    import torch
    x, a, B, C = (t.double() for t in (x, a, B, C))
    state = torch.zeros(x.shape[0], x.shape[2], x.shape[3], B.shape[-1],
                        dtype=torch.float64, device=x.device)
    mask = torch.ones(chunk, chunk, dtype=torch.bool,
                      device=x.device).tril()[None, :, :, None]
    ys = []
    for lo in range(0, x.shape[1], chunk):
        sl = slice(lo, lo + chunk)
        xc, Bc, Cc = x[:, sl], B[:, sl], C[:, sl]
        cum = torch.cumsum(a[:, sl], 1)
        L = torch.where(mask, torch.exp(cum[:, :, None] - cum[:, None]), 0.0)
        ys.append(torch.einsum("bln,bsn,blsh,bshp->blhp", Cc, Bc, L, xc)
                  + torch.einsum("bln,bhpn,blh->blhp", Cc, state,
                                 torch.exp(cum)))
        state = (torch.einsum("bsh,bshp,bsn->bhpn",
                              torch.exp(cum[:, -1:] - cum), xc, Bc)
                 + state * torch.exp(cum[:, -1])[:, :, None, None])
    return torch.cat(ys, 1).to(torch.bfloat16), state.float()


def ssd_gate_probe(model, ssd_ref, slow, forced, ref):
    """Recorded, not gated: why the serving forward keeps the CUDA-core
    kernel.  The slow-decay SSD-only logits (bf16 ulps of the largest,
    against ``ref``, the plain path's) with the Hopper forward on the
    serving path, with fp64 SSD outputs (``ssd_exact``), and for the
    plain path itself with its fp32 y scaled by (1 + 1e-7 N(0, 1)) before
    rounding, three seeds."""
    import torch
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import ssm_common

    fwd = ssd_ops.ssd_scan_fwd      # the wrapper, before it is patched

    def hopper(x, a, B, C, *, chunk, save_hprev=False):
        return fwd(x, a, B, C, chunk=chunk, save_hprev=True)[:2]

    def exact(x, a, B, C, *, chunk, save_hprev=False):
        return ssd_exact(x, a, B, C, chunk)

    step = ssm_common.ssd_chunk_step

    def noisy(seed):
        g = torch.Generator(device=ref.device).manual_seed(seed)

        def f(hprev, xc, ac, Bc, Cc, out_dtype):
            h, y = step(hprev, xc, ac, Bc, Cc, torch.float32)
            noise = torch.randn(y.shape, device=y.device, generator=g)
            return h, (y * (1 + 1e-7 * noise)).to(out_dtype)
        return f

    runs = [("hopper forward on the serving path", model,
             (ssd_ops, "ssd_scan_fwd", hopper)),
            ("fp64 SSD outputs", model, (ssd_ops, "ssd_scan_fwd", exact))]
    runs += [(f"plain path, y x (1 + 1e-7 N(0, 1)), seed {seed}", ssd_ref,
              (ssm_common, "ssd_chunk_step", noisy(seed)))
             for seed in (1, 2, 3)]
    out = []
    for label, m, patch in runs:
        rows = logit_rows(forced(m, slow, patches=[patch]), ref,
                          bf16_ulps=HYBRID_SSD_LOGIT_ULPS, same_argmax=True,
                          route="ssd only")
        out.append({"route": label, "bf16_ulps": [r["tol_used"]
                                                  for r in rows]})
    return out


def slow_decay(params):
    """``params`` with every Mamba layer's A_log set to SLOW_A_LOG."""
    import torch
    m = params["mamba"]
    return {**params, "mamba": {
        **m, "A_log": torch.full_like(m["A_log"], SLOW_A_LOG)}}


def hybrid_serve_phase(dev):
    """zamba2-1.2b at full width and depth (38 Mamba-2 layers, the shared
    block 6 times; random bf16 weights drawn on the card from SEED)
    serves the phi4 trace over its own vocabulary, whole-prompt and in
    prefill chunks of 256, through exact-length prefill chunks and
    per-slot mamba state pools; every serving kernel, the SSD scan
    included, must launch: 38 times per prompt (every whole-prompt
    prefill, and the first chunk of a chunked one; at least that when
    evictions replay prefills).  Then the kernel path against two
    references on the same prompts and forced tokens (first-token logits
    and 4 decode ticks through a fragmented paged pool): the SSD scan
    only (ssm_impl "ref", every other kernel on) within
    HYBRID_SSD_LOGIT_ULPS bf16 ulps with identical greedy tokens, which
    the SSD kernel with its carry dropped must fail, and the whole plain
    path within HYBRID_E2E_REL_TOL; both bf16 paths against the fp32
    forward are recorded.  Then on slow-decay weights (SLOW_A_LOG),
    whole prompts: every SSD forward call held at the op, and the same
    two logits gates; the dropped carry must fail the op gate and the
    SSD-only one."""
    import torch
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch.serve import build
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_leaves
    torch.cuda.reset_peak_memory_stats(dev)
    cfg, model, params = build(HYBRID_ARCH, device=dev, seed=SEED)
    n_params = sum(p.numel() for p in tree_leaves(params))
    prompts, arrivals = request_set(cfg.vocab_size)
    e2e_run(model, params, [prompts[0][:64], prompts[4][:80]], [0, 0], dev,
            0, gen=4, kernels=HYBRID_SERVING_KERNELS)
    runs, tokens, failures = [], None, []
    for chunk in (0, 256):
        out, toks = e2e_run(model, params, prompts, arrivals, dev, chunk,
                            kernels=HYBRID_SERVING_KERNELS)
        want, got = cfg.n_layers * len(prompts), out["launches"]["ssd_scan"]
        # a replayed request prefills again: then at least ``want``
        out["ssd_scan_launches_expected"] = (
            want if out["evictions"] == 0 else f">= {want} "
            f"({out['evictions']} evictions replayed)")
        if got < want or (out["evictions"] == 0 and got != want):
            failures.append(f"hybrid serving (prefill_chunk={chunk}): "
                            f"ssd_scan launched {got} times, expected "
                            f"{out['ssd_scan_launches_expected']}")
        runs.append(out)
        tokens = tokens or toks
        print(json.dumps({"hybrid_e2e": out}), flush=True)
    # speculation with partial acceptance on every tick (2 true drafts,
    # then junk) on 4 requests, gate (i); the correction pass skipped
    # must fail it
    spec = {}
    for fault, patches in (("none", ()),
                           ("correction pass skipped", fixup_skipped())):
        rec, toks = spec_run(
            model, params, prompts[:4], arrivals[:4], dev,
            kernels=HYBRID_SERVING_KERNELS, patches=patches,
            drafter=OracleDrafter(prompts[:4], tokens[:4], cfg.vocab_size,
                                  2, 2), spec_mode="ngram", draft_k=SPEC_K)
        rec["gate_i"] = stream_gate(model, params, prompts[:4], tokens[:4],
                                    toks, dev, HYBRID_E2E_REL_TOL,
                                    run=f"hybrid oracle, fault: {fault}")
        spec[fault] = rec
        print(json.dumps({"hybrid_spec": {"fault": fault, **rec}}),
              flush=True)
    good = spec["none"]
    if not (good["gate_i"]["ok"] and good["fixup_passes"] > 0
            and 0.0 < good["accept_rate"] < 1.0
            and good["tables_past_accepted"] == 0):
        failures.append(f"hybrid speculation: {good}")
    if spec["correction pass skipped"]["gate_i"]["ok"]:
        failures.append("hybrid speculation: planted fault 'correction "
                        "pass skipped' passed gate (i)")
    ssd_ref = build_model(dataclasses.replace(cfg, ssm_impl="ref"))
    plain = build_model(dataclasses.replace(cfg, attn_impl="ref",
                                            norm_impl="ref", ssm_impl="ref"))
    f32 = build_model(dataclasses.replace(
        cfg, compute_dtype="float32", attn_impl="ref", norm_impl="ref",
        ssm_impl="ref"))
    dropped = [(ssd_ops, "ssd_scan_fwd",
                ssd_carry_dropped(ssd_ops.ssd_scan_fwd))]

    def forced(m, p, chunk=0, patches=()):
        return with_patches(list(patches), lambda: teacher_forced(
            m, p, prompts, tokens, dev, prefill_chunk=chunk))

    def against_fp32(p, got, ref, **labels):
        # both bf16 paths against the plain forward in fp32 on fp32
        # copies of the same weights (recorded: what the gates sit in)
        p32 = {k: ({kk: vv.float() for kk, vv in v.items()}
                   if isinstance(v, dict) else v.float())
               for k, v in p.items()}
        truth = forced(f32, p32)
        del p32
        return [r for route, x in (("kernel path vs fp32 forward", got),
                                   ("plain path vs fp32 forward", ref))
                for r in logit_rows(x, truth, HYBRID_E2E_REL_TOL,
                                    route=f"{route} (recorded)", **labels)]

    cmp, recorded, controls = [], [], []
    for chunk in (0, 256):
        got, ref = forced(model, params, chunk), forced(ssd_ref, params, chunk)
        cmp += logit_rows(got, ref, bf16_ulps=HYBRID_SSD_LOGIT_ULPS,
                          same_argmax=True, route="ssd only",
                          prefill_chunk=chunk)
        if chunk == 0:
            rows = logit_rows(forced(model, params, patches=dropped), ref,
                              bf16_ulps=HYBRID_SSD_LOGIT_ULPS,
                              same_argmax=True, route="ssd only",
                              prefill_chunk=0)
            controls.append({"fault": "SSD kernel with its carry dropped",
                             "check": "ssd only logits",
                             "tol_used": max(r["tol_used"] for r in rows),
                             "caught": not all(r["ok"] for r in rows)})
        ref = forced(plain, params, chunk)
        cmp += logit_rows(got, ref, HYBRID_E2E_REL_TOL, route="whole path",
                          prefill_chunk=chunk)
        if chunk == 0:
            recorded += against_fp32(params, got, ref, prefill_chunk=0)
        del got, ref

    # slow decay: the carried state matters; whole prompts
    slow = slow_decay(params)
    probe, calls = ssd_forward_probe(ssd_ops.ssd_scan_fwd)
    got = forced(model, slow, patches=[(ssd_ops, "ssd_scan_fwd", probe)])
    slow_op = op_summary(calls)
    probe, calls = ssd_forward_probe(ssd_carry_dropped(ssd_ops.ssd_scan_fwd))
    bad = forced(model, slow, patches=[(ssd_ops, "ssd_scan_fwd", probe)])
    bad_op = op_summary(calls)
    controls.append({"fault": "SSD kernel with its carry dropped",
                     "check": "slow decay, each SSD forward call at the op",
                     "tol_used": bad_op["tol_used"],
                     "caught": not bad_op["ok"]})
    ref = forced(ssd_ref, slow)
    lab = dict(prefill_chunk=0, weights="slow decay")
    cmp += logit_rows(got, ref, bf16_ulps=HYBRID_SSD_LOGIT_ULPS,
                      same_argmax=True, route="ssd only", **lab)
    rows = logit_rows(bad, ref, bf16_ulps=HYBRID_SSD_LOGIT_ULPS,
                      same_argmax=True, route="ssd only", **lab)
    controls.append({"fault": "SSD kernel with its carry dropped",
                     "check": "slow decay, ssd only logits",
                     "tol_used": max(r["tol_used"] for r in rows),
                     "caught": not all(r["ok"] for r in rows)})
    del bad
    probe_rows = ssd_gate_probe(model, ssd_ref, slow, forced, ref)
    ref = forced(plain, slow)
    cmp += logit_rows(got, ref, HYBRID_E2E_REL_TOL, route="whole path",
                      **lab)
    recorded += against_fp32(slow, got, ref, **lab)
    del got, ref, slow
    for c in cmp + recorded:
        print(json.dumps({"hybrid_e2e_vs_plain": c}), flush=True)
    print(json.dumps({"hybrid_slow_decay_op": slow_op,
                      "hybrid_serve_controls": controls,
                      "hybrid_ssd_gate_probe": probe_rows}), flush=True)
    prof = profiled(lambda: e2e_run(model, params,
                                    prompts[:PROFILE_REQUESTS],
                                    arrivals[:PROFILE_REQUESTS], dev, 0,
                                    kernels=HYBRID_SERVING_KERNELS))
    print(json.dumps({"hybrid_profile": prof}), flush=True)
    out = {"arch": HYBRID_ARCH, "params": n_params,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "runs": runs, "vs_plain": cmp, "slow_decay_op": slow_op,
           "controls": controls, "recorded": recorded,
           "ssd_gate_probe": probe_rows,
           "ssd_only_bf16_ulps": HYBRID_SSD_LOGIT_ULPS,
           "rel_tol": HYBRID_E2E_REL_TOL, "profile": prof,
           "spec": spec["none"]}
    del params
    torch.cuda.empty_cache()
    failures += [f"hybrid serving {c['route']}: {c}" for c in cmp
                 if not c["ok"]]
    if not slow_op["ok"]:
        failures.append(f"hybrid serving, slow decay: an SSD forward call "
                        f"failed the op gate: {slow_op}")
    failures += [f"hybrid serving: planted fault '{c['fault']}' passed "
                 f"the {c['check']}" for c in controls if not c["caught"]]
    return out, failures


# planted faults of the SSD backward on the training path (dh_final
# ignored cannot show there: training never reads h_final, so its
# cotangent is zero)
SSD_TRAIN_FAULTS = ("da's reverse cumsum shifted by one row",
                    "dB summed over half the heads")


def ssd_backward_probe(fault=None):
    """A stand-in for ``ops.ssd_scan_bwd``: each call runs the backward
    kernel and the plain backward (with ``fault``) on the same saved
    inputs, records the kernel's outputs against the plain ones
    (``ssd_verdict``) and returns the plain ones — the plain SSD
    backward in place of the kernel's, the forward untouched.  Returns
    (stand-in, list of per-call verdicts)."""
    from repro_torch.kernels.ssd_scan import kernel
    names = ("dx", "da", "dB", "dC")
    calls = []

    def bwd(x, a, B, C, hprev, dy, dhfin, *, chunk):
        got = kernel.ssd_scan_bwd(x, a, B, C, hprev, dy, dhfin, chunk=chunk)
        ref = ssd_faulty_bwd(fault, x, a, B, C, hprev, dy, dhfin, chunk)
        calls.append(ssd_verdict(dict(zip(names, got)),
                                 dict(zip(names, ref)), {}))
        return ref
    return bwd, calls


def op_summary(calls):
    return {"calls": len(calls),
            "tol_used": max(c["tol_used"] for c in calls),
            "ok": all(c["ok"] for c in calls)}


def hybrid_train_phase(dev):
    """zamba2-1.2b at full width and depth trains on the card (nothing
    cut): random bf16 weights drawn on the card from SEED, batches of
    TRAIN_BATCH x TRAIN_SEQ.  On one batch, the kernel path against (1)
    the plain path (attention, rmsnorm and SSD "ref") at the training
    gates, and (2) the kernel forward with the plain SSD backward in
    place of the kernel's (the forward bitwise the same): each backward
    call's kernel outputs within SSD_REL_TOL of the plain ones on the
    same inputs, which the planted SSD-backward faults must fail, and
    every Mamba leaf within TRAIN_GRAD_REL_TOL (faults recorded there).
    Then ``train_steps``: launches per step must be
    2 x 38 forward (the recompute of remat included) and 38 backward.
    MFU counts the shared block once per invocation and the SSD scan's
    multiply-adds, forward and backward (``ssd_work``)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.models.zamba import n_attn_invocations
    from repro_torch.train_lib import loss_and_grads
    cfg = get_arch(HYBRID_ARCH)
    model = build_model(cfg)
    params = model.init(SEED, device=dev, dtype="bfloat16")
    n_params = sum(p.numel() for p in tree_leaves(params))
    inv = n_attn_invocations(cfg)
    shared = sum(p.numel() for p in params["shared"].values())
    n_flop = n_params + (inv - 1) * shared
    b0 = train_batch(cfg, dev, 0)
    mamba_leaves = tuple(f"mamba/{k}" for k in params["mamba"])

    # (1) the kernel path against the plain path
    plain = build_model(dataclasses.replace(cfg, attn_impl="ref",
                                            norm_impl="ref", ssm_impl="ref"))
    lp, _, gp = loss_and_grads(plain, params, b0)
    lp = float(lp)
    vs_plain = loss_grads_against(model, params, b0, lp, gp)
    vs_plain["ok"] = vs_plain.pop("within") and math.isfinite(lp)
    print(json.dumps({"hybrid_train_vs_plain": vs_plain}), flush=True)
    del gp

    # (2) the plain SSD backward in place of the kernel's, held at the op
    # and at the Mamba leaves; then each planted fault the same way
    probe, calls = ssd_backward_probe()
    lr, _, gr = with_patches([(ssd_ops, "ssd_scan_bwd", probe)],
                             lambda: loss_and_grads(model, params, b0))
    lr = float(lr)
    kw = dict(loss_tol=MOE_GATE_LOSS_TOL, leaves=mamba_leaves)
    bwd = loss_grads_against(model, params, b0, lr, gr, **kw)
    bwd["op"] = op_summary(calls)
    bwd["ok"] = bwd.pop("within") and bwd["op"]["ok"]
    print(json.dumps({"hybrid_train_vs_plain_ssd_backward": bwd}), flush=True)
    bwd["controls"] = []
    for fault in SSD_TRAIN_FAULTS:
        probe, calls = ssd_backward_probe(fault)
        r = loss_grads_against(model, params, b0, lr, gr,
                               [(ssd_ops, "ssd_scan_bwd", probe)], **kw)
        op = op_summary(calls)
        row = {"fault": fault, "caught": not op["ok"],
               "op_tol_used": op["tol_used"],
               "leaves_caught": not r["within"],
               "grad_rel_max": r["grad_rel_max"],
               "grad_rel_max_leaf": r["grad_rel_max_leaf"]}
        print(json.dumps({"train_fault": row}), flush=True)
        bwd["controls"].append(row)
    del gr
    checks = {"vs_plain": vs_plain, "vs_plain_ssd_backward": bwd}
    s = cfg.ssm
    ssd_macs = sum(sum(w.values()) for w in ssd_work(
        TRAIN_BATCH, TRAIN_SEQ, s.expand * cfg.d_model // s.head_dim,
        s.chunk_size, s.head_dim, s.state_size))
    out, failures = train_steps(model, params, cfg, dev, HYBRID_TRAIN_KERNELS,
                                n_flop, "hybrid_train", attn_layers=inv,
                                extra_flops=2 * ssd_macs * cfg.n_layers)
    out = {"arch": HYBRID_ARCH, "params": n_params,
           "flop_params": n_flop, **out, **checks}
    want = {"ssd_scan": 2 * cfg.n_layers, "ssd_scan_bwd": cfg.n_layers}
    for k, v in want.items():
        if out["launches_per_step"][k] != v:
            failures.append(f"hybrid training: {k} launched "
                            f"{out['launches_per_step'][k]} times per step, "
                            f"expected {v}")
    for name, r in checks.items():
        if not r["ok"]:
            failures.append(f"hybrid training {name}: loss_rel "
                            f"{r['loss_rel']}, worst grad_rel "
                            f"{r['grad_rel_max']} ({r['grad_rel_max_leaf']})")
    failures += [f"hybrid training: planted fault '{f['fault']}' passed the "
                 f"SSD backward's op gate"
                 for f in checks["vs_plain_ssd_backward"]["controls"]
                 if not f["caught"]]
    return out, failures


# ------------------ the xLSTM, Whisper and VLM families ---------------------

XLSTM_ARCH, WHISPER_ARCH, VLM_ARCH = "xlstm-125m", "whisper-base", \
    "internvl2-76b"
# internvl2-76b at full width with its 80 layers cut to VLM_LAYERS: 3.81 B
# parameters, whose weights, fp32 masters and moments fit one card (the
# 80 layers hold 70.6 B; the vision frontend is a stub)
VLM_LAYERS = 2
FAM_REQUESTS, FAM_GEN, FAM_STEPS = 8, 32, 3
# prompt tokens a request (the VLM's after its 256 patches), and the
# training batch (b, tokens a row; the VLM's rows are 256 patches + 1 792
# tokens = 2 048 positions)
FAM_PROMPT = {XLSTM_ARCH: 512, WHISPER_ARCH: 32, VLM_ARCH: 256}
FAM_TRAIN = {XLSTM_ARCH: (4, 512), WHISPER_ARCH: (8, 448),
             VLM_ARCH: (2, 2048 - 256)}
# whisper: 30 s of audio after its convolutions is 1 500 encoder frames,
# and 448 tokens its decoder's context
WHISPER_FRAMES = 1500
# Whisper's encoder output (a bf16 layernorm output after 6 layers) held
# row by row against the plain path's: each row's max |difference| over
# its max |x|.  On an H100 the sound path's worst of 12 000 rows read
# 2.19e-2 and "encoder run causal" 0.564 (0.02-scale frames; 1.89e-2 and
# 0.171 at unit scale): the limit sits ~2.7x above the one and ~9x below
# the other
WHISPER_ENC_TOL = 6e-2
WHISPER_TRAIN = FAM_TRAIN[WHISPER_ARCH]
# (serving, training) kernels of each family's path: xLSTM's only
# kernel is the final rmsnorm (its blocks' norms are inline, as in JAX);
# whisper's norms are layernorm (plain, as for gpt2)
FAM_KERNELS = {
    XLSTM_ARCH: (("rmsnorm",), ("rmsnorm", "rmsnorm_bwd")),
    WHISPER_ARCH: (("flash_attention", "paged_chunk_attention"),
                   ("flash_attention", "flash_attention_bwd_dkv",
                    "flash_attention_bwd_dq")),
    VLM_ARCH: (DENSE_SERVING_KERNELS, TRAIN_KERNELS)}


def family_config(arch):
    import dataclasses as dc
    from repro_torch.configs.registry import get_arch
    cfg = get_arch(arch)
    return dc.replace(cfg, n_layers=VLM_LAYERS) if arch == VLM_ARCH else cfg


def family_batch(cfg, b, s, step, train):
    """``data.synthetic.batch_for_model``'s batch of ``b`` rows of ``s``
    tokens (with labels when ``train``) at ``step`` from SEED: the VLM's
    256 patch rows ahead of them, Whisper's frames WHISPER_FRAMES long
    (30 s of audio after its convolutions, not the token length)."""
    from repro_torch.data.synthetic import batch_for_model
    kind = "train" if train else "prefill"
    if cfg.family == "vlm":
        return batch_for_model(cfg, kind, step, b,
                               cfg.n_frontend_tokens + s, SEED)
    out = batch_for_model(cfg, kind, step, b, s, SEED)
    if cfg.family == "audio":
        out["frames"] = batch_for_model(cfg, kind, step, b, WHISPER_FRAMES,
                                        SEED)["frames"]
    return out


def on_device(batch, dev):
    import torch
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def family_serve(model, params, batch, dev):
    """One lockstep serving run of ``batch`` (FAM_GEN greedy tokens):
    Whisper through ``serve_lib.BatchServer``, the others through
    ``launch.serve._serve_dense``; the launch counters zeroed before and
    read after.  Returns (tokens (b, gen), record)."""
    import types

    import numpy as np
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.serve_lib import BatchServer
    from repro_torch.telemetry import (TraceWriter, install_writer, now,
                                       uninstall_writer)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = now()
    if model.cfg.family == "audio":
        srv = BatchServer(model, params, None, device=dev)
        toks, _ = srv.serve(batch, gen=FAM_GEN)
        secs = now() - t0
        st = srv.stats
        lat = {k: st[k] for k in ("ttft_p50", "ttft_p95", "tpot_p50",
                                  "tpot_p95")}
        via = "serve_lib.BatchServer"
    else:
        writer = TraceWriter()
        install_writer(writer)
        try:
            toks = serve._serve_dense(model, params, batch,
                                      types.SimpleNamespace(
                                          gen=FAM_GEN, metrics=False), dev)
        finally:
            uninstall_writer()
        secs = now() - t0
        spans = {n: [e["dur"] / 1e6 for e in writer.events
                     if e["name"] == n]
                 for n in ("serve.dense_prefill", "serve.dense_decode")}
        tpot = np.asarray(spans["serve.dense_decode"])
        ttft = spans["serve.dense_prefill"][0]
        lat = {"ttft_p50": ttft, "ttft_p95": ttft,
               "tpot_p50": float(np.percentile(tpot, 50)),
               "tpot_p95": float(np.percentile(tpot, 95))}
        via = "launch.serve._serve_dense"
    torch.cuda.synchronize()
    counts = launch_counts()
    b = toks.shape[0]
    rec = {"via": via, "requests": b, "new_tokens_each": FAM_GEN,
           "seconds": secs, "tokens_per_s": b * FAM_GEN / secs,
           **{f"{k}_s": v for k, v in lat.items()}, "launches": counts}
    return np.asarray(toks), rec


def dense_forced(model, params, batch, forced, dev, n_ticks):
    """First-token logits of a fresh whole-prompt chunk and ``n_ticks``
    decode ticks fed ``forced`` tokens through the dense chunk API; fp32
    logits (1 + n_ticks, b, V)."""
    import torch
    cfg = model.cfg
    tb = on_device(batch, dev)
    tok, pos, emb = model.prompt_inputs(params, tb)
    b, s = pos.shape
    state = model.init_seq_state(params, s + n_ticks + 1, batch=tb,
                                 batch_size=b, dtype=cfg.compute_dtype,
                                 device=dev)
    state, logits = model.forward(params, state, tok, pos, embeds=emb,
                                  fresh=True)
    out = [logits.float()]
    for t in range(n_ticks):
        tk = torch.as_tensor([[int(f[t])] for f in forced],
                             dtype=torch.int32, device=dev)
        p = torch.full((b, 1), s + t, dtype=torch.int32, device=dev)
        state, logits = model.forward(params, state, tk, p)
        out.append(logits.float())
    return torch.stack(out)


def prompt_logits(model, params, batch, dev):
    """Logits (b, s, V) of every prompt token's row (the VLM's patch rows
    left out) from one fresh whole-prompt chunk."""
    tb = on_device(batch, dev)
    tok, pos, emb = model.prompt_inputs(params, tb)
    b, t = pos.shape
    state = model.init_seq_state(params, t, batch=tb, batch_size=b,
                                 dtype=model.cfg.compute_dtype, device=dev)
    _, logits = model.forward(params, state, tok, pos, embeds=emb,
                              fresh=True, all_logits=True)
    return logits[:, -tb["tokens"].shape[1]:]


def prompt_gate(got, ref, tol=E2E_REL_TOL):
    """got / ref (b, rows, n).  Each row's max |got - ref| over max |ref|
    of that row: the worst row (the first token's, the last prompt row,
    among them) must lie within ``tol``, every value finite.  Each
    request's max |got - ref| over its max |ref| (as ``logit_rows``
    holds a logits set) is reported beside it."""
    import torch
    diff = [(g.float() - r.float()).abs().amax(-1) for g, r in zip(got, ref)]
    scale = [r.float().abs().amax(-1) for r in ref]
    rel = torch.stack([d / m for d, m in zip(diff, scale)])      # (b, s)
    req = torch.stack([d.max() / m.max() for d, m in zip(diff, scale)])
    finite = bool(all(torch.isfinite(g).all() for g in got))
    return {"first_token_rel": float(rel[:, -1].max()),
            "worst_row_rel": float(rel.max()),
            "worst_request_rel": float(req.max()),
            "rows": rel.numel(), "tol": tol, "finite": finite,
            "ok": float(rel.max()) <= tol and finite}


def mlstm_carry_reset():
    """The mLSTM chunk scan with its carried state reset between chunks
    (each chunk after a call's first starts from a fresh cell)."""
    import torch
    from repro_torch.models import xlstm
    good = xlstm.mlstm_chunked

    def faulty(q, k, v, ig, lf, chunk, state=None):
        c = min(chunk, q.shape[1])
        outs = []
        for lo in range(0, q.shape[1], c):
            o, state = good(*(t[:, lo:lo + c] for t in (q, k, v, ig, lf)),
                            chunk, state=state if lo == 0 else None)
            outs.append(o)
        return torch.cat(outs, 1), state
    return [(xlstm, "mlstm_chunked", faulty)]


def slstm_r_dropped():
    """sLSTM's recurrent term R h_{t-1} dropped (R = 0)."""
    import torch
    from repro_torch.models import xlstm
    good = xlstm.slstm_scan
    return [(xlstm, "slstm_scan",
             lambda zx, ix, fx, ox, R, state=None: good(
                 zx, ix, fx, ox, torch.zeros_like(R), state=state))]


def attention_made_causal(cross):
    """Whisper's cross-attention (``cross``: sq != skv) or its encoder
    (sq = skv) run causal, q_offset 0 as ``attention_core`` passes it."""
    from repro_torch.models import attention
    good = attention.attention_core

    def faulty(cfg, q, k, v, *, causal=True, **kw):
        if not causal and (q.shape[1] != k.shape[1]) == cross:
            causal = True
        return good(cfg, q, k, v, causal=causal, **kw)
    return [(attention, "attention_core", faulty)]


def patches_dropped(model):
    """The VLM's prompt without its patch rows (the tokens alone at
    positions 0 ..)."""
    from repro_torch.models.model_api import arange_positions

    def faulty(params, batch):
        x = model._embed(params, batch["tokens"])
        b, s = x.shape[:2]
        return None, arange_positions(b, s, device=x.device), x
    return [(model, "prompt_inputs", faulty)]


# each family's planted faults: {fault: (the gate it must fail, patches
# of the model)}; "logits": ``prompt_gate`` on every prompt row within
# E2E_REL_TOL, "encoder": on every row of Whisper's encoder output (b,
# 1 500 frames, 512) within WHISPER_ENC_TOL
FAM_FAULTS = {
    XLSTM_ARCH: {"mLSTM chunk carry reset between chunks":
                 ("logits", lambda m: mlstm_carry_reset()),
                 "sLSTM recurrent term R dropped":
                 ("logits", lambda m: slstm_r_dropped())},
    WHISPER_ARCH: {"cross-attention run causal":
                   ("logits", lambda m: attention_made_causal(True)),
                   "encoder run causal":
                   ("encoder", lambda m: attention_made_causal(False))},
    VLM_ARCH: {"patches dropped from the prompt":
               ("logits", patches_dropped)}}


def encoder_rows(model, params, batch, dev):
    """Whisper's encoder output (b, se, d) on ``batch``'s frames."""
    import torch
    frames = torch.as_tensor(batch["frames"], device=dev)
    return model._encode(params, frames, remat=False)


def family_flops(cfg, params, b, s):
    """Model FLOPs of one training step (forward and backward, 3x the
    forward's products): 6 N T for the weights (Whisper: the encoder's
    and the cross K/V projections' over the frames, the rest over the
    tokens), 12 h d for each attention pair (Whisper: the encoder's
    pairs, the decoder's causal ones and the cross pairs), and xLSTM's
    mLSTM chunk products (q k^T and W v within a chunk, C q and k v^T
    across: 4 h c dh + 4 h dh^2 a token each way) and sLSTM recurrences
    (8 h dh^2 a token)."""
    from repro_torch.models.params import tree_leaves
    n = sum(x.numel() for x in tree_leaves(params))
    if cfg.family == "audio":
        dec = params["decoder"]
        n_xkv = dec["xattn_wk"].numel() + dec["xattn_wv"].numel()
        n_enc = sum(x.numel() for x in tree_leaves(params["encoder"])) + \
            sum(x.numel() for x in tree_leaves(params["enc_final"]))
        n_tok = n - n_enc - n_xkv
        se = WHISPER_FRAMES
        hd = cfg.n_heads * cfg.head_dim
        pairs = cfg.encoder_layers * se * se + cfg.n_layers * (
            causal_pairs(s, s, 0, s) + s * se)
        return 6 * b * ((n_enc + n_xkv) * se + n_tok * s) + \
            12 * hd * b * pairs
    if cfg.family == "ssm":
        d_in = cfg.ssm.expand * cfg.d_model
        h, dh = cfg.n_heads, d_in // cfg.n_heads
        c = min(cfg.ssm.chunk_size, s)
        dhs = cfg.d_model // cfg.n_heads
        n_m = cfg.block_pattern.count("m")
        n_s = cfg.block_pattern.count("s")
        cells = n_m * (4 * h * c * dh + 4 * h * dh * dh) + \
            n_s * 8 * h * dhs * dhs
        return 6 * n * b * s + 3 * cells * b * s
    t = s + cfg.n_frontend_tokens
    return 6 * n * b * t + 12 * cfg.n_layers * cfg.n_heads * \
        cfg.head_dim * b * causal_pairs(t, t, 0, t)


def family_phase(arch, dev):
    """One family at full width (internvl2-76b with VLM_LAYERS layers),
    random bf16 weights drawn once on the card from SEED.  Serving:
    FAM_REQUESTS requests, FAM_GEN greedy tokens, the kernel path timed
    with its launches counted (every serving kernel of the family must
    launch), the plain path (attn_impl / norm_impl "ref") on the same
    batch; gate (i) ``stream_gate`` on every stream; every prompt row's
    logits against the plain path's within E2E_REL_TOL (``prompt_gate``;
    Whisper's encoder output rows too) and the family's planted faults
    (``FAM_FAULTS``), each of which must fail its gate.  Training: the
    kernel path's loss and gradients against the plain path's
    (TRAIN_LOSS_REL_TOL, TRAIN_GRAD_REL_TOL), then FAM_STEPS AdamW steps
    through ``parallel.plan.make_train_step`` (remat), every training
    kernel launched.  Returns (record, failures)."""
    import numpy as np
    import torch
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.telemetry import now
    from repro_torch.train_lib import loss_and_grads
    cfg = family_config(arch)
    model = build_model(cfg)
    plain = build_model(dataclasses.replace(cfg, attn_impl="ref",
                                            norm_impl="ref"))
    params = model.init(SEED, device=dev, dtype="bfloat16")
    n_params = sum(x.numel() for x in tree_leaves(params))
    serve_kernels, train_kernels = FAM_KERNELS[arch]
    failures, parts = [], {}
    torch.cuda.reset_peak_memory_stats(dev)

    # serving
    batch = family_batch(cfg, FAM_REQUESTS, FAM_PROMPT[arch], 0, False)
    toks, serve = family_serve(model, params, batch, dev)
    t0 = now()
    print(json.dumps({"family_serve": arch, **serve}), flush=True)
    dead = [k for k in serve_kernels if serve["launches"][k] <= 0]
    if dead:
        failures.append(f"{arch} serving: kernels never launched: {dead}")
    plain_toks, _ = family_serve(plain, params, batch, dev)

    def forced(idx, streams, n_ticks):
        sub = {k: v[idx] for k, v in batch.items()}
        return dense_forced(model, params, sub, streams, dev, n_ticks)
    gate_i = stream_gate(model, params, None, list(plain_toks), list(toks),
                         dev, E2E_REL_TOL, forced=forced, arch=arch)
    print(json.dumps({"family_gate_i": gate_i}), flush=True)
    if not gate_i["ok"]:
        failures.append(f"{arch} serving: gate (i) failed: {gate_i}")
    parts["serve_gate_i"] = now() - t0
    t0 = now()
    gates = {"logits": (prompt_logits, E2E_REL_TOL)}
    if cfg.family == "audio":
        gates["encoder"] = (encoder_rows, WHISPER_ENC_TOL)
    refs = {g: fn(plain, params, batch, dev)
            for g, (fn, _) in gates.items()}
    sound = {g: prompt_gate(fn(model, params, batch, dev), refs[g], tol)
             for g, (fn, tol) in gates.items()}
    for g, r in sound.items():
        print(json.dumps({"family_gate": g, "arch": arch, **r}), flush=True)
        if not r["ok"]:
            failures.append(f"{arch} serving: {g} gate {r}")
    controls = []
    for fault, (gate, patches) in FAM_FAULTS[arch].items():
        row = {"fault": fault, "gate": gate}
        for g, (fn, tol) in gates.items():
            r = prompt_gate(with_patches(patches(model), lambda: fn(
                model, params, batch, dev)), refs[g], tol)
            row[g] = {k: r[k] for k in ("worst_row_rel", "first_token_rel",
                                        "worst_request_rel")}
            if g == gate:
                row["caught"] = not r["ok"]
        print(json.dumps({"family_fault": arch, **row}), flush=True)
        controls.append(row)
        if not row["caught"]:
            failures.append(f"{arch}: planted fault '{fault}' passed the "
                            f"{gate} gate")
    del refs
    parts["serve_faults"] = now() - t0
    serve_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    torch.cuda.empty_cache()

    # training
    b, s = FAM_TRAIN[arch]

    def batch_fn(i):
        return on_device(family_batch(cfg, b, s, i, True), dev)
    t0 = now()
    b0 = batch_fn(0)
    lp, _, gp = loss_and_grads(plain, params, b0)
    lp = float(lp)
    vs_plain = loss_grads_against(model, params, b0, lp, gp)
    vs_plain["ok"] = vs_plain.pop("within") and math.isfinite(lp)
    del gp, b0
    print(json.dumps({"family_train_vs_plain": arch, **{
        k: vs_plain[k] for k in ("loss_kernel", "loss_ref", "loss_rel",
                                 "grad_rel_max", "grad_rel_max_leaf",
                                 "ok")}}), flush=True)
    if not vs_plain["ok"]:
        failures.append(f"{arch} training kernel vs plain: loss_rel "
                        f"{vs_plain['loss_rel']}, worst grad_rel "
                        f"{vs_plain['grad_rel_max']} "
                        f"({vs_plain['grad_rel_max_leaf']})")
    flops = family_flops(cfg, params, b, s)
    tokens = b * (s + cfg.n_frontend_tokens)
    parts["train_gates"] = now() - t0
    t0 = now()
    train, tf = train_steps(model, params, cfg, dev, train_kernels,
                            n_params, f"{arch}_train", steps=FAM_STEPS,
                            batch_fn=batch_fn, tokens=tokens, flops=flops)
    parts["train_steps_and_profile"] = now() - t0
    del params
    torch.cuda.empty_cache()
    failures += tf
    train.update(batch=b, seq=s + cfg.n_frontend_tokens,
                 vs_plain=vs_plain)
    return {"arch": arch, "layers": cfg.n_layers, "params": n_params,
            "serve": serve, "serve_peak_mem_gb": serve_peak,
            "gate_i": gate_i, "logits": sound["logits"],
            "encoder": sound.get("encoder"), "controls": controls,
            "train": train, "seconds_by_part": parts,
            "tokens_equal_to_plain": int(np.all(toks == plain_toks, 1).sum())
            }, failures


def families_phase(dev):
    """xlstm-125m and whisper-base at full size, internvl2-76b at full
    width with VLM_LAYERS of its 80 layers: ``family_phase`` each."""
    out, failures = {}, []
    for arch in (XLSTM_ARCH, WHISPER_ARCH, VLM_ARCH):
        out[arch], f = family_phase(arch, dev)
        failures += f
    return out, failures


# ---------------------------------- main ------------------------------------



# ---------------------- int8 quantize / dequantize --------------------------

# the gpt2-medium DDP path's int8 weak phase: each rank's weak shard of a
# 25 MB bf16 bucket holds 25 MiB / 2 B / 4 strong ranks = 3 276 800
# elements, and the whole gradient's weak shards 353 553 408 / 4
QBLOCK = 256
BUCKET_SHARD = 25 * 1024 * 1024 // 2 // 4
WEAK_PAYLOAD = 353_553_408 // 4


def _quant_plain(x, fault=None):
    """The plain quantizer (``quant_comm.ref``'s arithmetic, written out
    so that a planted fault can change one step of it)."""
    import torch
    n = x.shape[0]
    xb = x.reshape(n // QBLOCK, QBLOCK).float()
    amax = xb.abs()
    if fault and "half the block" in fault:
        amax = amax[:, :QBLOCK // 2]
    scale = amax.amax(dim=1, keepdim=True) * torch.tensor(1 / 127,
                                                          dtype=torch.float32)
    den = torch.clamp(scale, min=1e-12)
    if fault == "x * (1/scale) in place of division":
        r = torch.round(xb * (1.0 / den))
    elif fault == "truncation in place of half-even rounding":
        r = torch.trunc(xb / den)
    else:
        r = torch.round(xb / den)
    if fault != "absmax over half the block, clip at ±127 dropped":
        r = torch.clamp(r, -127, 127)
    return r.to(torch.int8).reshape(n), scale[:, 0]


def _quant_library(x):
    """The nearest PyTorch composition (no one call quantizes
    blockwise): view -> abs().amax -> mul -> div -> round -> clamp ->
    to(int8)."""
    import torch
    xb = x.view(-1, QBLOCK).float()
    s = xb.abs().amax(dim=1, keepdim=True) * (1 / 127)
    q = (xb / s.clamp(min=1e-12)).round().clamp(-127, 127).to(torch.int8)
    return q, s


def _dequant_library(q, s, dtype):
    """to(float) -> mul, in the output dtype."""
    import torch
    return (q.view(-1, QBLOCK).to(torch.float32) * s[:, None]).to(dtype)


def quant_inputs(dev, kind, n, dtype, seed=9):
    """Gradient-like values (normal times a log-normal spread), blocks of
    zeros, or values on k + 0.5 code boundaries of their block's scale
    (the absmax planted in each block's last element)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    if kind == "boundary":
        nb = n // QBLOCK
        A = torch.exp(torch.rand(nb, 1, device=dev, generator=g) * 9 - 6)
        s = A * torch.tensor(1 / 127, dtype=torch.float32)
        k = torch.randint(-127, 127, (nb, QBLOCK), device=dev, generator=g)
        x = (k.float() + 0.5) * s
        x[:, -1] = A[:, 0]
        return x.reshape(-1).to(dtype)
    x = torch.randn(n, device=dev, generator=g) * torch.exp(
        torch.randn(n, device=dev, generator=g))
    if kind == "zeros":
        x.view(-1, QBLOCK)[::3] = 0
    return x.to(dtype)


def bitwise(got, ref):
    """A bitwise gate: max |difference| (0 when the bits agree), and
    tol_used 0 or inf."""
    import torch
    same = all(torch.equal(a, b) for a, b in zip(got, ref))
    err = max(float((a.float() - b.float()).abs().max()) if a.numel() else
              0.0 for a, b in zip(got, ref))
    return err, (0.0 if same else math.inf), same


def check_quant(dev, kind, n, dtype, pad_to=1):
    """quantize and dequantize (to fp32 and to bf16) against the plain
    versions on the same inputs, bitwise; planted faults must differ:
    truncation, the reciprocal multiply (boundary case), the absmax over
    half the block with and without the clip at ±127 (there the block's
    absmax is not among the values the faulty max saw, so only the clip
    keeps the codes in range; with the block's own absmax no finite input
    reaches the clip: |x| / fl(A fl(1/127)) <= 127 (1 + 2^-22)), and the
    dequantize with each block scaled by its neighbour's scale."""
    import torch
    from repro_torch.core.compression import _padded
    from repro_torch.kernels.quant_comm import (dequantize, dequantize_ref,
                                                quantize, quantize_ref)
    x = quant_inputs(dev, kind, n, dtype)
    if pad_to > 1:                 # the int8 wire's padding (int8_psum)
        x, _ = _padded(x, pad_to, keep=(dtype,))
    n = x.shape[0]
    q, s = quantize(x)
    rq, rs = quantize_ref(x)
    err, used, ok = bitwise((q, s), (rq, rs))
    faults = ["truncation in place of half-even rounding",
              "absmax over half the block, clip kept",
              "absmax over half the block, clip at ±127 dropped"]
    if kind == "boundary":
        faults.append("x * (1/scale) in place of division")
    ctl = []
    for f in faults:
        fe, fu, fok = bitwise((q, s), _quant_plain(x, f))
        ctl.append({"fault": f, "max_abs_err": fe, "tol_used": fu,
                    "caught": not fok, "codes_differing":
                    int((q != _quant_plain(x, f)[0]).sum())})
    case = f"{kind} n={n} {str(dtype).split('.')[-1]}"
    fwd = {"case": case, "max_abs_err": err, "tol_used": used, "ok": ok,
           "codes_differing": int((q != rq).sum()), "controls": ctl}
    in_b = x.element_size()
    for rec, fn, plain, lib, nbytes in (
            (fwd, lambda: quantize(x), lambda: quantize_ref(x),
             lambda: _quant_library(x), n * (in_b + 1) + n // QBLOCK * 4),):
        rec.update(_quant_times(fn, plain, lib, nbytes, n))
    bwd = []
    for out_dtype in (torch.bfloat16, torch.float32):
        d = dequantize(q, s, out_dtype=out_dtype)
        rd = dequantize_ref(q, s, out_dtype)
        e2, u2, ok2 = bitwise((d,), (rd,))
        fd = dequantize_ref(q, torch.roll(s, 1), out_dtype)
        fe, fu, fok = bitwise((d,), (fd,))
        rec = {"case": f"{case} -> {str(out_dtype).split('.')[-1]}",
               "max_abs_err": e2, "tol_used": u2, "ok": ok2, "controls": [
                   {"fault": "each block scaled by its neighbour's scale",
                    "max_abs_err": fe, "tol_used": fu, "caught": not fok}]}
        out_b = d.element_size()
        rec.update(_quant_times(
            lambda: dequantize(q, s, out_dtype=out_dtype),
            lambda: dequantize_ref(q, s, out_dtype),
            lambda: _dequant_library(q, s, out_dtype),
            n * (1 + out_b) + n // QBLOCK * 4, n))
        bwd.append(rec)
    return fwd, bwd


def _quant_times(fn, plain, lib, nbytes, n):
    b_ms, b_by = bound(nbytes, 4 * n, "fp32")
    return {"ms": time_ms(fn), "host_ms": host_ms(fn),
            "plain_ms": time_ms(plain), "library_ms": time_ms(lib),
            "library_covers": "the nearest PyTorch composition (no one "
                              "call quantizes blockwise), the same ops as "
                              "the plain version",
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}


QUANT_CASES = [dict(kind="gradient", n=BUCKET_SHARD, dtype="bfloat16"),
               dict(kind="gradient", n=BUCKET_SHARD, dtype="float32"),
               dict(kind="gradient", n=WEAK_PAYLOAD, dtype="bfloat16",
                    pad_to=2 * QBLOCK),
               dict(kind="zeros", n=QBLOCK * 4096, dtype="float32"),
               dict(kind="boundary", n=QBLOCK * 4096, dtype="float32")]


def quant_phase(dev):
    """Both quant_comm kernels at the int8 weak phase's shapes: one
    bucket's weak shard (bf16, as the path quantizes it, and fp32), the
    whole per-rank weak payload padded as the wire pads it, blocks of
    zeros and values on code boundaries; then a length only the
    wrapper's padding takes (``int8_roundtrip``)."""
    import torch
    from repro_torch.core.compression import int8_roundtrip
    cases = {"quantize": [], "dequantize": []}
    for kw in QUANT_CASES:
        kw = dict(kw, dtype=getattr(torch, kw["dtype"]))
        fwd, bwd = check_quant(dev, **kw)
        cases["quantize"].append(fwd)
        cases["dequantize"] += bwd
        torch.cuda.empty_cache()
    x = quant_inputs(dev, "gradient", 1_000_003, torch.float32)
    err, used, ok = bitwise((int8_roundtrip(x),),
                            (int8_roundtrip(x, impl="ref"),))
    cases["quantize"].append({"case": "int8_roundtrip n=1000003 -> "
                              "1000192 by the wrapper", "max_abs_err": err,
                              "tol_used": used, "ok": ok, "controls": []})
    return cases


# ------------------- HaiScale DDP: gpt2-medium, 8 ranks ---------------------

# gpt2-medium (the paper's own HaiScale DDP model, Fig. 8) at full width
# and depth trains as 8 ranks sharing the card: 2 pods x 4 data, each
# rank a batch of 2 x 1024 tokens (global 16 x 1024), collectives staged
# through pinned host memory over gloo (HFReduce's own path)
DDP_ARCH = "gpt2-medium"
DDP_PODS, DDP_DATA = 2, 4
# 2 timed steps a wire: every kernel's launches per step within the
# script's time limit (the gates read step 1's gradient)
DDP_BATCH, DDP_SEQ, DDP_STEPS = 2, 1024, 1
DDP_WIRES = ("", "bf16", "fp8", "int8")
# gate (i), the synced uncompressed gradient against one process on the
# global batch: the training gates above (both sides bf16; the synced one
# adds 8 ranks' bf16 gradients in bf16 on the host)
DDP_FAULTS = {
    # fault -> the gate that must catch it
    "prescale dropped": "i",
    "one strong rank's shard left out of phase 3": "i",
    "a bucket's hook fires one leaf early": "ii",
}


def ddp_global_batch(cfg, i):
    from repro_torch.data.synthetic import batch_for_model
    return batch_for_model(cfg, "train", i, DDP_BATCH * DDP_PODS * DDP_DATA,
                           DDP_SEQ, seed=SEED)


def _early_hook_step():
    """A ``DDPStep`` whose first bucket starts its sync one leaf early:
    the bucket's last leaf has no gradient yet when the bucket is
    flattened, so it goes on the wire as zeros (what ``_flatten`` sends
    for a leaf without a gradient)."""
    from repro_torch.core.ddp import DDPStep

    class EarlyHookStep(DDPStep):
        def _flatten(self, leaves, b):
            if b == 0:
                i1 = self.ranges[0][1]
                leaves = leaves[:i1 - 1] + [leaves[i1 - 1].detach()] + \
                    leaves[i1:]
            return super()._flatten(leaves, b)
    return EarlyHookStep


def _ddp_fault(fault, grid):
    """(module, attribute, replacement) that plants ``fault`` in this
    rank's DDP path; the early hook is a subclass of the step
    (``_early_hook_step``), not a replacement."""
    import importlib
    ddp = importlib.import_module("repro_torch.core.ddp")
    # the module: the package's attribute of that name is the function
    hfreduce = importlib.import_module("repro_torch.core.hfreduce")
    if fault == "prescale dropped":
        orig = ddp.hfreduce
        return ddp, "hfreduce", lambda x, **kw: orig(x, **{**kw,
                                                          "prescale": None})
    orig = hfreduce.all_gather

    def gather(x, group):
        out = orig(x, group)
        if group is grid.strong:
            out[x.shape[0]:2 * x.shape[0]] = 0
        return out
    return hfreduce, "all_gather", gather


def _same_bits(a, b):
    import torch
    from repro_torch.models.params import tree_leaves
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                  tree_leaves(b)))


def _rel_leaves(got, ref):
    """Per leaf |g - ref| / |ref| (Frobenius); ``ref`` leaves on the
    host."""
    from repro_torch.models.params import tree_leaves
    out = []
    for g, r in zip(tree_leaves(got), ref):
        r = r.to(g.device).float()
        out.append(float((g.float() - r).norm() / r.norm().clamp(min=1e-30)))
    return out


def _int8_bound(grid, flats):
    """Gate (iv) on this rank's weak shards of every bucket (``flats``:
    the buckets of the real local gradient on the bf16 wire): the int8
    weak phase against the uncompressed one on the same prescaled shard,
    element by element within 1/2 (s_pod0 + s_pod1 + s_requant)
    (1 + 2^-8) + one bf16 ulp, where s_pod is each pod's 256-block scale
    (absmax fl(1/127)) of the int8 wire's padded shard and s_requant the
    reduced block's (max |out| / 127): half a code for each
    quantization, half a bf16 ulp for each side's final rounding.  Also
    times ``hfreduce`` over the whole gradient with each wire format
    (run c) and returns each one's relative distance to the
    uncompressed sync."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.compression import int8_psum, make_weak_psum
    from repro_torch.core.grid import all_gather, all_reduce, reduce_scatter
    from repro_torch.core.hfreduce import _pad_to, hfreduce
    from repro_torch.telemetry import now
    P, inv = grid.pods, torch.tensor(1.0 / grid.size, dtype=torch.bfloat16)
    worst, n_el = 0.0, 0
    for flat in flats:
        shard = reduce_scatter(_pad_to(flat, grid.data)[0], grid.strong) * inv
        m = shard.shape[0]
        pad = (-m) % (P * QBLOCK)

        def blocks(v):
            return F.pad(v.float(), (0, pad)).reshape(-1, QBLOCK)
        u = blocks(all_reduce(shard, grid.weak))
        o = blocks(int8_psum(shard, grid.weak))
        X = F.pad(all_gather(shard, grid.weak).reshape(P, -1).float(),
                  (0, pad)).reshape(P, -1, QBLOCK)
        s_pods = (X.abs().amax(-1) * torch.tensor(1 / 127)).sum(0)
        del X
        half = 0.5 * (s_pods + o.abs().amax(-1) / 127) * (1 + 2 ** -8)
        ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(
            o.abs(), u.abs()).clamp(min=1e-30))) - 7)
        worst = max(worst, float(((o - u).abs() / (half[:, None] + ulp))
                                 .max()))
        n_el += m
        del u, o, ulp
    times, ref, sq = {}, None, {}
    for wire in DDP_WIRES:
        psum = make_weak_psum(wire)
        torch.cuda.synchronize()
        t0 = now()
        outs = [hfreduce(f, strong=grid.strong, weak=grid.weak,
                         weak_psum=psum, prescale=1.0 / grid.size)
                for f in flats]
        torch.cuda.synchronize()
        times[wire] = now() - t0
        if ref is None:
            ref = outs
        sq[wire] = sum(float((o.float() - r.float()).square().sum())
                       for o, r in zip(outs, ref))
        del outs
    norm = sum(float(r.float().square().sum()) for r in ref)
    return {"bound_used_max": worst, "ok": worst <= 1.0,
            "weak_elements": n_el, "hfreduce_s": times,
            "rel_to_uncompressed": {w: math.sqrt(v / norm)
                                    for w, v in sq.items()}}


def ddp_rank(grid, device, ref_path):
    """One rank of the DDP phase: the gates on step 1's synced gradient,
    then DDP_STEPS training steps with each of "" and "int8" (overlap
    on), then one step with overlap off.  Returns numbers only; rank 0
    also holds gate (i) against the one-process reference in
    ``ref_path``."""
    import statistics

    import torch
    from repro_torch import train_lib
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import bucketing
    from repro_torch.core import ddp as ddp_mod
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.parallel import ParallelPlan, init_state, \
        make_train_step
    from repro_torch.telemetry import get_registry, now
    dev = torch.device(device)
    cfg = get_arch(DDP_ARCH)
    model = build_model(cfg)
    ref = torch.load(ref_path) if grid.rank == 0 else None
    b0 = ddp_global_batch(cfg, 0)

    def opt():
        return AdamW(lr=warmup_cosine(3e-4, 2, DDP_STEPS))

    def step_of(compress, overlap=True, impl="auto"):
        return ddp_mod.make_ddp_train_step(
            model, opt(), grid, ParallelPlan(mode="ddp", compress=compress,
                                             overlap=overlap),
            device=dev, quant_impl=impl)

    def spans():
        reg = get_registry()
        return {k: reg.histogram(f"span.{k}").sum
                for k in ("ddp.sync", "ddp.wait", "train.step")}

    out = {"rank": grid.rank, "runs": {}}
    for compress in ("", "int8"):
        params = model.init(SEED, device=dev, dtype="bfloat16")
        on = step_of(compress)
        loss_on, _, g_on = on.loss_and_grads(params, b0)
        loss_off, _, g_off = step_of(compress, overlap=False).loss_and_grads(
            params, b0)
        run = {"buckets": len(on.ranges), "loss_step1": float(loss_on),
               "gate_ii": {"grads_bitwise": _same_bits(g_on, g_off),
                           "loss_bitwise": bool(loss_on == loss_off)}}
        del g_off
        if compress == "int8":
            _, _, g_ref = step_of(compress, impl="ref").loss_and_grads(
                params, b0)
            run["gate_iii"] = {"grads_bitwise": _same_bits(g_on, g_ref)}
            del g_ref, g_on
            _, _, local = train_lib.loss_and_grads(
                model, params, {k: torch.as_tensor(v[grid.rows(len(v))],
                                                   device=dev)
                                for k, v in b0.items()})
            leaves = tree_leaves(local)
            del local
            flats = [bucketing.flatten_leaves(leaves[i0:i1],
                                              on.bucket_plan.wire_dtype)
                     for i0, i1 in on.ranges]
            del leaves
            run["gate_iv"] = _int8_bound(grid, flats)
            del flats
        else:
            if ref is not None:
                run["gate_i"] = {"loss_rel": abs(float(loss_on) - ref["loss"])
                                 / abs(ref["loss"]),
                                 "grad_rel": _rel_leaves(g_on, ref["grads"])}
            faults = {}
            for fault, gate in DDP_FAULTS.items():
                if gate == "ii":
                    step = _early_hook_step()(
                        model, opt(), grid,
                        ParallelPlan(mode="ddp", compress=compress), dev)
                    _, _, fg = step.loss_and_grads(params, b0)
                else:
                    mod, attr, repl = _ddp_fault(fault, grid)
                    orig = getattr(mod, attr)
                    setattr(mod, attr, repl)
                    try:
                        _, _, fg = step_of(compress).loss_and_grads(params,
                                                                    b0)
                    finally:
                        setattr(mod, attr, orig)
                rec = {"gate": gate}
                if gate == "ii":
                    rec["grads_bitwise"] = _same_bits(fg, g_on)
                elif ref is not None:
                    rec["grad_rel"] = _rel_leaves(fg, ref["grads"])
                faults[fault] = rec
                del fg
            run["faults"] = faults
            del g_on
        torch.cuda.empty_cache()

        # training through the port's entry point (what launch/train.py
        # runs); counters and spans zeroed just before the steps
        o = opt()
        plan = ParallelPlan(mode="ddp", compress=compress)
        state = init_state(plan, o, params, grid=grid)
        del params
        step = make_train_step(plan, model, o, device=dev, grid=grid)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        get_registry().reset()
        reset_launch_counts()
        losses, times = [], []
        for i in range(DDP_STEPS):
            batch = ddp_global_batch(cfg, i)
            torch.cuda.synchronize()
            t0 = now()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            times.append(now() - t0)
        counts = launch_counts()
        run.update({"losses": losses, "step_s": times,
                    "train_step_spans":
                        get_registry().histogram("span.train.step").count,
                    "median_step_s": statistics.median(times),
                    "spans_s": spans(), "launches": counts,
                    "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9})
        # one more step with overlap off: every bucket's sync exposed
        off = make_train_step(
            ParallelPlan(mode="ddp", compress=compress, overlap=False),
            model, o, device=dev, grid=grid)
        get_registry().reset()
        torch.cuda.synchronize()
        t0 = now()
        state, m = off(state, ddp_global_batch(cfg, DDP_STEPS))
        float(m["loss"])
        run["no_overlap"] = {"step_s": now() - t0, "spans_s": spans()}
        out["runs"][compress or "uncompressed"] = run
        del state, step, off
        torch.cuda.empty_cache()
    return out


def ddp_phase(dev):
    """gpt2-medium at full width and depth trains with HaiScale DDP as
    DDP_PODS x DDP_DATA ranks sharing the card (``run_ranks``, gloo,
    host-staged).  First the parent takes the loss and gradient of one
    process on the whole global batch of step 1 (then frees it), the
    reference of gate (i); every rank then runs ``ddp_rank``.  Gates:
    (i) the synced uncompressed gradient within TRAIN_GRAD_REL_TOL per
    leaf and the loss within TRAIN_LOSS_REL_TOL; (ii) overlap on = off,
    gradients and loss bitwise, for "" and "int8"; (iii) the int8 sync
    through the kernels = through the plain versions, bitwise; (iv) int8
    against uncompressed within the quantization bound
    (``_int8_bound``); (v) the planted faults of DDP_FAULTS fail their
    gate.  Returns (results, failures)."""
    import statistics

    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.testing.multidev import run_ranks
    from repro_torch.train_lib import loss_and_grads
    cfg = get_arch(DDP_ARCH)
    model = build_model(cfg)
    params = model.init(SEED, device=dev, dtype="bfloat16")
    n_params = sum(p.numel() for p in tree_leaves(params))
    b0 = {k: torch.as_tensor(v, device=dev)
          for k, v in ddp_global_batch(cfg, 0).items()}
    loss, _, grads = loss_and_grads(model, params, b0)
    ref_dir = ROOT / "build" / "ddp_phase"
    ref_dir.mkdir(parents=True, exist_ok=True)
    ref_path = ref_dir / "reference.pt"
    torch.save({"loss": float(loss),
                "grads": [g.cpu() for g in tree_leaves(grads)]}, ref_path)
    names = _leaf_names(params)
    del params, grads, b0, loss
    torch.cuda.empty_cache()

    ranks = run_ranks(ddp_rank, DDP_PODS, DDP_DATA, device=str(dev),
                      staging="host", args=(str(ref_path),), timeout=600)
    ref_path.unlink()
    r0 = ranks[0][0]
    failures = []
    world = DDP_PODS * DDP_DATA
    tokens = world * DDP_BATCH * DDP_SEQ
    flops = 6 * n_params * tokens + 12 * cfg.n_layers * cfg.n_heads * \
        cfg.head_dim * world * DDP_BATCH * causal_pairs(DDP_SEQ, DDP_SEQ, 0,
                                                         DDP_SEQ)
    out = {"arch": DDP_ARCH, "params": n_params, "pods": DDP_PODS,
           "data": DDP_DATA, "batch_per_rank": DDP_BATCH, "seq": DDP_SEQ,
           "steps": DDP_STEPS, "model_flops_per_step": flops, "runs": {}}
    for key, run in r0["runs"].items():
        all_runs = [r["runs"][key] for r, _ in ranks]
        med = statistics.median(run["step_s"])
        gi = run.get("gate_i")
        summary = {
            "buckets": run["buckets"], "losses": run["losses"],
            "median_step_s": med, "tokens_per_s": tokens / med,
            "mfu_vs_bf16_dense_peak": flops / med / PEAK["bf16_tensor"],
            "peak_mem_gb_per_rank": max(r["peak_mem_gb"] for r in all_runs),
            "rank0_sync_s_per_step": run["spans_s"]["ddp.sync"] / DDP_STEPS,
            "rank0_exposed_wait_s_per_step":
                run["spans_s"]["ddp.wait"] / DDP_STEPS,
            "rank0_train_step_spans": run["train_step_spans"],
            "no_overlap": run["no_overlap"],
            "launches_per_step": {
                k: sum(r["launches"][k] for r in all_runs) / DDP_STEPS
                for k in ("quantize", "dequantize", "flash_attention",
                          "flash_attention_bwd_dkv",
                          "flash_attention_bwd_dq")},
            "launches": {k: sum(r["launches"][k] for r in all_runs)
                         for k in run["launches"]},
            "gate_ii": run["gate_ii"]}
        if not all(math.isfinite(x) for x in run["losses"]):
            failures.append(f"ddp {key}: losses not finite")
        for r in all_runs:
            if r["train_step_spans"] != DDP_STEPS:
                failures.append(f"ddp {key}: {r['train_step_spans']} of "
                                f"{DDP_STEPS} steps ran through "
                                "parallel.make_train_step")
            if not all(r["gate_ii"].values()):
                failures.append(f"ddp {key}: overlap on and off differ "
                                f"(gate ii): {r['gate_ii']}")
        if gi is not None:
            worst = max(range(len(gi["grad_rel"])),
                        key=lambda i: gi["grad_rel"][i])
            summary["gate_i"] = {
                "loss_rel": gi["loss_rel"],
                "grad_rel_max": gi["grad_rel"][worst],
                "grad_rel_max_leaf": names[worst],
                "ok": gi["loss_rel"] <= TRAIN_LOSS_REL_TOL and
                max(gi["grad_rel"]) <= TRAIN_GRAD_REL_TOL}
            if not summary["gate_i"]["ok"]:
                failures.append(f"ddp: synced gradient vs one process "
                                f"(gate i): {summary['gate_i']}")
            ctl = []
            for fault, rec in run["faults"].items():
                row = {"fault": fault, "gate": rec["gate"]}
                if rec["gate"] == "ii":
                    row["caught"] = not rec["grads_bitwise"]
                else:
                    row["grad_rel_max"] = max(rec["grad_rel"])
                    row["caught"] = row["grad_rel_max"] > TRAIN_GRAD_REL_TOL
                ctl.append(row)
                if not row["caught"]:
                    failures.append(f"ddp: planted fault '{fault}' passed "
                                    f"gate ({rec['gate']})")
            summary["controls"] = ctl
        if "gate_iii" in run:
            summary["gate_iii"] = run["gate_iii"]
            summary["gate_iv"] = {
                "bound_used_max": max(r["gate_iv"]["bound_used_max"]
                                      for r in all_runs),
                "hfreduce_s_rank0": run["gate_iv"]["hfreduce_s"],
                "rel_to_uncompressed": run["gate_iv"]["rel_to_uncompressed"]}
            for r in all_runs:
                if not r["gate_iii"]["grads_bitwise"]:
                    failures.append("ddp int8: kernels and plain versions "
                                    "differ (gate iii)")
                if not r["gate_iv"]["ok"]:
                    failures.append(f"ddp int8: outside the quantization "
                                    f"bound (gate iv): {r['gate_iv']}")
            for k in ("quantize", "dequantize"):
                if summary["launches"][k] <= 0:
                    failures.append(f"ddp int8: kernel {k} never launched "
                                    "on the DDP path")
        for k in ("flash_attention", "flash_attention_bwd_dkv",
                  "flash_attention_bwd_dq"):
            if summary["launches"][k] <= 0:
                failures.append(f"ddp {key}: kernel {k} never launched")
        out["runs"][key] = summary
        print(json.dumps({"ddp_run": key, **summary}), flush=True)
    return out, failures


# ------------- HaiScale pp: llama-13b at full width, 2 stages --------------

# the paper's Fig. 9(a) model (LLaMa-13B, pp 4, seq 2048) at full width,
# n_layers cut 40 -> 4 (2 a stage): the JAX contract's replicated state
# (the whole tree on every rank) is ~1.6 B parameters x 14 bytes ~ 22 GB a
# rank, and four stages, or two stages x two data ranks, would not fit the
# card.  Two ranks share the card over host-staged gloo, as the DDP phase's
PP_ARCH = "llama-13b"
PP_LAYERS, PP_STAGES = 4, 2
PP_BATCH, PP_SEQ, PP_MICRO, PP_STEPS = 8, 2048, 8, 2
PP_ROOT = ROOT / "build" / "pp_phase"
PP_SLOT_FAULT = "1F1B writes the slot before the backward reads it"
PP_FAULTS = {
    # fault -> (schedule it runs under, the gate that must catch it)
    PP_SLOT_FAULT: ("1f1b", "ii"),
    "a dropped cotangent send (the stage gets zeros)": ("1f1b", "i"),
    "gradients not divided by m": ("1f1b", "i"),
    "stage 1 slicing its layers at the wrong offset": ("1f1b", "i"),
}


def pp_config():
    from repro_torch.configs.registry import get_arch
    return dataclasses.replace(get_arch(PP_ARCH), n_layers=PP_LAYERS)


def pp_global_batch(cfg, i):
    from repro_torch.data.synthetic import batch_for_model
    return batch_for_model(cfg, "train", i, PP_BATCH, PP_SEQ, seed=SEED)


def pp_fault_step(fault):
    """A ``PPStep`` subclass that plants ``fault``."""
    import torch
    from repro_torch.models.params import tree_map
    from repro_torch.parallel.pp import PPStep

    if fault == PP_SLOT_FAULT:
        class Faulty(PPStep):
            # the backward reads the ring only after the tick's forward
            # has stored into it
            def _saved(self, ring, t):
                return lambda: PPStep._saved(self, ring, t)

            def _backward(self, t, x_saved, *args):
                return super()._backward(t, x_saved(), *args)
    elif fault.startswith("a dropped cotangent"):
        class Faulty(PPStep):
            def _exchange(self, t, send_f, send_b, like):
                f, b = super()._exchange(t, send_f, send_b, like)
                return f, None if b is None else torch.zeros_like(b)
    elif fault.startswith("gradients not divided"):
        class Faulty(PPStep):
            def _pipe_sum(self, *args):
                # the step's / m then leaves the microbatches' sum
                return tree_map(lambda g: g * self.m,
                                super()._pipe_sum(*args))
    else:
        class Faulty(PPStep):
            def _stage_params(self, layers):
                if self.grid.stage == 1:
                    return {k: v[:self.lps] for k, v in layers.items()}
                return super()._stage_params(layers)
    return Faulty


def pp_rank(grid, device, ref_path):
    """One rank of the pp phase: PP_STEPS steps under gpipe, then under
    1f1b, each from the same initial state through
    ``parallel.make_train_step`` with the optimizer recording the
    gradient it is handed; then one step of each planted fault.  Rank 0
    keeps host copies of gpipe's recorded gradients and holds the other
    runs against them bitwise (gate ii), and step 1's against the
    one-process reference in ``ref_path`` (gate i).  Returns numbers
    only."""
    import statistics

    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.parallel import ParallelPlan, init_state, \
        make_train_step
    from repro_torch.telemetry import get_registry, now
    from repro_torch.testing.multidev import _Recording
    dev = torch.device(device)
    cfg = pp_config()
    model = build_model(cfg)
    ref = torch.load(ref_path) if grid.rank == 0 else None
    keep = grid.rank == 0
    gpipe_grads = []

    def fresh(plan):
        opt = _Recording(AdamW(lr=warmup_cosine(3e-4, 2, PP_STEPS)))
        params = model.init(SEED, device=dev, dtype="bfloat16")
        return opt, init_state(plan, opt.opt, params, grid=grid)

    def gate_i(state, loss):
        if ref is None:
            return None
        return {"loss_rel": abs(loss - ref["loss"]) / abs(ref["loss"]),
                "grad_rel": _rel_leaves(state["synced"], ref["grads"])}

    def same_as_gpipe(state, i):
        if not keep:
            return None
        return all(torch.equal(g.cpu(), h) for g, h in
                   zip(tree_leaves(state["synced"]), gpipe_grads[i]))

    out = {"rank": grid.rank, "stage": grid.stage, "runs": {}}
    for schedule in ("gpipe", "1f1b"):
        plan = ParallelPlan(mode="pp", pp_schedule=schedule,
                            pp_microbatches=PP_MICRO)
        opt, state = fresh(plan)
        step = make_train_step(plan, model, opt, device=dev, grid=grid)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        get_registry().reset()
        reset_launch_counts()
        run = {"ticks": step_ticks(plan), "losses": [], "step_s": [],
               "bitwise_to_gpipe": []}
        for i in range(PP_STEPS):
            batch = pp_global_batch(cfg, i)
            torch.cuda.synchronize()
            t0 = now()
            state, m = step(state, batch)
            loss = float(m["loss"])
            run["step_s"].append(now() - t0)
            run["losses"].append(loss)
            if i == 0:
                run["gate_i"] = gate_i(state, loss)
            if keep and schedule == "gpipe":
                gpipe_grads.append([g.cpu() for g in
                                    tree_leaves(state["synced"])])
            elif schedule != "gpipe":
                run["bitwise_to_gpipe"].append(same_as_gpipe(state, i))
        reg = get_registry()
        run.update({
            "median_step_s": statistics.median(run["step_s"]),
            "launches": launch_counts(),
            "train_step_spans": reg.histogram("span.train.step").count,
            "spans_s": {k: reg.histogram(f"span.{k}").sum
                        for k in ("pp.send", "pp.grad_sum", "train.step")},
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9})
        out["runs"][schedule] = run
        del state, step, opt
        torch.cuda.empty_cache()

    faults = {}
    for fault, (schedule, gate) in PP_FAULTS.items():
        plan = ParallelPlan(mode="pp", pp_schedule=schedule,
                            pp_microbatches=PP_MICRO)
        opt, state = fresh(plan)
        state, m = pp_fault_step(fault)(model, opt, grid, plan, dev)(
            state, pp_global_batch(cfg, 0))
        gi = gate_i(state, float(m["loss"]))
        faults[fault] = {"gate": gate, "bitwise_to_gpipe":
                         same_as_gpipe(state, 0),
                         "grad_rel_max": None if gi is None
                         else max(gi["grad_rel"]),
                         "loss_rel": None if gi is None else gi["loss_rel"]}
        del state, opt
        torch.cuda.empty_cache()
    out["faults"] = faults
    return out


def step_ticks(plan):
    """Ticks of a pp step on PP_STAGES stages (JAX's schedule)."""
    off = 2 * PP_STAGES - 1 if plan.pp_schedule == "1f1b" else \
        plan.pp_microbatches + 2 * PP_STAGES - 2
    return plan.pp_microbatches + off


def pp_phase(dev):
    """llama-13b at full width with PP_LAYERS layers trains under
    ``ParallelPlan(mode="pp")`` as PP_STAGES ranks sharing the card (pipe
    2 x pod 1 x data 1, ``run_ranks(..., pipe=2)``, gloo staged through
    pinned host memory), a global batch of PP_BATCH x PP_SEQ tokens in
    PP_MICRO microbatches.  First the parent runs PP_STEPS steps of the
    one-device step on the whole batch (then frees them): step 1's
    gradient is the reference of gate (i), and the losses are printed
    beside the pp runs'.  Gates: (i) the gradient the pp step hands
    its optimizer at step 1 within TRAIN_GRAD_REL_TOL per leaf and the
    loss within TRAIN_LOSS_REL_TOL (gpipe and 1f1b); (ii) gpipe and
    1f1b give bitwise equal losses and recorded gradients over
    PP_STEPS steps; (iii) the planted faults of PP_FAULTS fail their
    gate; every training kernel launched in each run.  On one shared
    card the pipeline's bubble is not idle time (the other stage's rank
    fills the card), so these step times do not measure pipeline
    scaling.  Returns (results, failures)."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.parallel import ParallelPlan, init_state, \
        make_train_step
    from repro_torch.parallel.pp import bubble_fraction, \
        peak_live_activations
    from repro_torch.testing.multidev import _Recording, run_ranks
    cfg = pp_config()
    model = build_model(cfg)
    params = model.init(SEED, device=dev, dtype="bfloat16")
    n_params = sum(p.numel() for p in tree_leaves(params))
    names = _leaf_names(params)
    PP_ROOT.mkdir(parents=True, exist_ok=True)
    ref_path = PP_ROOT / "reference.pt"
    # the one-device step with the same optimizer on the whole batch:
    # step 1's gradient is gate (i)'s reference, its losses are printed
    # beside the pp runs'
    one = ParallelPlan()
    opt = _Recording(AdamW(lr=warmup_cosine(3e-4, 2, PP_STEPS)))
    state = init_state(one, opt.opt, params)
    step = make_train_step(one, model, opt, device=dev)
    one_losses = []
    for i in range(PP_STEPS):
        state, m = step(state, pp_global_batch(cfg, i))
        one_losses.append(float(m["loss"]))
        if i == 0:
            torch.save({"loss": one_losses[0],
                        "grads": [g.cpu() for g in
                                  tree_leaves(state["synced"])]}, ref_path)
    del params, state, step, opt, m
    torch.cuda.empty_cache()
    try:
        ranks = run_ranks(pp_rank, 1, 1, device=str(dev), staging="host",
                          args=(str(ref_path),), timeout=900,
                          pipe=PP_STAGES)
    finally:
        ref_path.unlink()
    r0 = ranks[0][0]
    failures = []
    tokens = PP_BATCH * PP_SEQ
    flops = 6 * n_params * tokens + 12 * cfg.n_layers * cfg.n_heads * \
        cfg.head_dim * PP_BATCH * causal_pairs(PP_SEQ, PP_SEQ, 0, PP_SEQ)
    out = {"arch": PP_ARCH, "layers": PP_LAYERS, "params": n_params,
           "stages": PP_STAGES, "pods": 1, "data": 1, "batch": PP_BATCH,
           "seq": PP_SEQ, "microbatches": PP_MICRO, "steps": PP_STEPS,
           "model_flops_per_step": flops, "one_process_losses": one_losses,
           "runs": {}}
    for schedule, run in r0["runs"].items():
        all_runs = [r["runs"][schedule] for r, _ in ranks]
        plan = ParallelPlan(mode="pp", pp_schedule=schedule,
                            pp_microbatches=PP_MICRO)
        gi = run["gate_i"]
        worst = max(range(len(gi["grad_rel"])),
                    key=lambda i: gi["grad_rel"][i])
        summary = {
            "ticks": run["ticks"], "losses": run["losses"],
            "loss_rel_to_one_process": [abs(a - b) / abs(b) for a, b in
                                        zip(run["losses"], one_losses)],
            "step_s": run["step_s"], "median_step_s": run["median_step_s"],
            "tokens_per_s": tokens / run["median_step_s"],
            "mfu_vs_bf16_dense_peak":
                flops / run["median_step_s"] / PEAK["bf16_tensor"],
            "bubble_fraction": bubble_fraction(PP_STAGES, PP_MICRO,
                                               schedule),
            "live_activation_slots": peak_live_activations(
                PP_STAGES, PP_MICRO, schedule),
            "peak_mem_gb_per_rank": [r["peak_mem_gb"] for r in all_runs],
            "spans_s_per_step_per_rank": [
                {k: v / PP_STEPS for k, v in r["spans_s"].items()}
                for r in all_runs],
            "launches_per_step": {
                k: sum(r["launches"][k] for r in all_runs) / PP_STEPS
                for k in TRAIN_KERNELS},
            "launches": {k: sum(r["launches"][k] for r in all_runs)
                         for k in run["launches"]},
            "gate_i": {"loss_rel": gi["loss_rel"],
                       "grad_rel_max": gi["grad_rel"][worst],
                       "grad_rel_max_leaf": names[worst],
                       "ok": gi["loss_rel"] <= TRAIN_LOSS_REL_TOL and
                       max(gi["grad_rel"]) <= TRAIN_GRAD_REL_TOL}}
        if schedule != "gpipe":
            summary["gate_ii"] = {
                "losses_bitwise": run["losses"] ==
                r0["runs"]["gpipe"]["losses"],
                "grads_bitwise_per_step": run["bitwise_to_gpipe"]}
            if not (summary["gate_ii"]["losses_bitwise"]
                    and all(run["bitwise_to_gpipe"])):
                failures.append(f"pp: gpipe and {schedule} differ (gate "
                                f"ii): {summary['gate_ii']}")
        if not summary["gate_i"]["ok"]:
            failures.append(f"pp {schedule}: recorded gradient vs one "
                            f"process (gate i): {summary['gate_i']}")
        if not all(math.isfinite(x) for x in run["losses"]):
            failures.append(f"pp {schedule}: losses not finite")
        for r in all_runs:
            if r["train_step_spans"] != PP_STEPS:
                failures.append(f"pp {schedule}: {r['train_step_spans']} of "
                                f"{PP_STEPS} steps ran through "
                                "parallel.make_train_step")
        for k in TRAIN_KERNELS:
            if summary["launches"].get(k, 0) <= 0:
                failures.append(f"pp {schedule}: kernel {k} never launched")
        out["runs"][schedule] = summary
        print(json.dumps({"pp_run": schedule, **summary}), flush=True)
    ctl = []
    for fault, rec in r0["faults"].items():
        by = {"i": rec["grad_rel_max"] > TRAIN_GRAD_REL_TOL
              or rec["loss_rel"] > TRAIN_LOSS_REL_TOL,
              "ii": not rec["bitwise_to_gpipe"]}
        row = {"fault": fault, "gate": rec["gate"],
               "grad_rel_max": rec["grad_rel_max"],
               "loss_rel": rec["loss_rel"],
               "bitwise_to_gpipe": rec["bitwise_to_gpipe"],
               "caught_by": [g for g, c in by.items() if c],
               "caught": by[rec["gate"]]}
        ctl.append(row)
        if not row["caught"]:
            failures.append(f"pp: planted fault '{fault}' passed gate "
                            f"({rec['gate']})")
    out["controls"] = ctl
    print(json.dumps({"pp_controls": ctl}), flush=True)
    return out, failures


# ---- HAI-Platform fault tolerance: gpt2-medium, pp -> ddp + ZeRO-1 ----

# the paper's DDP model at full width and depth as 4 ranks sharing the
# card (a rescale exists only across ranks): world 2 is pipe 2 x pod 1 x
# data 2, world 1 the first 2 ranks under ddp + ZeRO-1; a global batch
# of 4 x 1024 tokens before and after the rescale
FT_ARCH = "gpt2-medium"
FT_ROOT = ROOT / "build" / "ft_phase"
# (3FS chains of one target: a checkpoint of the full state is 4.9 GB,
# and the card machine's disk writes ~0.85 GB/s; the unbroken runs fork
# from the drill's state where the failure strikes)
FT_DRILL = dict(steps=6, ckpt_every=3, kill_at=4, batch=4, seq=1024,
                pp_microbatches=2, replication=1, fork_ref=True,
                validator=(("gemm_n", 1024), ("mem_mb", 256),
                           ("storage_mb", 64)))
# leg 1 needs no 3 post-restore steps: 4 steps, a checkpoint every 2,
# the failure before step 3 (a ddp + ZeRO-1 step on 4 ranks is the
# drill's slowest)
FT_SAME_DRILL = dict(FT_DRILL, steps=4, ckpt_every=2, kill_at=3)
# the faults' smoke runs: the validator at the JAX tests' sizes
FT_SMOKE_VALIDATOR = (("gemm_n", 64), ("mem_mb", 2), ("storage_mb", 1))
FT_LR = 3e-4
# the planted faults run on gpt2-medium's smoke config (4 layers, d 128,
# heads of 64 for the flash kernels), each with that config's clean
# legs as its reference: a fault's gate reads the runner's bookkeeping,
# the losses and the restored shards, none of which depends on the size
# gpt2-medium's layernorm takes the plain path (the rmsnorm kernels are
# not on it); its 16 heads of 64 run the flash kernels
FT_KERNELS = ("flash_attention", "flash_attention_bwd_dkv",
              "flash_attention_bwd_dq")


def ft_setup(device, smoke=False):
    """(cfg, model, optimizer, params): gpt2-medium in bf16 (``smoke``:
    its smoke config with heads of 64), random weights drawn on the card
    from SEED, AdamW with fp32 masters and moments."""
    from repro_torch.configs.registry import get_arch, smoke_config
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    cfg = get_arch(FT_ARCH)
    if smoke:
        cfg = smoke_config(FT_ARCH)
        cfg = dataclasses.replace(cfg, d_head=max(cfg.d_head, 64))
    model = build_model(cfg)
    return (cfg, model, AdamW(lr=FT_LR),
            model.init(SEED, device=device, dtype="bfloat16"))


def ft_fault_setup(device):
    return ft_setup(device, smoke=True)


def ft_rank(grid, device, root):
    """One rank of the ft phase: ``testing.multidev.check_elastic`` at
    full width and depth (both legs), then on the smoke config with the
    three planted faults (and that config's clean legs, their
    reference).  Numbers only."""
    from repro_torch.testing import multidev as md
    drill, same = md.Drill(**FT_DRILL), md.Drill(**FT_SAME_DRILL)
    out = {"rank": grid.rank,
           "full": md.check_elastic(grid, device, os.path.join(root, "full"),
                                    ft_setup, drill, same_drill=same)}
    torch_cleanup()
    small = {"validator": FT_SMOKE_VALIDATOR}
    out["smoke"] = md.check_elastic(
        grid, device, os.path.join(root, "smoke"), ft_fault_setup,
        dataclasses.replace(drill, **small),
        faults=(md.RESUME_AT_FAILURE, md.SICK_GEMM, md.SHARDS_SWAPPED),
        same_drill=dataclasses.replace(same, **small))
    return out


def torch_cleanup():
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def ft_ckpt_records(drill):
    """The checkpoint records of one drill under ``FTRunner.run``: the
    blocking save at the start, one at every step reached that is a
    multiple of ckpt_every (before the failure and again after the
    restore), and the final blocking save."""
    return 2 + drill["steps"] // drill["ckpt_every"]


def ft_same_plan_gate(r, drill, rank):
    """The same-plan leg's verdict on one rank's result: [] or what
    failed."""
    lost = drill["kill_at"] - drill["kill_at"] // drill["ckpt_every"] * \
        drill["ckpt_every"]
    bad = []
    if not (r["losses_bitwise"] and r["state_bitwise"]):
        bad.append(f"rank {rank}: losses / final state not bitwise equal "
                   f"to the unbroken run (losses {r['losses_bitwise']}, "
                   f"state {r['state_bitwise']}, max |diff| "
                   f"{r['state_diff']})")
    got = (r["failures"], r["restores"], r["rescales"], r["world"],
           r["lost_steps"])
    if got != (1, 1, 0, 2, lost):
        bad.append(f"rank {rank}: failures, restores, rescales, world, "
                   f"lost steps {got} != {(1, 1, 0, 2, lost)}")
    bad += _ft_events(r, rank, {"ckpt": ft_ckpt_records(drill),
                                "failure": 1, "validator": 1, "restore": 1})
    if not all(math.isfinite(x) for x in r["losses"]):
        bad.append(f"rank {rank}: losses not finite")
    return bad


def ft_cross_plan_gate(r, drill, rank):
    """The cross-plan leg's verdict on one rank's result."""
    lost = drill["kill_at"] - drill["kill_at"] // drill["ckpt_every"] * \
        drill["ckpt_every"]
    if rank >= 2:
        want = ["ckpt"] * (1 + drill["kill_at"] // drill["ckpt_every"]) \
            + ["failure", "validator"]
        events = [k for k in r.get("events", []) if k != "straggler"]
        if r.get("left_at") != drill["kill_at"] or events != want:
            return [f"rank {rank} (leaving): left at {r.get('left_at')} "
                    f"with events {r.get('events')}, want "
                    f"{drill['kill_at']} with {want}"]
        return []
    bad = []
    post = len(r["cont_losses"])
    if post < 3 or r["post_rel"] > TRAIN_LOSS_REL_TOL or not all(
            math.isfinite(x) for x in r["cont_losses"]):
        bad.append(f"rank {rank}: {post} post-restore losses, max rel "
                   f"{r['post_rel']} to the unbroken pp run (want >= 3 "
                   f"within {TRAIN_LOSS_REL_TOL})")
    got = (r["failures"], r["restores"], r["rescales"], r["world"],
           r["lost_steps"])
    if got != (1, 1, 1, 1, lost):
        bad.append(f"rank {rank}: failures, restores, rescales, world, "
                   f"lost steps {got} != {(1, 1, 1, 1, lost)}")
    bad += _ft_events(r, rank, {"ckpt": ft_ckpt_records(drill),
                                "failure": 1, "validator": 1, "restore": 1,
                                "rescale": 1})
    return bad


def _ft_events(r, rank, kinds):
    """Every record once, the JSONL equal to the report, validator <
    restore < rescale, and a healthy validator.  Straggler records are
    the host clock's (a step after a rescale pins new buffers) and are
    not counted."""
    d, bad = r["digest"], []
    seen = {k: n for k, n in d["kinds"].items() if k != "straggler"}
    if not (d["jsonl_matches_report"] and d["unique"] and seen == kinds):
        bad.append(f"rank {rank}: event log {d['kinds']} (unique "
                   f"{d['unique']}, JSONL = report "
                   f"{d['jsonl_matches_report']}), want {kinds}")
    order = [k for k in d["order"] if k in ("validator", "restore",
                                            "rescale")]
    if order != [k for k in ("validator", "restore", "rescale")
                 if k in kinds]:
        bad.append(f"rank {rank}: event order {d['order']}")
    sick = [n for n, c in r["validator"].items() if not c["ok"]]
    if sick or not r["validator"]:
        bad.append(f"rank {rank}: validator checks failed: {sick or 'none'}"
                   " ran")
    return bad


def ft_phase(dev):
    """HAI-Platform's fault tolerance on the card: gpt2-medium at full
    width and depth (bf16, AdamW with fp32 masters) as 4 ranks sharing
    the card over host-staged gloo (``run_ranks(..., pods=1, data=2,
    pipe=2)``), a global batch of 4 x 1024 tokens, checkpoints through
    ``ElasticCheckpointer`` on an in-process 3FS cluster under
    build/ft_phase, saved asynchronously every few steps
    (``testing.multidev.check_elastic`` with FT_SAME_DRILL for leg 1 and
    FT_DRILL for leg 2):

    - leg 1, same plan: ddp + ZeRO-1 over the 4 ranks under
      ``FTRunner``, the first non-fatal Table-V class of
      ``FailureModel(0)`` injected between two checkpoints; the losses
      (replay included) and every leaf of the final state bitwise equal
      to an unbroken run's;
    - leg 2, cross plan: pp (2 stages, 1f1b), the first fatal class of
      ``FailureModel(1)``, the validator on the card, then
      ``restore_for`` onto ddp + ZeRO-1 over ranks 0 and 1 (ranks 2, 3
      leave); at least 3 post-restore losses within TRAIN_LOSS_REL_TOL
      of the unbroken pp run's, one rescale, world 1, lost steps = kill
      step - checkpoint step;
    - in both legs each record once, the JSONL = ``RunReport.events``,
      validator < restore < rescale, every validator check passing;
    - planted faults (on the smoke config): the runner resuming
      at the failure step (leg 1's bitwise gate), the survivors' ZeRO-1
      shards at each other's offsets (leg 2's gate), a broken GEMM check
      (leg 1's rescale gate), each of which must fail its gate.

    Prints the validator's readings, step times per plan, the
    checkpointer's seconds and the training kernels' launches per step.
    Returns (results, failures)."""
    import shutil

    from repro_torch.testing.multidev import RESUME_AT_FAILURE, \
        SHARDS_SWAPPED, SICK_GEMM, run_ranks
    shutil.rmtree(FT_ROOT, ignore_errors=True)
    FT_ROOT.mkdir(parents=True, exist_ok=True)
    try:
        ranks = run_ranks(ft_rank, 1, 2, device=str(dev), staging="host",
                          args=(str(FT_ROOT),), timeout=600, pipe=2)
    finally:
        shutil.rmtree(FT_ROOT, ignore_errors=True)
    failures = []
    res = [r for r, _ in ranks]
    kill = FT_DRILL["kill_at"]
    for depth in ("full", "smoke"):
        for rank, r in enumerate(res):
            failures += [f"ft {depth} same plan: {b}" for b in
                         ft_same_plan_gate(r[depth]["same_plan"],
                                           FT_SAME_DRILL, rank)]
            failures += [f"ft {depth} cross plan: {b}" for b in
                         ft_cross_plan_gate(r[depth]["cross_plan"],
                                            FT_DRILL, rank)]
    gates = {RESUME_AT_FAILURE: ("same plan", ft_same_plan_gate,
                                 FT_SAME_DRILL),
             SICK_GEMM: ("same plan", ft_same_plan_gate, FT_SAME_DRILL),
             SHARDS_SWAPPED: ("cross plan", ft_cross_plan_gate, FT_DRILL)}
    controls = []
    for fault, (leg, gate, drill) in gates.items():
        caught = [gate(r["smoke"]["faults"][fault], drill, rank)
                  for rank, r in enumerate(res)]
        row = {"fault": fault, "gate": leg,
               "caught": any(caught), "by": caught[0][:2]}
        controls.append(row)
        if not row["caught"]:
            failures.append(f"ft: planted fault '{fault}' passed the "
                            f"{leg} gate")
    r0 = res[0]["full"]
    same, cross = r0["same_plan"], r0["cross_plan"]
    out = {
        "arch": FT_ARCH, "ranks": 4, "drill": FT_DRILL,
        "same_plan_drill": FT_SAME_DRILL,
        "classes": {"same_plan": same["cls"], "cross_plan": cross["cls"]},
        "validator": {"same_plan": same["validator"],
                      "cross_plan": cross["validator"]},
        "step_s": {"ddp_zero1_4_ranks": same["step_s"],
                   "pp_4_ranks": cross["step_s"][:kill],
                   "ddp_zero1_2_ranks": cross["step_s"][kill:]},
        "losses": {"same_plan": same["losses"],
                   "same_plan_unbroken": same["ref_losses"],
                   "cross_plan": cross["losses"],
                   "cross_plan_unbroken": cross["ref_losses"]},
        "post_restore_rel": cross["post_rel"],
        "lost_steps": {"same_plan": same["lost_steps"],
                       "cross_plan": cross["lost_steps"]},
        "ckpt_s": {"same_plan": same["ckpt_s"],
                   "cross_plan": cross["ckpt_s"]},
        "spans_s": {"same_plan": same["spans_s"],
                    "cross_plan": cross["spans_s"]},
        "leg_seconds": {"same_plan": same["seconds"],
                        "cross_plan": cross["seconds"]},
        # the unbroken runs' steps, every rank's launches
        "launches_per_step": {
            plan: {k: sum(r["full"][leg]["ref_launches"].get(k, 0)
                          for r in res) / r0[leg]["ref_steps"]
                   for k in FT_KERNELS}
            for plan, leg in (("ddp_zero1_4_ranks", "same_plan"),
                              ("pp_4_ranks", "cross_plan"))},
        "launches": {k: sum(r["full"][leg]["launches"].get(k, 0)
                            + r["full"][leg].get("ref_launches", {}).get(
                                k, 0)
                            for r in res for leg in ("same_plan",
                                                     "cross_plan"))
                     for k in FT_KERNELS},
        "controls": controls}
    for k in FT_KERNELS:
        if out["launches"][k] <= 0:
            failures.append(f"ft: kernel {k} never launched")
    print(json.dumps({"ft": out}), flush=True)
    return out, failures


def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def main():
    # the training phase holds ~70 GB in tensors of very different sizes:
    # expandable segments keep the caching allocator from fragmenting
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found next to the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.telemetry import now
    dev = torch.device("cuda:0")
    failures = []
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = now()
    per = build.build_all()
    t_build = now() - t0
    print(f"kernel build: {t_build:.1f} s (nvcc per source: "
          f"{json.dumps({k: round(v, 1) for k, v in per.items()})})",
          flush=True)
    for name, log in build.build_logs.items():
        for fn, line in ptxas_lines(log):
            print(f"ptxas {name} {fn}: {line}", flush=True)
    # the fused rmsnorm backward: no spill at one slice a thread
    if "rmsnorm_bwd" in build.build_logs:
        lines = ptxas_lines(build.build_logs["rmsnorm_bwd"])
        spilled = spills(build.build_logs["rmsnorm_bwd"])
        print(json.dumps({"ptxas": "rmsnorm_bwd", "lines": lines,
                          "spills": spilled}), flush=True)
        failures += [f"rmsnorm_bwd {fn}: ptxas spills: {line}"
                     for fn, line in spilled if re.search(r"<[^,<>]+, 1,", fn)]
    else:
        print("ptxas rmsnorm_bwd: library from the build cache, its ptxas "
              "lines (spills) not read in this run", flush=True)
    # the rmsnorm forward and the top-k gating kernels: no spill in any
    # instantiation
    for lib in ("rmsnorm_fwd", "topk_gating"):
        if lib in build.build_logs:
            failures += [f"{lib} {fn}: ptxas spills: {line}"
                         for fn, line in spills(build.build_logs[lib])]
        else:
            print(f"ptxas {lib}: library from the build cache, its ptxas "
                  "lines (spills) not read in this run", flush=True)
    # the wgmma kernels: no spill in a fresh build, HGMMA in the SASS; the
    # SSD library also no wgmma that ptxas serializes (C75xx)
    for lib in ("flash_attention", "flash_attention_bwd",
                "paged_chunk_attention", "ssd_scan"):
        if lib in build.build_logs:
            failures += [f"{lib} {fn}: ptxas spills: {line}"
                         for fn, line in spills(build.build_logs[lib])]
            if lib == "ssd_scan":
                serial = serialized(build.build_logs[lib])
                print(json.dumps({"ptxas": lib, "serialized_wgmma": serial}),
                      flush=True)
                failures += [f"{lib}: ptxas serializes wgmma: {line}"
                             for line in serial]
        else:
            print(f"ptxas {lib}: library from the build cache, its ptxas "
                  "lines (spills) not read in this run", flush=True)
        hgmma = sass_count(lib, "HGMMA")
        print(json.dumps({"sass": lib, "HGMMA": hgmma}), flush=True)
        if hgmma == 0:
            failures.append(f"{lib}: no HGMMA (wgmma) instruction in its "
                            "SASS")

    def timed(name, fn):
        t = now()
        out = fn()
        print(json.dumps({"phase": name, "seconds": now() - t}), flush=True)
        return out

    cases = {}
    for name, phase in (("kernels", kernel_phase),
                        ("backward kernels", backward_kernel_phase),
                        ("gating kernels", gating_phase),
                        ("ssd kernels", ssd_phase),
                        ("quant kernels", quant_phase)):
        cases.update(timed(name, lambda: phase(dev)))
    for name, rows in cases.items():
        for r in rows:
            print(json.dumps({"kernel": name, **r}), flush=True)
            # the case itself, the forward kernel's residuals and the
            # chain forward kernel -> backward kernels
            parts = [("", r)] + [(f" residual {k}", v) for k, v in
                                 r.get("residual", {}).items()]
            if "chained" in r:
                parts.append((" chained", r["chained"]))
            for label, c in parts:
                if not c["ok"]:
                    failures.append(f"{name} {r['case']}{label}: "
                                    f"max_abs_err {c['max_abs_err']}")
                failures += [f"{name} {r['case']}{label}: planted fault "
                             f"'{f['fault']}' passed the tolerance"
                             for f in c.get("controls", [])
                             if not f["caught"]]

    e2e = timed("phi4 serving", lambda: e2e_phase(dev))
    for c in e2e["vs_plain"]:
        if not c["ok"]:
            failures.append(f"e2e kernel vs plain: {c}")
    failures += e2e["spec_failures"]
    torch.cuda.empty_cache()
    train, train_failures = timed("phi4 training", lambda: train_phase(dev))
    print(json.dumps({"train": train}), flush=True)
    print(json.dumps({"profile_sums": train["profile"][
        "against_key_averages"]}), flush=True)
    failures += train_failures
    torch.cuda.empty_cache()
    ckpt, ckpt_failures = timed("checkpoint", lambda: ckpt_phase(dev))
    failures += ckpt_failures
    torch.cuda.empty_cache()
    moe_e2e, moe_failures = timed("moe serving",
                                  lambda: moe_serve_phase(dev))
    failures += moe_failures
    moe_train, moe_failures = timed("moe training",
                                    lambda: moe_train_phase(dev))
    print(json.dumps({"moe_train": moe_train}), flush=True)
    failures += moe_failures
    torch.cuda.empty_cache()
    hybrid_e2e, hybrid_failures = timed("hybrid serving",
                                        lambda: hybrid_serve_phase(dev))
    failures += hybrid_failures
    hybrid_train, hybrid_failures = timed("hybrid training",
                                          lambda: hybrid_train_phase(dev))
    print(json.dumps({"hybrid_train": hybrid_train}), flush=True)
    failures += hybrid_failures
    torch.cuda.empty_cache()
    fams, fam_failures = timed("families", lambda: families_phase(dev))
    failures += fam_failures
    torch.cuda.empty_cache()
    ddp, ddp_failures = timed("ddp training", lambda: ddp_phase(dev))
    failures += ddp_failures
    torch.cuda.empty_cache()
    pp, pp_failures = timed("pp training", lambda: pp_phase(dev))
    failures += pp_failures
    torch.cuda.empty_cache()
    ft, ft_failures = timed("ft training", lambda: ft_phase(dev))
    failures += ft_failures

    # representative main-path case of each kernel: the decode tick for
    # rmsnorm (8 slots), paged attention (T = 1, bs 16, bf16) and top-k
    # gating (8 x 60, top-4), a 512-token fresh prefill for flash
    # attention, the training step (4096 x 3072 rows, b 2 x 2048 causal,
    # 4096 x 60 gating, zamba2's b 2 x 2048 SSD scan) for the backward
    # kernels and the SSD forward.  launches: per run of each path that
    # ran the kernel, counters zeroed before the run and read after
    summary = []
    for name in KERNEL_META:
        r = cases[name][0]
        route, source, replaces = KERNEL_META[name]
        runs, per_step = {}, {}
        for arch, serve, kernels in (
                (ARCH, e2e, DENSE_SERVING_KERNELS),
                (MOE_ARCH, moe_e2e, SERVING_KERNELS),
                (HYBRID_ARCH, hybrid_e2e, HYBRID_SERVING_KERNELS)):
            if name not in kernels:
                continue
            for run in serve["runs"]:
                key = f"{arch} serve prefill_chunk={run['prefill_chunk']}"
                runs[key] = run["launches"][name]
                per_step[f"{key} (per engine step)"] = \
                    run["launches_per_step"][name]
        for arch, recs in ((ARCH, e2e["spec"]["runs"]),
                           (MOE_ARCH, {"ngram": moe_e2e["spec"]}),
                           (HYBRID_ARCH, {"oracle": hybrid_e2e["spec"]})):
            for label, rec in recs.items():
                if rec["launches"].get(name, 0):
                    key = f"{arch} serve {label}"
                    runs[key] = rec["launches"][name]
                    if "spec_ticks" in rec:
                        per_step[f"{key} (per spec tick)"] = \
                            rec["launches"][name] / rec["spec_ticks"]
        if name in TRAIN_KERNELS and "resume" in ckpt:
            key = f"{ARCH} {CKPT_LAYERS} layers, checkpoint resume " \
                  f"{CKPT_STEPS - CKPT_SAVE_AT} steps"
            runs[key] = ckpt["resume"]["launches"][name]
            per_step[f"{key} (per step)"] = \
                ckpt["resume"]["launches"][name] / (CKPT_STEPS - CKPT_SAVE_AT)
        for arch, tr, kernels in (
                (ARCH, train, TRAIN_KERNELS),
                (MOE_ARCH, moe_train, MOE_TRAIN_KERNELS),
                (HYBRID_ARCH, hybrid_train, HYBRID_TRAIN_KERNELS)):
            if name in kernels:
                runs[f"{arch} train {TRAIN_STEPS} steps"] = \
                    tr["launches"][name]
                per_step[f"{arch} train (per step)"] = \
                    tr["launches_per_step"][name]
        for key, run in ddp["runs"].items():
            if run["launches"].get(name, 0):
                label = f"{DDP_ARCH} ddp {key} {DDP_STEPS} steps, " \
                        f"{DDP_PODS * DDP_DATA} ranks"
                runs[label] = run["launches"][name]
                per_step[f"{label} (per step)"] = \
                    run["launches"][name] / DDP_STEPS
        for key, run in pp["runs"].items():
            if run["launches"].get(name, 0):
                label = f"{PP_ARCH} {PP_LAYERS} layers pp {key} " \
                        f"{PP_STEPS} steps, {PP_STAGES} stages"
                runs[label] = run["launches"][name]
                per_step[f"{label} (per step)"] = \
                    run["launches"][name] / PP_STEPS
        for arch, fam in fams.items():
            if fam["serve"]["launches"].get(name, 0):
                runs[f"{arch} serve {FAM_REQUESTS} requests"] = \
                    fam["serve"]["launches"][name]
            if name in FAM_KERNELS[arch][1]:
                runs[f"{arch} train {FAM_STEPS} steps"] = \
                    fam["train"]["launches"][name]
                per_step[f"{arch} train (per step)"] = \
                    fam["train"]["launches_per_step"][name]
        if name in FT_KERNELS:
            label = f"{FT_ARCH} ft drill, both legs, 4 ranks"
            runs[label] = ft["launches"][name]
            for plan, per in ft["launches_per_step"].items():
                per_step[f"{FT_ARCH} ft {plan} (per step)"] = per[name]
        summary.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces,
            **({"also_replaces": ALSO_REPLACES[name]}
               if name in ALSO_REPLACES else {}),
            "case": r["case"],
            "launches": sum(runs.values()), "launches_per_run": runs,
            "launches_per_step": per_step,
            "max_abs_err": r["max_abs_err"], "tol_used": r["tol_used"],
            "ms": r["ms"], "host_ms": r["host_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **{k: r[k] for k in ("ms_cold", "host_ms_wrapper",
                                 "plain_covers", "library_covers")
               if k in r}})
    print(json.dumps({"model": {k: e2e[k] for k in
                                ("arch", "params", "peak_mem_gb")}}),
          flush=True)
    for label, tr in (("train_summary", train),
                      ("moe_train_summary", moe_train),
                      ("hybrid_train_summary", hybrid_train)):
        print(json.dumps({label: {
            k: tr[k] for k in ("median_step_s", "tokens_per_s",
                               "mfu_vs_bf16_dense_peak", "peak_mem_gb",
                               "losses", "launches_per_step")}}),
            flush=True)
    print(json.dumps({"families_summary": {"card": card, **{
        arch: {"layers": f["layers"], "params": f["params"],
               "serve": {k: f["serve"][k] for k in (
                   "via", "seconds", "tokens_per_s", "ttft_p50_s",
                   "ttft_p95_s", "tpot_p50_s", "tpot_p95_s")},
               "serve_peak_mem_gb": f["serve_peak_mem_gb"],
               "streams_equal_to_plain": f["gate_i"]["equal_to_end"],
               "logits": {k: f["logits"][k] for k in (
                   "first_token_rel", "worst_row_rel", "rows")},
               **({"encoder": {k: f["encoder"][k] for k in (
                   "worst_request_rel", "worst_row_rel")}}
                  if f["encoder"] else {}),
               "seconds_by_part": f["seconds_by_part"],
               "controls": f["controls"],
               "train": {k: f["train"][k] for k in (
                   "batch", "seq", "median_step_s", "tokens_per_s",
                   "mfu_vs_bf16_dense_peak", "peak_mem_gb", "losses",
                   "launches_per_step")},
               "train_busy_share":
                   f["train"]["profile"]["device_busy_share"],
               "train_vs_plain": {k: f["train"]["vs_plain"][k] for k in (
                   "loss_rel", "grad_rel_max", "grad_rel_max_leaf")}}
        for arch, f in fams.items()}}}), flush=True)
    print(json.dumps({"ddp_summary": ddp}), flush=True)
    print(json.dumps({"pp_summary": {"card": card, **pp}}), flush=True)
    print(json.dumps({"ft_summary": {"card": card, **{
        k: ft[k] for k in ("arch", "classes", "step_s",
                           "post_restore_rel",
                           "lost_steps", "ckpt_s", "leg_seconds",
                           "launches_per_step", "controls")},
        "validator": {n: c["value"] for n, c in
                      ft["validator"]["cross_plan"].items()}}}), flush=True)
    print(json.dumps({"ckpt_summary": {"card": card, **{
        k: ckpt.get(k) for k in ("arch", "layers", "params", "state_bytes",
                                 "free_disk_bytes", "save", "restore",
                                 "cross_plan", "seconds")},
        "probe_bitwise": ckpt.get("probe", {}).get("bitwise")}}), flush=True)
    keys = ("seconds", "tokens_per_s", "ttft_p50_s", "ttft_p95_s",
            "tpot_p50_s", "tpot_p95_s", "tokens_per_verify_step",
            "accept_rate", "paged_launches_per_spec_tick", "export_s",
            "import_s", "handoff_bytes", "store_hits")
    print(json.dumps({"spec_summary": {
        "card": card, "plain": {k: e2e["runs"][0][k] for k in (
            "seconds", "tokens_per_s", "ttft_p50_s", "ttft_p95_s",
            "tpot_p50_s", "tpot_p95_s")},
        **{f"{ARCH} {label}": {k: r[k] for k in keys if k in r} | {
            "equal_to_end": r["gate_i"]["equal_to_end"]}
           for label, r in e2e["spec"]["runs"].items()},
        f"{MOE_ARCH} ngram": {k: moe_e2e["spec"][k] for k in keys
                              if k in moe_e2e["spec"]},
        f"{HYBRID_ARCH} oracle": {k: hybrid_e2e["spec"][k] for k in keys
                                  if k in hybrid_e2e["spec"]},
        "controls": e2e["spec"]["controls"]}}), flush=True)
    for label, serve in (("moe_serve_summary", moe_e2e),
                         ("hybrid_serve_summary", hybrid_e2e)):
        print(json.dumps({label: {
            "peak_mem_gb": serve["peak_mem_gb"],
            "device_busy_share": serve["profile"]["device_busy_share"],
            "runs": [{k: run[k] for k in (
                "prefill_chunk", "seconds", "tokens_per_s", "ttft_p50_s",
                "ttft_p95_s", "tpot_p50_s", "tpot_p95_s", "engine_steps",
                "launches")} for run in serve["runs"]]}}), flush=True)
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    print(card, flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:                        # report and fail the run
        traceback.print_exc()
        sys.exit(1)
