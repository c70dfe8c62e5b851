"""Model / shape / parallelism configuration dataclasses.

Every assigned architecture gets one ``src/repro_torch/configs/<id>.py`` (a copy of
the JAX package's config of the same name) exporting
``CONFIG: ModelConfig``.  ``registry.py`` collects them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0            # per-expert FFN hidden size
    n_shared_experts: int = 0
    d_shared: int = 0            # shared-expert FFN hidden size (total)
    router: str = "softmax"      # "softmax" | "sigmoid"
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001  # load-balance aux loss


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_size: int = 0          # N (mamba2 ssm_state)
    expand: int = 2              # d_inner = expand * d_model
    conv_width: int = 4
    head_dim: int = 64           # mamba2 P
    chunk_size: int = 256        # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0              # 0 -> d_model // n_heads
    activation: str = "swiglu"   # swiglu | squared_relu | geglu | gelu
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    tie_embeddings: bool = False
    # --- MoE ---
    moe: Optional[MoEConfig] = None
    # --- SSM / hybrid ---
    ssm: Optional[SSMConfig] = None
    attn_period: int = 0         # hybrid: shared attention block every N layers
    block_pattern: str = ""      # ssm family: e.g. "msmsms..." (m=mLSTM, s=sLSTM)
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0      # >0 => encoder-decoder; n_layers = decoder layers
    # --- modality frontend stub ---
    frontend: str = ""           # "" | "audio_stub" | "patch_stub"
    n_frontend_tokens: int = 0   # vlm: patch tokens prepended to the sequence
    # --- numerics ---
    param_dtype: str = "float32"    # canonical/master dtype
    compute_dtype: str = "bfloat16"
    # --- attention core dispatch (models.attention.attention_core) ---
    attn_impl: str = "auto"      # auto | ref
    # --- dispatch of the other hand-written kernels ---
    # "auto" launches the kernel on a CUDA tensor and runs its plain
    # PyTorch version on a CPU tensor; "ref" forces the plain version.
    norm_impl: str = "auto"      # rmsnorm call sites (models.common /
                                 # mamba2 gated-output norm)
    ssm_impl: str = "auto"       # SSD chunk scan (models.mamba2)
    gate_impl: str = "auto"      # MoE softmax router top-k (models.moe)
    # --- serving decode path (serve_lib.BatchServer / repro.serving) ---
    decode_impl: str = "dense"   # dense (lockstep batch decode against a
                                 # contiguous cache) | paged (continuous
                                 # batching + block-paged flash decode)
    # --- attention flavor for long context ---
    notes: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic state => long_500k decode is runnable."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decode(self) -> bool:
        """Encoder-only archs have no decode step (none assigned, all True)."""
        return True

    # ---------------- parameter counting (for roofline MODEL_FLOPS) --------

    def param_count(self) -> int:
        """Total parameters (analytic)."""
        return _count_params(self, active_only=False)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed top-k + shared)."""
        return _count_params(self, active_only=True)


def _attn_params(cfg: ModelConfig) -> int:
    d, hd = cfg.d_model, cfg.head_dim
    q = d * cfg.n_heads * hd
    kv = 2 * d * cfg.n_kv_heads * hd
    o = cfg.n_heads * hd * d
    bias = (cfg.n_heads + 2 * cfg.n_kv_heads) * hd if cfg.qkv_bias else 0
    return q + kv + o + bias


def _ffn_params(d_model: int, d_ff: int, activation: str) -> int:
    gated = activation in ("swiglu", "geglu")
    return d_model * d_ff * (3 if gated else 2)


def _mamba2_params(cfg: ModelConfig) -> int:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    in_proj = cfg.d_model * (2 * d_in + 2 * s.state_size + n_heads)
    conv = (d_in + 2 * s.state_size) * s.conv_width
    out_proj = d_in * cfg.d_model
    extras = 2 * n_heads + d_in  # A_log, D, norm
    return in_proj + conv + out_proj + extras


def _xlstm_block_params(cfg: ModelConfig, kind: str) -> int:
    d = cfg.d_model
    if kind == "m":  # mLSTM: up-proj x2 (pf=2), qkv over inner, gates, out
        d_in = 2 * d
        up = d * 2 * d_in
        qkv = d_in * 3 * d_in
        gates = 2 * (d_in + 1) * (d_in // max(cfg.head_dim, 1) or 1)
        out = d_in * d
        return up + qkv + gates + out
    # sLSTM: 4 gates (i,f,z,o), recurrent block-diag + ff (pf=4/3 * 2)
    gates = 4 * d * d + 4 * d * d // max(cfg.n_heads, 1)
    ff = int(d * d * 8 / 3)
    return gates + ff


def _count_params(cfg: ModelConfig, active_only: bool) -> int:
    d, v = cfg.d_model, cfg.vocab_size
    embed = v * d
    unembed = 0 if cfg.tie_embeddings else v * d
    total = embed + unembed + d  # final norm

    def dense_layer() -> int:
        return _attn_params(cfg) + _ffn_params(d, cfg.d_ff, cfg.activation) + 2 * d

    if cfg.family in ("dense", "vlm"):
        total += cfg.n_layers * dense_layer()
    elif cfg.family == "audio":
        # encoder + decoder layers; decoder adds cross-attention
        enc = cfg.encoder_layers * dense_layer()
        dec = cfg.n_layers * (dense_layer() + _attn_params(cfg) + d)
        total += enc + dec
    elif cfg.family == "moe":
        m = cfg.moe
        router = d * m.n_experts
        experts = m.n_experts * _ffn_params(d, m.d_expert, cfg.activation)
        if active_only:
            experts = m.top_k * _ffn_params(d, m.d_expert, cfg.activation)
        shared = _ffn_params(d, m.d_shared, cfg.activation) if m.d_shared else 0
        per_layer = _attn_params(cfg) + router + experts + shared + 2 * d
        total += cfg.n_layers * per_layer
    elif cfg.family == "hybrid":
        mamba_layers = cfg.n_layers
        total += mamba_layers * (_mamba2_params(cfg) + d)
        # one shared attention+MLP block (reused every attn_period layers)
        total += _attn_params(cfg) + _ffn_params(d, cfg.d_ff, cfg.activation) + 2 * d
    elif cfg.family == "ssm":
        pattern = cfg.block_pattern or "m" * cfg.n_layers
        for k in pattern:
            total += _xlstm_block_params(cfg, k) + d
    else:
        raise ValueError(cfg.family)
    return total


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int                 # train/prefill: tokens; decode/chunk: the
                                 # SeqState sequence capacity
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode" | "chunk"
    chunk: int = 0               # kind="chunk": tokens per forward() call
                                 # (a prefill chunk; decode is chunk=1)


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
    # chunked prefill: a (b, chunk) slice of the prompt advancing a
    # SeqState with seq_len capacity (launch/dryrun.py lowers it with the
    # same serve step as decode — decode is just chunk=1)
    "chunk_2k": ShapeConfig("chunk_2k", 32_768, 32, "chunk", chunk=2048),
}


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long_context:
        out.append("long_500k")
    return out


# ---------------------------------------------------------------------------
# Parallelism config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """How a given (arch x shape) maps onto the production mesh.

    Axis names refer to mesh axes. ``tp`` consumes "model"; FSDP shards
    params over "data" (intra-pod only — the Fire-Flyer rule); optimizer
    state additionally shards over "pod" (ZeRO-1 on the weak link).
    """

    tp: int = 1                  # tensor parallel degree (over "model")
    fsdp: bool = True            # ZeRO-3 params over "data"
    zero1_pod: bool = True       # optimizer state sharded over "pod" too
                                 # (only safe when "pod" carries batch!)
    opt_shard_model: bool = False  # optimizer state over "model" too (for
                                 # configs where "model" carries batch)
    batch_axes: tuple = ("pod", "data")   # mesh axes carrying the batch dim
    seq_shard: bool = False      # sequence parallelism on boundary activations
    microbatch: int = 1          # gradient-accumulation steps
    remat: str = "full"          # "none" | "full"
    ep: int = 1                  # expert parallel degree (over "model")
    grad_compression: str = ""   # "" | "bf16" | "int8"
    hier_allreduce: bool = True  # HFReduce-style hierarchical cross-pod sync
