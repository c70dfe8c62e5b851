"""Architecture registry: ``--arch <id>`` resolution + reduced smoke configs."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (ModelConfig, MoEConfig, SSMConfig,
                                ShapeConfig, SHAPES, applicable_shapes)

from repro_torch.configs import (nemotron_4_15b, codeqwen15_7b, llama3_405b,
                           phi4_mini_3_8b, internvl2_76b, whisper_base,
                           zamba2_1_2b, qwen3_moe_235b_a22b, qwen2_moe_a2_7b,
                           xlstm_125m, paper_models)

ARCHS: dict[str, ModelConfig] = {
    "nemotron-4-15b": nemotron_4_15b.CONFIG,
    "codeqwen1.5-7b": codeqwen15_7b.CONFIG,
    "llama3-405b": llama3_405b.CONFIG,
    "phi4-mini-3.8b": phi4_mini_3_8b.CONFIG,
    "internvl2-76b": internvl2_76b.CONFIG,
    "whisper-base": whisper_base.CONFIG,
    "zamba2-1.2b": zamba2_1_2b.CONFIG,
    "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b.CONFIG,
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b.CONFIG,
    "xlstm-125m": xlstm_125m.CONFIG,
    # paper's own models (benchmarks)
    "gpt2-medium": paper_models.GPT2_MEDIUM,
    "llama-13b": paper_models.LLAMA_13B,
    "deepseekmoe-16b": paper_models.DEEPSEEKMOE_16B,
}

ASSIGNED = [
    "nemotron-4-15b", "codeqwen1.5-7b", "llama3-405b", "phi4-mini-3.8b",
    "internvl2-76b", "whisper-base", "zamba2-1.2b", "qwen3-moe-235b-a22b",
    "qwen2-moe-a2.7b", "xlstm-125m",
]


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def dryrun_cells(multi_pod_only: bool = False) -> list[tuple[str, str]]:
    """All (arch, shape) dry-run cells, honoring documented skips."""
    cells = []
    for arch in ASSIGNED:
        cfg = ARCHS[arch]
        for shape in applicable_shapes(cfg):
            cells.append((arch, shape))
    return cells


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: small layers/width/experts/vocab, runnable
    in one CPU forward/train step."""
    cfg = get_arch(name)
    kw: dict = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_head=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
    )
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(
            n_experts=8, top_k=min(cfg.moe.top_k, 2), d_expert=64,
            n_shared_experts=cfg.moe.n_shared_experts,
            d_shared=128 if cfg.moe.d_shared else 0,
            router=cfg.moe.router, capacity_factor=cfg.moe.capacity_factor)
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(state_size=16 if cfg.ssm.state_size else 0,
                              expand=2, conv_width=4,
                              head_dim=64, chunk_size=32)
    if cfg.attn_period:
        kw["attn_period"] = 2
    if cfg.encoder_layers:
        kw["encoder_layers"] = 2
        kw["n_layers"] = 2
    if cfg.block_pattern:
        kw["block_pattern"] = "msms"
        kw["n_layers"] = 4
    if cfg.n_frontend_tokens:
        kw["n_frontend_tokens"] = 16
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **kw)
