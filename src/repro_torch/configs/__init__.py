"""Architecture registry of the port: ``arch`` id resolution, reduced
smoke configs, per-cell applicability, and :func:`build_model`.

The per-architecture files and ``shapes.py`` are verbatim copies of the
JAX package's (imports rewritten).  ``input_specs`` (the JAX dry-run's
abstract inputs) has no counterpart here.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.shapes import LM_SHAPES, VAE_SHAPES, ShapeSpec
from repro_torch.models.common import ModelConfig

_ARCH_MODULES = {
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "granite-8b": "repro_torch.configs.granite_8b",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "qwen2-vl-72b": "repro_torch.configs.qwen2_vl_72b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2p7b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test scale: same family/topology, tiny dimensions, fp32 (the
    JAX package's ``reduced_config``)."""
    subs: Dict[str, Any] = dict(
        n_layers=4 if cfg.attn_every else 2,
        d_model=128, d_ff=256, vocab_size=512,
        n_heads=4, n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        d_head=None, dtype=torch.float32, remat=False,
    )
    if cfg.family == "encdec":
        subs.update(encoder_layers=2, encoder_seq=16)
    if cfg.n_experts:
        subs.update(n_experts=4, experts_per_token=2, capacity_factor=8.0)
    if cfg.ssm_type:
        subs.update(ssm_head_dim=32, ssm_state=16)
    if cfg.attn_every:
        subs.update(attn_every=2)
    if cfg.sliding_window:
        subs.update(sliding_window=16)
    if cfg.mrope_sections:
        subs.update(mrope_sections=(4, 6, 6))     # sums to head_dim/2 = 16
    return dataclasses.replace(cfg, **subs)


def build_model(cfg: ModelConfig, device=None, seed: int = 0):
    """The model of ``cfg`` with seeded random weights on ``device``
    (``"cuda"`` unless the caller asks for the CPU): an
    :class:`~repro_torch.models.encdec.EncDecLM` for the encdec family, a
    :class:`~repro_torch.models.lm.CausalLM` for every other."""
    if cfg.family == "encdec":
        from repro_torch.models.encdec import EncDecLM
        return EncDecLM(cfg, device=device, seed=seed)
    from repro_torch.models.lm import CausalLM
    return CausalLM(cfg, device=device, seed=seed)


def cell_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    if shape.name == "long_500k":
        if not cfg.subquadratic:
            return False, ("pure full-attention arch: 500k-token decode "
                           "needs sub-quadratic attention (DESIGN.md "
                           "§Arch-applicability)")
        if cfg.family == "encdec":
            return False, "enc-dec target length is architecturally bounded"
    return True, ""
