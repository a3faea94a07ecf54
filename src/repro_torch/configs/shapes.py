"""Assigned input-shape sets (LM family) + the paper's own VAE shapes."""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str              # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


LM_SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

# The paper's own architecture (SD3.5 VAE decode fleet): batched latent ->
# image reconstruction, the read path of the latent-first store.
VAE_SHAPES: Dict[str, ShapeSpec] = {
    "decode_1k_b256": ShapeSpec("decode_1k_b256", "vae_decode", 1024, 256),
    "decode_512_b512": ShapeSpec("decode_512_b512", "vae_decode", 512, 512),
}
