"""qwen2-vl-72b [vlm]: M-RoPE, dynamic resolution; vision frontend STUB
(precomputed patch embeddings).  [arXiv:2409.12191; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
    vocab_size=152064, act="swiglu", qkv_bias=True, rope_theta=1e6,
    mrope_sections=(16, 24, 24), tie_embeddings=False, frontend="vision",
)
