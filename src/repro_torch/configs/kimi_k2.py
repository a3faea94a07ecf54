"""kimi-k2-1t-a32b [moe]: trillion-param MoE, 384 experts top-8
(paper-table).  [arXiv:2501.kimi2; unverified]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
    vocab_size=163840, act="swiglu", rope_theta=5e6,
    n_experts=384, experts_per_token=8, tie_embeddings=False,
)
