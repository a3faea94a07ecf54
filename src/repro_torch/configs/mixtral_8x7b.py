"""mixtral-8x7b [moe]: 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]  SWA => sub-quadratic => long_500k runs."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=32000, act="swiglu", rope_theta=1e6,
    n_experts=8, experts_per_token=2, sliding_window=4096,
    tie_embeddings=False, subquadratic=True,
)
