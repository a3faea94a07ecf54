"""zamba2-2.7b [hybrid]: Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; hf]  SSM state => long_500k runs."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid", ssm_type="mamba2",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab_size=32000, ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    conv_width=4, attn_every=6, rope_theta=1e4,
    tie_embeddings=True, subquadratic=True,
)
