"""rwkv6-7b [ssm]: Finch — attention-free, data-dependent decay.
[arXiv:2404.05892; hf]  O(1) decode state => long_500k runs."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm", ssm_type="rwkv6",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, d_ff=14336,
    vocab_size=65536, ssm_head_dim=64, rope_theta=0.0,
    tie_embeddings=False, subquadratic=True,
)
