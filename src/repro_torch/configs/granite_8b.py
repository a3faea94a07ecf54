"""granite-8b [dense]: llama-arch, code.  [arXiv:2405.04324; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=49152, act="swiglu", rope_theta=1e7, tie_embeddings=True,
)
