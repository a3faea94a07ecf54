"""whisper-large-v3 [audio]: enc-dec, conv frontend STUB (precomputed frame
embeddings).  [arXiv:2212.04356; unverified]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, encoder_layers=32, encoder_seq=1500,
    d_model=1280, n_heads=20, n_kv_heads=20, d_ff=5120,
    vocab_size=51866, act="gelu", qkv_bias=True, rope_theta=0.0,
    tie_embeddings=True, frontend="audio", norm_eps=1e-5,
)
