"""Latent codec, rate-distortion ladder, fidelity metrics and the PNG
and JPEG size proxies (copies of the JAX package's JAX-free modules,
import paths rewritten)."""
from repro_torch.compression.latentcodec import compress_latent, decompress_latent
from repro_torch.compression.metrics import psnr, ssim

__all__ = ["compress_latent", "decompress_latent", "psnr", "ssim"]
