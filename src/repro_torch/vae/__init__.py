"""The VAE (decoder and encoder) in PyTorch."""
