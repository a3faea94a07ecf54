"""The VAE decoder (uint8 read path) in PyTorch."""
