"""Language models in PyTorch: the dense causal LM's serving path."""
