"""PyTorch/CUDA port of LatentBox: the read path (tier walk -> decode
batcher -> VAE ``decode_u8``) and the write and regeneration path
(``put`` of images and recipes -> VAE ``encode``), with hand-written
Hopper kernels; the persistent, sharded store, the serving runtime that
replays scenario traces (``serve.runtime``, ``trace``) and the LM
substrate around them.

The JAX package :mod:`repro` is the reference this package is held
against; nothing here imports it or JAX.  Subpackages are imported
explicitly (``repro_torch.store``, ``repro_torch.vae.model``, ...)."""
