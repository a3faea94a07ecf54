"""Kernel layer: plain PyTorch versions (``ref``), hand-written Hopper
kernels (``csrc/``, built by ``build``), and the device dispatch with
launch counters (``ops``)."""
