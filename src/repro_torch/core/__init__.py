"""Cache, tuner, router, durable store, regeneration tier, cluster
simulator and trace replay (copies of the JAX package's JAX-free
modules, import paths rewritten).  Import the submodules directly;
nothing is imported eagerly here."""
