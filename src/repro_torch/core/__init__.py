"""Cache, tuner, router, durable store and regeneration tier (copies of
the JAX package's JAX-free modules, import paths rewritten).  Import the
submodules directly; nothing is imported eagerly here."""
