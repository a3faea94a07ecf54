import os

# Tests must see the real 1-CPU world (the dry-run sets its own flags in a
# separate process).  Keep any accidental device-count override out.
os.environ.pop("XLA_FLAGS", None)

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: full differential matrices (shard x backend x scenario); "
        "run by the scheduled CI job, excluded from push CI via -m 'not slow'")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (the PyTorch port's Hopper "
        "kernels); skipped elsewhere")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# ---------------------------------------------------------------------------
# shared helpers of the shard-conformance harness (tests/test_shard_*.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="session")
def tiny_vae():
    """One tiny VAE for every engine-backend test in the session: all
    backends sharing this instance share its jitted decode, so each batch
    bucket compiles once for the whole run."""
    from repro.vae.model import VAE, VAEConfig
    return VAE(VAEConfig(name="tiny", latent_channels=4,
                         block_out_channels=(16, 32),
                         layers_per_block=1, groups=4), seed=0)


def conformance_config(n_nodes: int, **kw):
    """StoreConfig for differential runs: real capacity pressure (caches
    evict), but the marginal-hit tuner's window never fires — alpha stays
    put, so classification depends only on the per-node request
    subsequences, which the global node namespace makes shard-invariant.
    """
    from repro.core.tuner import TunerConfig
    from repro.store import StoreConfig
    # image_bytes = uint8 nbytes of a decoded 16x16x3 image: the engine
    # backend charges real stored-array bytes, so every cell of the
    # differential matrix must estimate the same truth
    base = dict(n_nodes=n_nodes, cache_bytes_per_node=2e4, image_bytes=768.0,
                latent_bytes=6e2, promote_threshold=2,
                tuner=TunerConfig(window=10**9))
    base.update(kw)
    return StoreConfig(**base)


def make_box(kind: str, shards: int, total_nodes: int, vae=None, **cfg_kw):
    """Build a LatentBox cell of the differential matrix: ``total_nodes``
    is the global fleet size, split evenly across ``shards``."""
    from repro.store import LatentBox
    assert total_nodes % shards == 0
    cfg = conformance_config(total_nodes // shards, **cfg_kw)
    if kind == "engine":
        return LatentBox.engine(vae=vae, config=cfg, shards=shards)
    if kind == "sim":
        return LatentBox.simulated(cfg, shards=shards)
    raise ValueError(kind)


def fill_and_demote(box, n_objects: int, demote=(3, 7, 11), res: int = 16):
    """Identical starting state for every cell: recipe-backed puts, a few
    objects demoted to recipe-only durability (regen coverage)."""
    from repro.core.regen_tier import Recipe
    for oid in range(n_objects):
        box.put(oid, recipe=Recipe(seed=1000 + oid, height=res, width=res))
    for oid in demote:
        if oid < n_objects:
            assert box.demote(oid)


def classify(box, object_ids, window: int = 8):
    """Replay a trace through the facade in fixed windows; returns the
    differential signature: per-request (hit_class, owner node)."""
    out = []
    ids = [int(i) for i in object_ids]
    for s in range(0, len(ids), window):
        out += [(r.hit_class, r.node) for r in box.get_many(ids[s:s + window])]
    return out
