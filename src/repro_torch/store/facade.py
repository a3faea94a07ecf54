"""``LatentBox`` — the client-facing facade of the object store
(counterpart of the JAX package's ``store/facade.py``).

    box = LatentBox.engine(device="cuda")         # real decode on the card
    box.put(42, latent=z)                         # z: [h, w, C] float16
    box.put(43, image=img)                        # uint8 HWC, encoded
    box.put(44, recipe=Recipe(seed=7, height=512, width=512))
    r = box.get(42)                               # GetResult: uint8 pixels
    #                                               + hit class + latency
    box.demote(44); box.get(44)                   # regenerated from recipe
    box.stat(42), box.delete(42), box.summary()

    with LatentBox.open(path, device="cuda") as box:   # persistent box
        box.put(1, latent=z)                      # durable=True: on disk
    LatentBox.open(path, device="cuda").get(1)    # same pixels, reopened

``shards > 1`` serves a consistent-hash-sharded cluster
(:class:`~repro_torch.store.sharding.ShardedLatentBox`), with
``replication``, ``hedge`` and ``fault_plan`` for replica placement,
hedged reads and scripted failures; every shard decodes on the one
``device``.  ``LatentBox.simulated()`` swaps the backend for the discrete
latency plant: same tier walk, same classifications, no decode.
``serve_stream()`` replays a timestamped request stream through the
event-loop serving runtime (``serve/runtime/``) on any of these boxes.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.regen_tier import Recipe
from repro_torch.store.api import GetResult, ObjectStat, PutResult, StoreConfig


class LatentBox:
    """Unified object-store facade over a pluggable tier backend."""

    def __init__(self, backend):
        self._backend = backend
        self._meta: Dict[int, Dict[str, Any]] = {}

    # -- constructors --------------------------------------------------------
    @classmethod
    def engine(cls, vae=None, config: Optional[StoreConfig] = None,
               seed: int = 0, shards: int = 1,
               replication: Optional[int] = None, hedge=None,
               fault_plan=None, device=None) -> "LatentBox":
        """Real-decode box on ``device`` (default ``"cuda"``; raises where
        CUDA is absent).  Without an explicit ``vae`` the calibrated demo
        VAE is built on that device; a given ``vae`` must live there.
        ``shards > 1`` serves a consistent-hash-sharded cluster of engine
        backends with ``config.n_nodes`` nodes per shard, all decoding
        through the one ``vae``; ``replication``/``hedge``/``fault_plan``
        configure R-way replica placement, hedged reads, and scripted
        failure injection on that cluster (see
        :class:`~repro_torch.store.sharding.ShardedLatentBox`)."""
        from repro_torch.store.backends import EngineBackend
        if vae is None:
            from repro_torch.vae.model import demo_vae
            vae = demo_vae(seed=seed, device=device)
        if shards > 1 or (replication or 1) > 1 or fault_plan is not None:
            from repro_torch.store.sharding import ShardedLatentBox
            return cls(ShardedLatentBox.engine(
                vae, shards, config, replication=replication, hedge=hedge,
                fault_plan=fault_plan, device=device))
        return cls(EngineBackend(vae, config, device=device))

    @classmethod
    def simulated(cls, config: Optional[StoreConfig] = None,
                  shards: int = 1, replication: Optional[int] = None,
                  hedge=None, fault_plan=None) -> "LatentBox":
        """Latency-plant box: identical classifications, modeled latency.
        ``shards > 1`` serves a consistent-hash-sharded cluster of sim
        backends, each with its own GPU plant and tuner state;
        ``replication``/``hedge``/``fault_plan`` as for :meth:`engine`."""
        from repro_torch.store.backends import SimBackend
        if shards > 1 or (replication or 1) > 1 or fault_plan is not None:
            from repro_torch.store.sharding import ShardedLatentBox
            return cls(ShardedLatentBox.simulated(
                shards, config, replication=replication, hedge=hedge,
                fault_plan=fault_plan))
        return cls(SimBackend(config))

    @classmethod
    def open(cls, path, mode: str = "engine",
             config: Optional[StoreConfig] = None, vae=None, seed: int = 0,
             shards: int = 1, replication: Optional[int] = None,
             hedge=None, fault_plan=None, device=None) -> "LatentBox":
        """Open (or create) a *persistent* box on ``path``.

        The durable-latent and recipe tiers write through one
        log-structured segment store under ``path`` (per-shard
        subdirectories when ``shards > 1``).  The reopen guarantee:
        after ANY process exit — clean ``close()``, hard kill mid-write,
        or kill mid-compaction — ``LatentBox.open(path)`` recovers every
        *acknowledged* put (``PutResult.durable`` / past ``flush()``) and
        serves it bit-exact: same blob bytes, same decoded pixels on the
        same device, same recipes and demotion flags.  Unacknowledged
        tail records are detected by checksum and cleanly ignored.  Cache
        warmth and store-latency warmth are process state and restart
        cold, like a node rejoining a fleet.  ``device`` is the engine's
        (``mode="engine"``); the simulator decodes nothing.
        """
        import dataclasses as _dc
        cfg = _dc.replace(config or StoreConfig(), data_dir=str(path))
        if mode == "engine":
            return cls.engine(vae=vae, config=cfg, seed=seed, shards=shards,
                              replication=replication, hedge=hedge,
                              fault_plan=fault_plan, device=device)
        if mode == "sim":
            return cls.simulated(cfg, shards=shards,
                                 replication=replication, hedge=hedge,
                                 fault_plan=fault_plan)
        raise ValueError(f"mode must be 'engine' or 'sim': {mode!r}")

    @property
    def backend(self):
        return self._backend

    # -- writes --------------------------------------------------------------
    def put(self, oid: int, image: Optional[np.ndarray] = None,
            latent: Optional[np.ndarray] = None,
            recipe: Optional[Recipe] = None,
            nbytes: Optional[float] = None,
            meta: Optional[Dict[str, Any]] = None,
            prewarm: bool = False) -> PutResult:
        """Durable write: encode (an image or a recipe's pixels) ->
        compress the latent -> latent store; a recipe also registers the
        recipe-only durability class.  ``prewarm`` pins decoded pixels at
        the hash owner so the first read is an image hit."""
        res = self._backend.put(int(oid), image=image, latent=latent,
                                recipe=recipe, nbytes=nbytes, prewarm=prewarm)
        if meta is not None:
            self._meta[int(oid)] = dict(meta)
        return res

    # -- reads ---------------------------------------------------------------
    def get(self, oid: int) -> GetResult:
        return self.get_many([oid])[0]

    def get_many(self, oids: Sequence[int],
                 timestamps_ms: Optional[Sequence[float]] = None
                 ) -> List[GetResult]:
        """Serve a request window through the tier walk."""
        return self._backend.get_many(oids, timestamps_ms=timestamps_ms)

    def serve_stream(self, requests, runtime_cfg=None):
        """Replay an open-loop request stream (timestamped arrivals)
        through the event-loop serving runtime: continuous microbatching,
        per-tenant QoS, SLO classes, and admission control.

        ``requests`` is a :class:`~repro_torch.trace.synth.SyntheticTrace`
        or a sequence of :class:`repro_torch.serve.runtime.Request`;
        ``runtime_cfg`` a :class:`repro_torch.serve.runtime.RuntimeConfig`
        (the default derives the service model from this box's
        ``StoreConfig``).  Returns a
        :class:`repro_torch.serve.runtime.StreamReport`: per-request
        outcomes in arrival order, the columnar ``RequestLog`` (queue
        delay, deadlines, tenants), and scheduler counters.
        """
        stream = getattr(self._backend, "serve_stream", None)
        if stream is not None:          # backend owns the continuous feed
            return stream(requests, runtime_cfg=runtime_cfg)
        from repro_torch.serve.runtime import RuntimeConfig, ServingRuntime
        if runtime_cfg is None:
            runtime_cfg = RuntimeConfig.from_store(self._backend.cfg)
        return ServingRuntime.for_target(self._backend, runtime_cfg).run(
            requests)

    def pixels_resident(self, oid: int) -> bool:
        """Pure peek: is ``oid`` pixel-cache resident at its hash owner?"""
        return bool(self._backend.pixels_resident(int(oid)))

    # -- lifecycle -----------------------------------------------------------
    def delete(self, oid: int) -> bool:
        """Remove the object from every tier and forget its metadata."""
        found = self._backend.delete(int(oid))
        self._meta.pop(int(oid), None)
        return found

    def stat(self, oid: int) -> Optional[ObjectStat]:
        st = self._backend.stat(int(oid))
        if st is not None:
            st.meta = self._meta.get(int(oid))
        return st

    def demote(self, oid: int, rung=None) -> bool:
        """Demote the object down the rate-distortion ladder."""
        return self._backend.demote(int(oid), rung)

    def promote(self, oid: int) -> bool:
        return self._backend.promote(int(oid))

    # -- durability ----------------------------------------------------------
    def flush(self) -> None:
        """Crash-durability barrier: every write accepted so far (including
        write-behind puts) is on disk, and the manifest checkpoint bounds
        the next reopen's recovery scan.  No-op on in-memory boxes."""
        flush = getattr(self._backend, "flush", None)
        if flush is not None:
            flush()

    def close(self) -> None:
        """Seal the active segment, checkpoint the manifest, and release
        file handles.  The box must not be used afterwards; reopen with
        :meth:`open`.  No-op on in-memory boxes."""
        close = getattr(self._backend, "close", None)
        if close is not None:
            close()

    def __enter__(self) -> "LatentBox":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- introspection -------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        return self._backend.summary()

    def __contains__(self, oid: int) -> bool:
        return self._backend.stat(int(oid)) is not None
