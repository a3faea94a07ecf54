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

    with LatentBox.engine(device="cpu") as box:  # flush/close: no-ops
        ...                                       # on an in-memory box

This slice ports the single-box engine constructor.  Sharding,
replication and fault injection (``shards > 1``, ``replication > 1``,
``fault_plan``), ``simulated()`` and ``serve_stream()`` raise
``NotImplementedError`` naming ROADMAP A 6; ``open()`` (persistent boxes)
names A 5.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.regen_tier import Recipe
from repro_torch.store.api import GetResult, ObjectStat, PutResult, StoreConfig


def not_ported(what: str, item: str) -> NotImplementedError:
    from repro_torch.serve.engine import not_ported as error
    return error(what, item)


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
        The reference's sharded cluster (``shards > 1``, ``replication >
        1`` or a ``fault_plan``) is not ported; a ``hedge`` alone is
        accepted and, as there, has no effect on a single box."""
        from repro_torch.store.backends import EngineBackend
        if shards > 1 or (replication or 1) > 1 or fault_plan is not None:
            raise not_ported("LatentBox.engine(shards=, replication=, "
                             "fault_plan=) (a ShardedLatentBox)",
                             "ROADMAP A 6")
        if vae is None:
            from repro_torch.vae.model import demo_vae
            vae = demo_vae(seed=seed, device=device)
        return cls(EngineBackend(vae, config, device=device))

    @classmethod
    def simulated(cls, config: Optional[StoreConfig] = None,
                  shards: int = 1, replication: Optional[int] = None,
                  hedge=None, fault_plan=None) -> "LatentBox":
        """The reference's latency-plant box (not ported)."""
        raise not_ported("LatentBox.simulated (the latency plant)",
                         "ROADMAP A 6")

    @classmethod
    def open(cls, path, mode: str = "engine",
             config: Optional[StoreConfig] = None, vae=None, seed: int = 0,
             shards: int = 1, replication: Optional[int] = None,
             hedge=None, fault_plan=None) -> "LatentBox":
        """The reference's persistent box on ``path`` (not ported)."""
        raise not_ported("LatentBox.open (the segment-log durable store)",
                         "ROADMAP A 5")

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
        """The reference's event-loop serving runtime (not ported)."""
        raise not_ported("LatentBox.serve_stream (the serving runtime)",
                         "ROADMAP A 6")

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
        """Crash-durability barrier of a persistent backend; no-op on
        in-memory boxes (the only kind this port opens yet)."""
        flush = getattr(self._backend, "flush", None)
        if flush is not None:
            flush()

    def close(self) -> None:
        """Release a persistent backend; no-op on in-memory boxes."""
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
