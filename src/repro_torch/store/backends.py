"""The engine backend of the ``LatentBox`` facade (counterpart of the
JAX package's ``store/backends.py``, cut to :class:`EngineBackend` with
in-memory durable tiers).

It runs the shared :class:`~repro_torch.store.walk.TierWalk` read path
with real decode on the card through the microbatching scheduler
(``serve/engine.py``): measured wall clock in the latency breakdown,
true uint8 or float32 pixels in ``GetResult.payload``.  Puts take a
latent, an image or a recipe (images and recipes are encoded on the
card), and reads of recipe-only objects regenerate them.  The
segment-log durable tiers (``StoreConfig.data_dir``) and the simulator
backend wait for later slices.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.compression.ladder import RECIPE_RUNG, resolve_rung
from repro_torch.core.latent_store import LatentStore
from repro_torch.core.regen_tier import Recipe, RegenTierStore
from repro_torch.store.api import GetResult, ObjectStat, PutResult, StoreConfig
from repro_torch.store.walk import TierWalk


def _open_durable(cfg: StoreConfig) -> Tuple[LatentStore, RegenTierStore]:
    """The in-memory durable pair (latent store + regen tier)."""
    if cfg.data_dir is not None:
        from repro_torch.serve.engine import not_ported
        raise not_ported("StoreConfig.data_dir (the segment-log durable "
                         "store)", "ROADMAP queue A, durable segment log")
    return LatentStore(cfg.store_latency, seed=cfg.seed + 1), RegenTierStore()


def _stat(walk: TierWalk, store: LatentStore, regen: RegenTierStore,
          oid: int) -> Optional[ObjectStat]:
    residency = walk.residency(oid)
    if not residency:
        return None
    st = store.stat(oid)
    demoted = regen.is_demoted(oid)
    # ladder position: the durable rung when bytes exist, the recipe rung
    # when demoted to recipe-only, None when the object has no durable class
    rung = st["rung"] if st else (RECIPE_RUNG if demoted else None)
    return ObjectStat(
        oid=oid,
        residency=residency,
        durable_bytes=st["nbytes"] if st else 0.0,
        recipe_bytes=(regen.recipe_of(oid).nbytes
                      if regen.recipe_of(oid) else 0.0),
        pixel_bytes=walk.pixel_bytes_of(oid),
        demoted=demoted,
        rung=rung,
        rung_name=resolve_rung(rung).name if rung is not None else None,
        target_rung=st["target_rung"] if st else None)


class EngineBackend:
    """Real-decode backend: wraps
    :class:`repro_torch.serve.engine.ServingEngine`."""

    name = "engine"

    def __init__(self, vae, cfg: Optional[StoreConfig] = None, device=None):
        from repro_torch.serve.engine import ServingEngine
        self.cfg = cfg or StoreConfig()
        self.store, self.regen = _open_durable(self.cfg)
        self.engine = ServingEngine(vae, self.store, self.cfg,
                                    recipes=self.regen, device=device)
        self.walk = self.engine.walk

    # -- object lifecycle ---------------------------------------------------
    def put(self, oid: int, image=None, latent=None,
            recipe: Optional[Recipe] = None, nbytes: Optional[float] = None,
            prewarm: bool = False) -> PutResult:
        if image is None and latent is None and recipe is None:
            raise ValueError(
                "the engine backend stores real payloads: pass an image, "
                "a latent, or a recipe (nbytes-only puts are sim-only)")
        stored = self.engine.put(oid, image=image, latent=latent,
                                 recipe=recipe)
        if prewarm:
            self.engine.prewarm(oid)
        return PutResult(oid, float(stored),
                         recipe_bytes=float(recipe.nbytes) if recipe else 0.0,
                         format="latent", prewarmed=prewarm, durable=False)

    def get_many(self, oids: Sequence[int],
                 timestamps_ms=None) -> List[GetResult]:
        # timestamps are a simulator concept; the engine serves at wall-clock
        tickets = self.engine.serve_window(oids)
        out = []
        for t in tickets:
            total = t.fetch_ms + t.regen_ms + t.decode_ms
            out.append(GetResult(
                oid=t.oid, hit_class=t.outcome, payload=t.img,
                node=t.owner.idx,
                exec_node=t.exec_node.idx if t.exec_node else t.owner.idx,
                spilled=t.spilled, regenerated=t.regen_ms > 0,
                latency_ms={"fetch": t.fetch_ms, "regen": t.regen_ms,
                            "decode": t.decode_ms, "total": total}))
        return out

    def pixels_resident(self, oid: int) -> bool:
        return self.walk.pixels_resident(oid)

    def delete(self, oid: int) -> bool:
        return self.engine.delete(oid)

    def demote(self, oid: int, rung=None) -> bool:
        return self.engine.demote(oid, rung)

    def promote(self, oid: int) -> bool:
        return self.engine.promote(oid)

    def stat(self, oid: int) -> Optional[ObjectStat]:
        return _stat(self.walk, self.store, self.regen, oid)

    def summary(self) -> Dict:
        return self.engine.summary()
