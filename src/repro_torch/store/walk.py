"""The one tier-walk read path shared by every LatentBox backend.

Before this module the hit/miss classification logic lived twice — once in
``serve/engine.py`` (real decode fleet) and once in ``core/cluster.py``
(discrete-event plant) — and the two drifted.  :class:`TierWalk` owns the
parts of a request that are *backend-independent*: consistent-hash
ownership, per-node dual-format cache lookup (stats, promotion, tuner
hook), queue-depth spillover choice, latent admission on a durable fetch,
and regen detection on the recipe tier.  Backends consume the resulting
:class:`WalkTicket` and supply only what differs: real decodes and
wall-clock on the engine, latency events on the simulator.

Two backends built from the same :class:`~repro.store.api.StoreConfig`
therefore classify a shared trace identically — the property
``tests/test_store_api.py`` locks in.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from repro_torch.compression.ladder import resolve_rung
from repro_torch.core.dual_cache import IMAGE_HIT, LATENT_HIT, FULL_MISS
from repro_torch.core.router import Router
from repro_torch.store.api import REGEN_MISS, StoreConfig
from repro_torch.store.tiers import DualCacheTier, DurableTier, RecipeTier


@dataclasses.dataclass
class WalkTicket:
    """One request's backend-independent routing/classification decision."""

    oid: int
    hit_class: str              # image_hit | latent_hit | full_miss | regen_miss
    owner: int                  # cache home (hash-pinned)
    exec_node: int              # where the decode should run
    spilled: bool = False
    tail_hit: bool = False
    promoted: bool = False
    write_image: bool = False   # pixel write-back decision made at lookup
    needs_fetch: bool = False   # durable fetch on the critical path
    needs_regen: bool = False   # generation pipeline on the critical path


class TierWalk:
    """Pixel cache -> latent cache -> durable store -> recipe regen."""

    def __init__(self, cfg: StoreConfig, durable: DurableTier,
                 recipes: Optional[RecipeTier] = None):
        self.cfg = cfg
        names = (list(cfg.node_names) if cfg.node_names is not None
                 else [f"node{i}" for i in range(cfg.n_nodes)])
        self.node_names = names
        self.caches: List[DualCacheTier] = [
            DualCacheTier(cfg.cache_bytes_per_node, alpha=cfg.alpha0,
                          tau=cfg.tau,
                          promote_threshold=cfg.promote_threshold,
                          image_bytes=cfg.image_bytes,
                          latent_bytes=cfg.latent_bytes,
                          adaptive=cfg.adaptive, tuner=cfg.tuner,
                          name=f"cache@{name}")
            for name in names]
        self.durable = durable
        self.recipes = recipes
        self.router = Router(names, theta=cfg.promote_threshold)
        self._idx: Dict[str, int] = {n: i for i, n in enumerate(names)}
        self.counts: Dict[str, int] = {
            IMAGE_HIT: 0, LATENT_HIT: 0, FULL_MISS: 0, REGEN_MISS: 0,
            "spilled": 0}

    # -- read path -----------------------------------------------------------
    def lookup(self, oid: int,
               depth_of: Optional[Callable[[int], int]] = None) -> WalkTicket:
        """Classify one request and evolve cache state.

        ``depth_of(node_idx)`` reports decode queue depth for the spillover
        decision (engine: pending unique decodes; sim: GPU outstanding);
        ``None`` disables spillover.  Raises ``KeyError`` when the object
        is in no tier at all.
        """
        owner = self._idx[self.router.ring.owner(oid)]
        cache = self.caches[owner]
        hit = cache.load(oid)

        if hit is not None and hit.hit_class == IMAGE_HIT:
            self.counts[IMAGE_HIT] += 1
            return WalkTicket(oid, IMAGE_HIT, owner, owner,
                              tail_hit=hit.tail_hit, write_image=True)

        # decode required: pick the execution node (spillover w/ pinning)
        exec_node, spilled = owner, False
        if depth_of is not None and len(self.caches) > 1:
            for name, i in self._idx.items():
                self.router.report_depth(name, depth_of(i))
            if depth_of(owner) > self.router.theta:
                cand = self._idx[self.router.least_loaded(
                    exclude=self.node_names[owner])]
                if depth_of(cand) < depth_of(owner):
                    exec_node, spilled = cand, True
                    self.counts["spilled"] += 1
                    self.router.n_spillover += 1

        if hit is not None:                           # latent cache hit
            self.counts[LATENT_HIT] += 1
            return WalkTicket(
                oid, LATENT_HIT, owner, exec_node, spilled=spilled,
                tail_hit=hit.tail_hit, promoted=hit.promoted,
                write_image=(hit.promoted
                             or cache.cache.contains(oid) == "image"))

        # NOTE: admission into the latent cache is the backend's job via
        # :meth:`admit_latent` AFTER the payload materializes — admitting
        # here would poison cache state when the fetch/regen fails.
        dh = self.durable.load(oid)
        if dh is not None:                            # durable latent fetch
            self.counts[FULL_MISS] += 1
            return WalkTicket(oid, FULL_MISS, owner, exec_node,
                              spilled=spilled, needs_fetch=True)

        rh = self.recipes.load(oid) if self.recipes is not None else None
        if rh is not None:                            # recipe-only: regenerate
            self.counts[REGEN_MISS] += 1
            return WalkTicket(oid, REGEN_MISS, owner, exec_node,
                              spilled=spilled, needs_regen=True)

        raise KeyError(f"object {oid} not in any tier")

    def admit_latent(self, owner: int, oid: int) -> bool:
        """Admit a successfully fetched/regenerated latent into the owner's
        cache; returns True when it is latent-tier resident afterwards."""
        cache = self.caches[owner]
        cache.store(oid, format="latent")
        return oid in cache.cache.latent_tier

    def set_cache_capacity(self, bytes_per_node: float) -> None:
        """Autoscaler capacity handoff: resize every node's total cache
        bytes.  Alpha (the pixel/latent split) is preserved per node —
        the marginal-hit tuner keeps owning the split."""
        for tier in self.caches:
            tier.set_capacity(bytes_per_node)

    # -- lifecycle -----------------------------------------------------------
    def delete(self, oid: int) -> bool:
        """Remove an object from every tier (caches, durable, recipes)."""
        found = False
        for tier in self.caches:
            found |= tier.evict(oid)
        found |= self.durable.evict(oid)
        if self.recipes is not None:
            found |= self.recipes.evict(oid)
        return found

    def demote(self, oid: int, rung=None) -> bool:
        """Durability-class demotion down the rate-distortion ladder.

        ``rung=None`` (or ``"recipe"``) keeps the pre-ladder meaning —
        all the way down: drop the durable latent and every cached copy,
        keep only the recipe.  A lossy rung (index/name) instead asks the
        durable tier to re-encode the object at that colder quality: the
        object stays durable (identical ``FULL_MISS`` classification on
        every backend — the segment log defers the transcode to its next
        compaction pass, the memory backend applies it eagerly), and
        cached copies are deliberately left alone: a cached latent is
        merely stale-at-higher-quality, which natural eviction resolves.
        Refuses (returns False) for the lossless rung, for unknown
        objects, and for targets not strictly colder than the current
        rung."""
        r = resolve_rung(rung)
        if not r.is_recipe:
            if r.index <= 0:
                return False              # "demote to lossless" is a no-op
            if not self.durable.contains(oid):
                return False
            return self.durable.set_target_rung(oid, r.index)
        if self.recipes is None or self.recipes.recipe_of(oid) is None:
            return False                  # no recipe: would strand the object
        if not self.durable.contains(oid):
            return False                  # already demoted / unknown
        self.durable.evict(oid)
        self.recipes.regen.demote(oid)
        for tier in self.caches:
            tier.evict(oid)
        return True

    def pixels_resident(self, oid: int) -> bool:
        """Pure peek (no stats, no state evolution): is ``oid`` currently
        resident in its hash owner's pixel tier?  The admission
        controller's ``degrade`` policy uses this to answer from the pixel
        cache without spending a decode slot."""
        owner = self._idx[self.router.ring.owner(oid)]
        return self.caches[owner].cache.contains(oid) == "image"

    def pixel_bytes_of(self, oid: int) -> float:
        """Bytes the pixel tier charges for ``oid`` (0.0 when not
        pixel-resident on any node).  The engine corrects these charges to
        the stored array's real dtype bytes, so this is actual-uint8-sized
        on the fast path."""
        for tier in self.caches:
            sz = tier.cache.image_tier.size_of(oid)
            if sz is not None:
                return float(sz)
        return 0.0

    def residency(self, oid: int) -> List[str]:
        out: List[str] = []
        for i, tier in enumerate(self.caches):
            where = tier.cache.contains(oid)
            if where is not None:
                out.append(f"{where}@{self.node_names[i]}")
        if self.durable.contains(oid):
            out.append("durable")
        if self.recipes is not None and self.recipes.contains(oid):
            out.append("recipe")
        return out

    def summary(self) -> Dict[str, float]:
        total = sum(self.counts[k] for k in
                    (IMAGE_HIT, LATENT_HIT, FULL_MISS, REGEN_MISS))
        out: Dict[str, float] = dict(self.counts)
        out["total"] = total
        if total:
            out["image_hit_frac"] = self.counts[IMAGE_HIT] / total
            out["decode_frac"] = 1.0 - out["image_hit_frac"]
        out["alpha"] = [round(t.cache.alpha, 3) for t in self.caches]
        out["cache_resident_bytes"] = float(
            sum(t.resident_bytes for t in self.caches))
        # pixel-tier byte economics: resident charges are real stored
        # bytes on the engine (uint8 fast path), config estimates on the sim
        out["pixel_cached_objects"] = int(
            sum(len(t.cache.image_tier) for t in self.caches))
        out["pixel_cached_bytes"] = float(
            sum(t.cache.image_tier.resident_bytes for t in self.caches))
        out["pixel_bytes_per_object"] = (
            out["pixel_cached_bytes"] / out["pixel_cached_objects"]
            if out["pixel_cached_objects"] else float(self.cfg.image_bytes))
        out["durable_bytes"] = self.durable.resident_bytes
        if self.recipes is not None:
            out["recipe_bytes"] = self.recipes.resident_bytes
        return out
