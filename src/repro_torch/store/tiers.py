"""The ``Tier`` protocol and adapters over the existing storage layers.

A tier is one durability/performance class in the walk

    pixel cache -> latent cache -> durable latent store -> recipe store

The durable class is no longer a single codec setting: its latents sit
on a rate-distortion ladder (lossless -> high -> mid -> low lossy rungs,
see :mod:`repro.compression.ladder`), and the recipe store is the
ladder's final rung — zero latent bytes, full regeneration on read.

Each tier answers five questions: does it hold an object (``contains``),
can it serve a lookup (``load`` — the mutating cascade step: LRU touches,
promotion counters, regen detection), how does an object enter it
(``store``), how does it leave (``evict`` + ``evict_cb`` listeners), and
how many bytes are resident (``resident_bytes``).

The adapters wrap — not replace — the battle-tested layers underneath:
:class:`DualCacheTier` over :class:`~repro.core.dual_cache.DualFormatCache`
(covering both the pixel and latent cache classes of one node),
:class:`DurableTier` over :class:`~repro.core.latent_store.LatentStore`,
and :class:`RecipeTier` over
:class:`~repro.core.regen_tier.RegenTierStore`.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Callable, List, Optional

from repro_torch.core.dual_cache import (DualFormatCache, FULL_MISS, IMAGE_HIT,
                                   LATENT_HIT)
from repro_torch.core.latent_store import LatentStore
from repro_torch.core.regen_tier import Recipe, RegenTierStore
from repro_torch.core.tuner import MarginalHitTuner, TunerConfig
from repro_torch.store.api import REGEN_MISS


@dataclasses.dataclass(frozen=True)
class TierHit:
    """Outcome of one tier's ``load`` during the walk."""

    tier: str                       # tier name that answered
    hit_class: str                  # IMAGE_HIT | LATENT_HIT | FULL_MISS | REGEN_MISS
    tail_hit: bool = False
    promoted: bool = False
    needs_decode: bool = True       # pixels must still be produced
    needs_fetch: bool = False       # durable fetch required
    needs_regen: bool = False       # generation pipeline required


class Tier(abc.ABC):
    """One durability class in the tier walk."""

    name: str = "tier"

    @abc.abstractmethod
    def contains(self, oid: int) -> bool:
        """Non-mutating residency probe."""

    @abc.abstractmethod
    def load(self, oid: int) -> Optional[TierHit]:
        """Mutating lookup step of the walk: ``None`` falls through to the
        next tier; a :class:`TierHit` classifies the request."""

    @abc.abstractmethod
    def store(self, oid: int, **kw) -> None:
        """Admit an object into this tier."""

    @abc.abstractmethod
    def evict(self, oid: int) -> bool:
        """Drop an object from this tier (True if it was resident)."""

    def evict_cb(self, cb: Callable[[int], None]) -> None:
        """Register a listener invoked with the oid on every eviction
        (capacity-driven or explicit).  Default: evictions are silent."""
        self._listeners().append(cb)

    def _listeners(self) -> List[Callable[[int], None]]:
        if not hasattr(self, "_evict_listeners"):
            self._evict_listeners: List[Callable[[int], None]] = []
        return self._evict_listeners

    def _notify_evict(self, oid: int) -> None:
        for cb in self._listeners():
            cb(oid)

    @property
    @abc.abstractmethod
    def resident_bytes(self) -> float:
        ...


class DualCacheTier(Tier):
    """One node's dual-format cache: the pixel and latent cache classes.

    ``load`` is the cascading :meth:`DualFormatCache.lookup` (stats,
    segmented-LRU touches, h-threshold promotion) plus the per-request
    tuner hook, so walking through this adapter evolves cache state exactly
    like the pre-facade engine and simulator did.
    """

    def __init__(self, capacity_bytes: float, *, alpha: float, tau: float,
                 promote_threshold: int, image_bytes: float,
                 latent_bytes: float, adaptive: bool = True,
                 tuner: Optional[TunerConfig] = None, name: str = "cache"):
        self.name = name
        self.cache = DualFormatCache(
            capacity_bytes, alpha=alpha, tau=tau,
            promote_threshold=promote_threshold,
            image_size_fn=lambda _oid: image_bytes,
            latent_size_fn=lambda _oid: latent_bytes)
        self.tuner: Optional[MarginalHitTuner] = (
            MarginalHitTuner(self.cache, tuner) if adaptive else None)
        # capacity evictions from either format notify tier listeners
        self.cache.image_tier.on_evict = \
            lambda oid, _sz: self._notify_evict(oid)
        base_cb = self.cache.latent_tier.on_evict    # promotion-counter pop
        def _lat_evict(oid, sz, _base=base_cb):
            if _base is not None:
                _base(oid, sz)
            self._notify_evict(oid)
        self.cache.latent_tier.on_evict = _lat_evict

    def contains(self, oid: int) -> bool:
        return self.cache.contains(oid) is not None

    def load(self, oid: int) -> Optional[TierHit]:
        res = self.cache.lookup(oid)
        if self.tuner is not None:
            self.tuner.on_request()
        if res.outcome == IMAGE_HIT:
            return TierHit(self.name, IMAGE_HIT, tail_hit=res.tail_hit,
                           needs_decode=False)
        if res.outcome == LATENT_HIT:
            return TierHit(self.name, LATENT_HIT, tail_hit=res.tail_hit,
                           promoted=res.promoted)
        return None                                   # FULL_MISS: fall through

    def store(self, oid: int, format: str = "latent",
              nbytes: Optional[float] = None, **_kw) -> None:
        """Admit in either format; ``nbytes`` charges the payload's real
        byte size (engine backends know it, the simulator estimates)."""
        if format == "image":
            self.cache.insert_image(oid, nbytes=nbytes)
        else:
            self.cache.admit_latent(oid, nbytes=nbytes)

    def evict(self, oid: int) -> bool:
        found = self.cache.evict(oid)
        if found:
            self._notify_evict(oid)
        return found

    def set_capacity(self, capacity_bytes: float) -> None:
        """Autoscaler capacity handoff: resize the node's total cache
        bytes, preserving the tuner's alpha split (evictions fire the
        registered tier listeners via the ``on_evict`` hooks)."""
        self.cache.set_capacity(capacity_bytes)

    @property
    def resident_bytes(self) -> float:
        return self.cache.resident_bytes


class DurableTier(Tier):
    """The durable latent class over :class:`LatentStore`.

    Bytes live wherever the store's pluggable
    :class:`~repro.store.durable.backend.DurableBackend` puts them: the
    in-memory dict backend (simulation conformance) or the log-structured
    :class:`~repro.store.durable.backend.SegmentLogBackend` under
    ``StoreConfig.data_dir`` — in which case every ``store``/``evict``
    here is an append-only record (blob or tombstone) in the same
    crash-recoverable segment log the recipe tier journals through.

    Durable latents are NOT lossless-only: each object sits at a
    rate-distortion rung (:mod:`repro.compression.ladder`), descending
    via :meth:`set_target_rung` as it cools.  On the segment log the
    re-encode piggybacks on compaction; in memory it applies eagerly.
    Whatever the rung, the object classifies as the same ``FULL_MISS``
    durable fetch — only the recipe rung changes the walk.
    """

    name = "durable"

    def __init__(self, store: LatentStore):
        self.backing = store                        # the LatentStore

    def contains(self, oid: int) -> bool:
        return oid in self.backing

    def load(self, oid: int) -> Optional[TierHit]:
        if oid not in self.backing:
            return None
        return TierHit(self.name, FULL_MISS, needs_fetch=True)

    def store(self, oid: int, blob: Optional[bytes] = None,
              nbytes: Optional[float] = None, rung: int = 0,
              **_kw) -> None:
        if blob is not None:
            self.backing.put(oid, blob)             # blob carries its rung
        else:
            self.backing.put_size(oid, float(nbytes), int(rung))

    def evict(self, oid: int) -> bool:
        found = self.backing.delete(oid)
        if found:
            self._notify_evict(oid)
        return found

    # -- rate-distortion ladder ----------------------------------------------
    def rung_of(self, oid: int) -> Optional[int]:
        return self.backing.rung_of(oid)

    def target_rung_of(self, oid: int) -> Optional[int]:
        return self.backing.target_rung_of(oid)

    def set_target_rung(self, oid: int, rung: int) -> bool:
        return self.backing.set_target_rung(oid, rung)

    @property
    def resident_bytes(self) -> float:
        return self.backing.total_bytes


class RecipeTier(Tier):
    """The coldest durability class — the ladder's final rung: (prompt,
    seed, model) recipes that regenerate the latent bit-exactly when
    every byte-bearing tier misses.  Near-zero stored bytes, one full
    generation on read.

    On a persistent box the wrapped :class:`RegenTierStore` journals every
    state mutation (put / demote / readmit / delete) as a full-state
    record into the SAME segment log as the durable latents, so recipes
    and demotion flags survive a crash with the blobs they describe."""

    name = "recipe"

    def __init__(self, regen: Optional[RegenTierStore] = None):
        self.regen = regen or RegenTierStore()

    def contains(self, oid: int) -> bool:
        return oid in self.regen

    def load(self, oid: int) -> Optional[TierHit]:
        if oid not in self.regen:
            return None
        self.regen.n_regens += 1
        return TierHit(self.name, REGEN_MISS, needs_regen=True)

    def store(self, oid: int, nbytes: float = 0.0,
              recipe: Optional[Recipe] = None, now_mo: float = 0.0,
              **_kw) -> None:
        self.regen.put(oid, float(nbytes), now_mo=now_mo, recipe=recipe)

    def recipe_of(self, oid: int) -> Optional[Recipe]:
        return self.regen.recipe_of(oid)

    def evict(self, oid: int) -> bool:
        found = self.regen.delete(oid)
        if found:
            self._notify_evict(oid)
        return found

    @property
    def resident_bytes(self) -> float:
        return self.regen.recipe_bytes
