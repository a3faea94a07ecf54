"""Dual-format cache (paper §4.2).

Two independent byte-capacity LRU tiers sharing a fixed total capacity ``C``:
an *image tier* holding decoded images (fast hits) and a *latent tier*
holding compressed latents (more coverage, hit => GPU decode).  An ``alpha``
fraction of ``C`` goes to the image tier, ``1 - alpha`` to the latent tier.

Each tier is a :class:`SegmentedLRU`: a *main* segment of fraction
``1 - tau`` and a thin *tail* segment of fraction ``tau``.  Items evicted
from main enter the tail; items evicted from the tail leave the cache.  A
*tail hit* identifies a request that would have been a miss had the tier
been ``tau`` smaller — the marginal-hit signal consumed by the online tuner
(§4.3).

Invariants (enforced + property-tested):
  * every object lives in exactly one tier at a time;
  * resident bytes of each tier never exceed its capacity (after any op);
  * a latent-tier object is promoted to the image tier after ``h`` latent
    hits and atomically removed from the latent tier.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from repro_torch.core.latent_store import DEFAULT_OBJECT_BYTES

# ---------------------------------------------------------------------------
# Segmented LRU
# ---------------------------------------------------------------------------


class SegmentedLRU:
    """Byte-capacity LRU split into a main segment and a thin tail segment.

    ``tau`` is the fraction of the tier's capacity reserved for the tail.
    Lookup promotes hits (from main or tail) to the MRU position of main.
    """

    __slots__ = ("capacity", "tau", "on_evict", "_main", "_tail", "_main_bytes",
                 "_tail_bytes")

    def __init__(self, capacity: float, tau: float = 0.1,
                 on_evict: Optional[Callable[[int, float], None]] = None):
        if capacity < 0:
            raise ValueError("capacity must be >= 0")
        if not (0.0 <= tau < 1.0):
            raise ValueError("tau must be in [0, 1)")
        self.capacity = float(capacity)
        self.tau = float(tau)
        self.on_evict = on_evict
        self._main: "OrderedDict[int, float]" = OrderedDict()  # id -> bytes
        self._tail: "OrderedDict[int, float]" = OrderedDict()
        self._main_bytes = 0.0
        self._tail_bytes = 0.0

    # -- capacities ---------------------------------------------------------
    @property
    def main_capacity(self) -> float:
        return self.capacity * (1.0 - self.tau)

    @property
    def tail_capacity(self) -> float:
        return self.capacity * self.tau

    @property
    def resident_bytes(self) -> float:
        return self._main_bytes + self._tail_bytes

    def __len__(self) -> int:
        return len(self._main) + len(self._tail)

    def __contains__(self, oid: int) -> bool:
        return oid in self._main or oid in self._tail

    def __iter__(self) -> Iterator[int]:
        yield from self._main
        yield from self._tail

    def size_of(self, oid: int) -> Optional[float]:
        if oid in self._main:
            return self._main[oid]
        if oid in self._tail:
            return self._tail[oid]
        return None

    # -- internal balancing -------------------------------------------------
    def _rebalance(self) -> List[Tuple[int, float]]:
        """Demote main overflow into tail, evict tail overflow. Returns
        evicted ``(id, bytes)`` pairs."""
        evicted: List[Tuple[int, float]] = []
        main_cap, tail_cap = self.main_capacity, self.tail_capacity
        # Demote main LRU -> tail MRU.
        while self._main and self._main_bytes > main_cap:
            oid, sz = self._main.popitem(last=False)
            self._main_bytes -= sz
            self._tail[oid] = sz
            self._tail_bytes += sz
        # Evict tail LRU out of the cache.
        while self._tail and self._tail_bytes > tail_cap:
            oid, sz = self._tail.popitem(last=False)
            self._tail_bytes -= sz
            evicted.append((oid, sz))
        # Degenerate case: tau == 0 -> tail capacity 0; everything demoted is
        # evicted immediately (handled above since tail_cap == 0).
        if self.on_evict is not None:
            for oid, sz in evicted:
                self.on_evict(oid, sz)
        return evicted

    # -- public ops ----------------------------------------------------------
    def lookup(self, oid: int) -> Optional[str]:
        """Return ``'main'`` / ``'tail'`` on hit (after promoting the entry to
        main-MRU) or ``None`` on miss.  A ``'tail'`` return is a *tail hit*."""
        if oid in self._main:
            self._main.move_to_end(oid)
            return "main"
        if oid in self._tail:
            sz = self._tail.pop(oid)
            self._tail_bytes -= sz
            self._main[oid] = sz
            self._main_bytes += sz
            self._rebalance()
            return "tail"
        return None

    def insert(self, oid: int, nbytes: float) -> List[Tuple[int, float]]:
        """Insert (or refresh) ``oid`` at main-MRU.  Returns evictions.

        Objects larger than the tier capacity are not admitted (returned as
        an immediate self-eviction), mirroring production blob caches.
        """
        if nbytes < 0:
            raise ValueError("object size must be >= 0")
        self.remove(oid)
        if nbytes > self.capacity:
            return [(oid, nbytes)]
        self._main[oid] = nbytes
        self._main_bytes += nbytes
        return self._rebalance()

    def remove(self, oid: int) -> bool:
        if oid in self._main:
            self._main_bytes -= self._main.pop(oid)
            return True
        if oid in self._tail:
            self._tail_bytes -= self._tail.pop(oid)
            return True
        return False

    def resize(self, oid: int, nbytes: float) -> bool:
        """Correct a resident entry's byte charge *in place* — no LRU
        reorder (unlike :meth:`insert`), so accounting fixes (e.g. the
        engine charging a decoded image's real dtype bytes) cannot perturb
        eviction order.  Growth may trigger evictions; returns False when
        the object is not resident."""
        if nbytes < 0:
            raise ValueError("object size must be >= 0")
        for seg, attr in ((self._main, "_main_bytes"),
                          (self._tail, "_tail_bytes")):
            if oid in seg:
                old = seg[oid]
                if nbytes == old:
                    return True
                seg[oid] = nbytes
                setattr(self, attr, getattr(self, attr) + nbytes - old)
                if nbytes > old:
                    self._rebalance()
                return True
        return False

    def set_capacity(self, capacity: float) -> List[Tuple[int, float]]:
        if capacity < 0:
            raise ValueError("capacity must be >= 0")
        self.capacity = float(capacity)
        return self._rebalance()

    def check_invariants(self) -> None:
        assert abs(self._main_bytes - sum(self._main.values())) < 1e-6
        assert abs(self._tail_bytes - sum(self._tail.values())) < 1e-6
        assert self._main_bytes <= self.main_capacity + 1e-6
        assert self._tail_bytes <= self.tail_capacity + 1e-6
        assert not (set(self._main) & set(self._tail))


# ---------------------------------------------------------------------------
# Window statistics (consumed by the tuner, §4.3)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WindowStats:
    """Counters accumulated over one tuning window of W requests."""

    total_requests: int = 0
    image_hits: int = 0
    image_misses: int = 0          # requests not found in the image tier
    latent_hits: int = 0           # of which found in the latent tier
    full_misses: int = 0           # absent from both tiers
    image_tail_hits: int = 0
    latent_tail_hits: int = 0
    promotions: int = 0

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)

    # Ratios per the paper's Eq. (measured under the current partition).
    def mr_img(self) -> float:
        return self.image_misses / self.total_requests if self.total_requests else 0.0

    def delta_img(self) -> float:
        return self.image_tail_hits / self.total_requests if self.total_requests else 0.0

    def mr_lat(self) -> float:
        return self.full_misses / self.image_misses if self.image_misses else 0.0

    def delta_lat(self) -> float:
        return self.latent_tail_hits / self.image_misses if self.image_misses else 0.0


@dataclasses.dataclass(frozen=True)
class LookupResult:
    outcome: str                   # 'image_hit' | 'latent_hit' | 'full_miss'
    tail_hit: bool = False         # served from the tail segment
    promoted: bool = False         # latent->image promotion happened


IMAGE_HIT = "image_hit"
LATENT_HIT = "latent_hit"
FULL_MISS = "full_miss"


# ---------------------------------------------------------------------------
# Dual-format cache
# ---------------------------------------------------------------------------


class DualFormatCache:
    """Paper §4.2: image tier + latent tier under one capacity ``C``.

    ``image_size_fn`` / ``latent_size_fn`` map an object id to its byte size
    in each format (constants by default: 1.4 MB PNG vs 0.28 MB latent).
    """

    def __init__(
        self,
        capacity_bytes: float,
        alpha: float = 0.5,
        tau: float = 0.1,
        promote_threshold: int = 8,
        image_size_fn: Optional[Callable[[int], float]] = None,
        latent_size_fn: Optional[Callable[[int], float]] = None,
    ):
        if not (0.0 <= alpha <= 1.0):
            raise ValueError("alpha must be in [0, 1]")
        self.capacity = float(capacity_bytes)
        self.alpha = float(alpha)
        self.h = int(promote_threshold)
        self.image_size_fn = image_size_fn or (lambda oid: 1.4e6)
        self.latent_size_fn = latent_size_fn or (lambda oid: DEFAULT_OBJECT_BYTES)
        self._latent_hits: Dict[int, int] = {}   # promotion counters
        self.image_tier = SegmentedLRU(self.capacity * self.alpha, tau)
        self.latent_tier = SegmentedLRU(
            self.capacity * (1.0 - self.alpha), tau,
            on_evict=lambda oid, _sz: self._latent_hits.pop(oid, None))
        self.stats = WindowStats()
        self.lifetime = WindowStats()

    # -- alpha control (used by the adaptive resizer) ------------------------
    def set_alpha(self, alpha: float) -> None:
        alpha = min(1.0, max(0.0, alpha))
        self.alpha = alpha
        self.image_tier.set_capacity(self.capacity * alpha)
        self.latent_tier.set_capacity(self.capacity * (1.0 - alpha))

    def set_capacity(self, capacity_bytes: float) -> None:
        """External capacity handoff (the autoscaler's cache knob):
        re-split both tiers under the new total while *preserving* the
        current alpha — the marginal-hit tuner keeps sole ownership of
        the split and simply continues from its converged point.
        Shrinking evicts through the normal tail path, so ``on_evict``
        hooks (payload drops, promotion-counter cleanup) fire as usual."""
        if capacity_bytes < 0:
            raise ValueError("capacity must be >= 0")
        self.capacity = float(capacity_bytes)
        self.set_alpha(self.alpha)

    # -- lookup path ----------------------------------------------------------
    def lookup(self, oid: int) -> LookupResult:
        """Cascading lookup: image tier -> latent tier -> full miss.

        On a full miss the caller is expected to fetch the latent from cloud
        storage and call :meth:`admit_latent`.
        """
        for s in (self.stats, self.lifetime):
            s.total_requests += 1

        where = self.image_tier.lookup(oid)
        if where is not None:
            tail = where == "tail"
            for s in (self.stats, self.lifetime):
                s.image_hits += 1
                if tail:
                    s.image_tail_hits += 1
            return LookupResult(IMAGE_HIT, tail_hit=tail)

        for s in (self.stats, self.lifetime):
            s.image_misses += 1

        where = self.latent_tier.lookup(oid)
        if where is not None:
            tail = where == "tail"
            for s in (self.stats, self.lifetime):
                s.latent_hits += 1
                if tail:
                    s.latent_tail_hits += 1
            promoted = self._bump_and_maybe_promote(oid)
            return LookupResult(LATENT_HIT, tail_hit=tail, promoted=promoted)

        for s in (self.stats, self.lifetime):
            s.full_misses += 1
        return LookupResult(FULL_MISS)

    def _bump_and_maybe_promote(self, oid: int) -> bool:
        cnt = self._latent_hits.get(oid, 0) + 1
        # Never promote into a tier that cannot hold the image (alpha ~ 0 /
        # LB-LatentCache): doing so would drop the object from both tiers.
        if cnt >= self.h and self.image_size_fn(oid) <= self.image_tier.capacity:
            # Decode + insert into the image tier, atomically removed from
            # the latent tier (single-residency invariant).
            self.latent_tier.remove(oid)
            self._latent_hits.pop(oid, None)
            evicted = self.image_tier.insert(oid, self.image_size_fn(oid))
            del evicted  # evicted images leave the cache entirely
            for s in (self.stats, self.lifetime):
                s.promotions += 1
            return True
        self._latent_hits[oid] = cnt
        return False

    def admit_latent(self, oid: int,
                     nbytes: Optional[float] = None) -> None:
        """Admit a freshly fetched object into the latent tier (counter =
        0).  ``nbytes`` charges the payload's real byte size; default is
        the configured ``latent_size_fn`` estimate."""
        if oid in self.image_tier:     # raced promotion; keep single residency
            return
        self.latent_tier.insert(
            oid, self.latent_size_fn(oid) if nbytes is None else nbytes)
        if oid in self.latent_tier:    # not admitted if larger than the tier
            self._latent_hits[oid] = 0

    def insert_image(self, oid: int,
                     nbytes: Optional[float] = None) -> None:
        """Force-insert a decoded image (used by spillover write-back).
        ``nbytes`` charges the stored array's real byte size (uint8 on the
        fast path); default is the ``image_size_fn`` estimate."""
        self.latent_tier.remove(oid)
        self._latent_hits.pop(oid, None)
        self.image_tier.insert(
            oid, self.image_size_fn(oid) if nbytes is None else nbytes)

    def set_image_nbytes(self, oid: int, nbytes: float) -> bool:
        """Correct a cached image's byte charge to its real stored size
        without touching LRU order (no-op when not pixel-resident)."""
        return self.image_tier.resize(oid, float(nbytes))

    def evict(self, oid: int) -> bool:
        """Explicitly drop ``oid`` from whichever tier holds it (promotion
        counter included).  Returns True if the object was resident."""
        found = self.image_tier.remove(oid)
        found = self.latent_tier.remove(oid) or found
        self._latent_hits.pop(oid, None)
        return found

    # -- bookkeeping ----------------------------------------------------------
    def contains(self, oid: int) -> Optional[str]:
        if oid in self.image_tier:
            return "image"
        if oid in self.latent_tier:
            return "latent"
        return None

    def end_window(self) -> WindowStats:
        """Snapshot + reset the per-window counters."""
        snap = dataclasses.replace(self.stats)
        self.stats.reset()
        return snap

    def check_invariants(self) -> None:
        self.image_tier.check_invariants()
        self.latent_tier.check_invariants()
        assert not (set(self.image_tier) & set(self.latent_tier)), "dual residency"
        for oid in self._latent_hits:
            # counters may linger only for latent-resident objects
            if oid not in self.latent_tier:
                raise AssertionError(f"stale promotion counter for {oid}")

    @property
    def resident_bytes(self) -> float:
        return self.image_tier.resident_bytes + self.latent_tier.resident_bytes
