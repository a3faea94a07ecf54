"""Cache replacement policies used by the trace characterization (Fig. 4c)
and by the baseline configurations in the evaluation (§6.1).

All policies expose ``access(oid, size=1.0) -> bool`` (True on hit) so the
MRC benchmark can drive them uniformly.  Sizes default to 1.0 which makes
``capacity`` an object count; byte-based capacities work by passing sizes.
"""

from __future__ import annotations

import heapq
from collections import OrderedDict, deque
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from repro_torch.core.latent_store import DEFAULT_OBJECT_BYTES


class CachePolicy:
    name = "base"

    def access(self, oid: int, size: float = 1.0) -> bool:
        raise NotImplementedError

    def __contains__(self, oid: int) -> bool:
        raise NotImplementedError


class LRUCache(CachePolicy):
    """Plain byte-capacity LRU."""

    name = "lru"

    def __init__(self, capacity: float):
        self.capacity = float(capacity)
        self._entries: "OrderedDict[int, float]" = OrderedDict()
        self._bytes = 0.0

    def __contains__(self, oid: int) -> bool:
        return oid in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def resident_bytes(self) -> float:
        return self._bytes

    def access(self, oid: int, size: float = 1.0) -> bool:
        if oid in self._entries:
            self._entries.move_to_end(oid)
            return True
        self.insert(oid, size)
        return False

    def insert(self, oid: int, size: float = 1.0) -> None:
        if size > self.capacity:
            return
        if oid in self._entries:
            self._bytes -= self._entries.pop(oid)
        self._entries[oid] = size
        self._bytes += size
        while self._bytes > self.capacity:
            _, sz = self._entries.popitem(last=False)
            self._bytes -= sz

    def remove(self, oid: int) -> None:
        if oid in self._entries:
            self._bytes -= self._entries.pop(oid)


class S3FIFOCache(CachePolicy):
    """S3-FIFO (Yang et al., SOSP'23): small FIFO + main FIFO + ghost queue.

    Implemented with object-count segment sizing on the byte capacity:
    ``small`` gets ``small_ratio`` of the capacity, ``main`` the rest, and
    the ghost remembers as many ids as main holds objects (classic setting).
    """

    name = "s3fifo"

    def __init__(self, capacity: float, small_ratio: float = 0.1):
        self.small_cap = capacity * small_ratio
        self.main_cap = capacity * (1.0 - small_ratio)
        self._small: deque = deque()            # (oid, size)
        self._main: deque = deque()
        self._small_bytes = 0.0
        self._main_bytes = 0.0
        self._freq: Dict[int, int] = {}         # 2-bit counter, resident only
        self._where: Dict[int, str] = {}        # 'S' | 'M'
        self._ghost: "OrderedDict[int, None]" = OrderedDict()
        self._ghost_cap = 0                     # tracks len(main)

    def __contains__(self, oid: int) -> bool:
        return oid in self._where

    def __len__(self) -> int:
        return len(self._where)

    def access(self, oid: int, size: float = 1.0) -> bool:
        if oid in self._where:
            self._freq[oid] = min(3, self._freq.get(oid, 0) + 1)
            return True
        # miss
        if oid in self._ghost:
            del self._ghost[oid]
            self._insert_main(oid, size)
        else:
            self._insert_small(oid, size)
        return False

    def _insert_small(self, oid: int, size: float) -> None:
        if size > self.small_cap:
            return
        self._small.append((oid, size))
        self._small_bytes += size
        self._where[oid] = "S"
        self._freq[oid] = 0
        while self._small_bytes > self.small_cap:
            self._evict_small()

    def _insert_main(self, oid: int, size: float) -> None:
        if size > self.main_cap:
            return
        self._main.append((oid, size))
        self._main_bytes += size
        self._where[oid] = "M"
        self._freq[oid] = 0
        while self._main_bytes > self.main_cap:
            self._evict_main()

    def _evict_small(self) -> None:
        while self._small:
            oid, size = self._small.popleft()
            if self._where.get(oid) != "S":
                continue
            self._small_bytes -= size
            if self._freq.get(oid, 0) > 1:
                del self._where[oid]
                del self._freq[oid]
                self._insert_main(oid, size)
            else:
                del self._where[oid]
                del self._freq[oid]
                self._ghost[oid] = None
                self._trim_ghost()
            return

    def _evict_main(self) -> None:
        while self._main:
            oid, size = self._main.popleft()
            if self._where.get(oid) != "M":
                continue
            if self._freq.get(oid, 0) > 0:
                self._freq[oid] -= 1
                self._main.append((oid, size))     # second chance
                continue
            self._main_bytes -= size
            del self._where[oid]
            del self._freq[oid]
            return

    def _trim_ghost(self) -> None:
        ghost_cap = max(1, len(self._main))
        while len(self._ghost) > ghost_cap:
            self._ghost.popitem(last=False)


class BeladyCache(CachePolicy):
    """Offline-optimal (Belady/MIN).  Requires the full future: feed the
    request sequence to :meth:`prepare` first, then replay via ``access``
    in the same order."""

    name = "belady"
    _INF = np.iinfo(np.int64).max

    def __init__(self, capacity: float):
        self.capacity = float(capacity)
        self._next_use: Optional[np.ndarray] = None
        self._clock = 0
        self._resident: Dict[int, float] = {}
        self._bytes = 0.0
        self._heap: List = []                    # (-next_use, oid)
        self._cur_next: Dict[int, int] = {}

    def prepare(self, object_ids: Sequence[int]) -> None:
        ids = np.asarray(object_ids, dtype=np.int64)
        n = len(ids)
        next_use = np.full(n, self._INF, dtype=np.int64)
        last_seen: Dict[int, int] = {}
        for i in range(n - 1, -1, -1):
            oid = int(ids[i])
            next_use[i] = last_seen.get(oid, self._INF)
            last_seen[oid] = i
        self._next_use = next_use
        self._clock = 0

    def __contains__(self, oid: int) -> bool:
        return oid in self._resident

    def access(self, oid: int, size: float = 1.0) -> bool:
        if self._next_use is None:
            raise RuntimeError("call prepare() with the full trace first")
        nxt = int(self._next_use[self._clock])
        self._clock += 1
        hit = oid in self._resident
        if hit:
            self._cur_next[oid] = nxt
            heapq.heappush(self._heap, (-nxt, oid))
            return True
        if size > self.capacity:
            return False
        if nxt == self._INF:
            return False                          # never used again: bypass
        self._resident[oid] = size
        self._bytes += size
        self._cur_next[oid] = nxt
        heapq.heappush(self._heap, (-nxt, oid))
        while self._bytes > self.capacity:
            self._evict_farthest()
        return False

    def _evict_farthest(self) -> None:
        while self._heap:
            neg_nxt, oid = heapq.heappop(self._heap)
            if oid in self._resident and self._cur_next.get(oid) == -neg_nxt:
                self._bytes -= self._resident.pop(oid)
                del self._cur_next[oid]
                return
        raise RuntimeError("belady heap exhausted while over capacity")


class MixedFormatLRU(CachePolicy):
    """The rejected §4.2 strawman: one LRU order over BOTH formats.

    Objects enter as latents; after ``h`` hits the entry is re-inserted at
    image size.  The composition of formats at any capacity cut-off is
    uncontrolled — kept as an ablation baseline (benchmarks/bench_cache_sweep).
    """

    name = "mixed_lru"

    def __init__(self, capacity: float, image_size: float = 1.4e6,
                 latent_size: float = DEFAULT_OBJECT_BYTES, promote_threshold: int = 8):
        self.lru = LRUCache(capacity)
        self.image_size = image_size
        self.latent_size = latent_size
        self.h = promote_threshold
        self._format: Dict[int, str] = {}
        self._hits: Dict[int, int] = {}

    def __contains__(self, oid: int) -> bool:
        return oid in self.lru

    def access(self, oid: int, size: float = 1.0) -> bool:
        hit = oid in self.lru
        if hit:
            self.lru.access(oid)
            if self._format.get(oid) == "latent":
                cnt = self._hits.get(oid, 0) + 1
                if cnt >= self.h:
                    self.lru.insert(oid, self.image_size)
                    self._format[oid] = "image"
                    self._hits.pop(oid, None)
                else:
                    self._hits[oid] = cnt
        else:
            self.lru.insert(oid, self.latent_size)
            self._format[oid] = "latent"
            self._hits[oid] = 0
        self._gc()
        return hit

    def format_of(self, oid: int) -> Optional[str]:
        return self._format.get(oid) if oid in self.lru else None

    def _gc(self) -> None:
        if len(self._format) > 2 * len(self.lru) + 64:
            live = set(iter(self.lru._entries))
            self._format = {k: v for k, v in self._format.items() if k in live}
            self._hits = {k: v for k, v in self._hits.items() if k in live}


def miss_ratio(policy: CachePolicy, object_ids: Iterable[int],
               sizes: Optional[Sequence[float]] = None) -> float:
    """Replay a request stream through a policy; return the miss ratio."""
    misses = 0
    total = 0
    if isinstance(policy, BeladyCache):
        ids = list(object_ids)
        policy.prepare(ids)
        object_ids = ids
    if sizes is None:
        for oid in object_ids:
            total += 1
            if not policy.access(int(oid)):
                misses += 1
    else:
        for oid, sz in zip(object_ids, sizes):
            total += 1
            if not policy.access(int(oid), float(sz)):
                misses += 1
    return misses / total if total else 0.0
