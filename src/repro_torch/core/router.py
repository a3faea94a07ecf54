"""Frontend router (paper §4.4): request coalescing, consistent-hash
dispatch, and queue-depth-triggered spillover with cache pinning.

The router is engine-agnostic: the discrete-event simulator
(:mod:`repro.core.cluster`) and the real pjit decode fleet
(:mod:`repro.vae.serve`) both drive it.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple


def _hash64(key: str) -> int:
    return int.from_bytes(hashlib.blake2b(key.encode(), digest_size=8).digest(),
                          "big")


def parse_node_index(name: str) -> int:
    """Parse a ``node<idx>`` ring/router name into a fleet index — the one
    parse point for the naming convention the engine fleet and the sharded
    cluster's global namespace both rely on."""
    if not name.startswith("node"):
        raise ValueError(f"malformed node name {name!r} (want 'node<idx>')")
    try:
        return int(name[4:])
    except ValueError as e:
        raise ValueError(
            f"malformed node name {name!r} (want 'node<idx>')") from e


class ConsistentHashRing:
    """Classic ring with virtual nodes; stable under node add/remove so the
    serving fleet can scale elastically with minimal cache-ownership churn."""

    def __init__(self, nodes: Sequence[str], vnodes: int = 128):
        self.vnodes = vnodes
        self._ring: List[Tuple[int, str]] = []
        self._keys: List[int] = []
        self._nodes: List[str] = []
        for n in nodes:
            self.add_node(n)

    @property
    def nodes(self) -> List[str]:
        return list(self._nodes)

    def add_node(self, node: str) -> None:
        if node in self._nodes:
            raise ValueError(f"duplicate node {node}")
        self._nodes.append(node)
        for v in range(self.vnodes):
            self._ring.append((_hash64(f"{node}#{v}"), node))
        self._ring.sort()
        self._keys = [h for h, _ in self._ring]

    def remove_node(self, node: str) -> None:
        self._nodes.remove(node)
        self._ring = [(h, n) for h, n in self._ring if n != node]
        self._keys = [h for h, _ in self._ring]

    def owner(self, oid: int) -> str:
        if not self._ring:
            raise RuntimeError("empty ring")
        h = _hash64(f"obj:{oid}")
        i = bisect.bisect_right(self._keys, h) % len(self._ring)
        return self._ring[i][1]

    def successors(self, oid: int):
        """Yield the distinct nodes encountered walking the ring clockwise
        from ``oid``'s position — the first yield is ``owner(oid)``.  Replica
        placement takes the first R distinct *shards* along this walk, so a
        node join/leave only reshuffles the replicas whose successor window
        it enters or exits."""
        if not self._ring:
            raise RuntimeError("empty ring")
        h = _hash64(f"obj:{oid}")
        start = bisect.bisect_right(self._keys, h) % len(self._ring)
        seen = set()
        for step in range(len(self._ring)):
            node = self._ring[(start + step) % len(self._ring)][1]
            if node not in seen:
                seen.add(node)
                yield node


class Router:
    """Coalescing + ownership + spillover decisions.

    Queue depths are *reported back* by nodes (as in the paper: per-GPU
    depths piggy-backed on responses); the router never inspects node
    internals directly.
    """

    def __init__(self, nodes: Sequence[str], theta: int = 4, vnodes: int = 128):
        self.ring = ConsistentHashRing(nodes, vnodes)
        self.theta = theta                       # spillover queue threshold
        self.queue_depth: Dict[str, int] = {n: 0 for n in nodes}
        self.inflight: Dict[int, List[object]] = {}   # oid -> waiter tokens
        # telemetry
        self.n_coalesced = 0
        self.n_spillover = 0
        self.n_dispatched = 0

    # -- coalescing -----------------------------------------------------------
    def try_coalesce(self, oid: int, waiter: object) -> bool:
        """True if an identical decode is in flight; waiter is parked."""
        if oid in self.inflight:
            self.inflight[oid].append(waiter)
            self.n_coalesced += 1
            return True
        return False

    def begin_inflight(self, oid: int) -> None:
        self.inflight.setdefault(oid, [])

    def finish_inflight(self, oid: int) -> List[object]:
        """Returns (and clears) the parked waiters for ``oid``."""
        return self.inflight.pop(oid, [])

    # -- dispatch --------------------------------------------------------------
    def report_depth(self, node: str, depth: int) -> None:
        self.queue_depth[node] = depth

    def least_loaded(self, exclude: Optional[str] = None) -> str:
        candidates = [(d, n) for n, d in self.queue_depth.items() if n != exclude]
        if not candidates:
            return exclude  # single-node cluster: no spillover possible
        return min(candidates)[1]

    def dispatch(self, oid: int, needs_gpu: bool = True) -> Tuple[str, str, bool]:
        """Returns ``(owner_node, exec_node, spilled)``.

        The *owner* is where the cache entry lives (hash-pinned); the *exec*
        node is where the decode runs.  They differ only on spillover, in
        which case the decode result is written back to the owner's cache
        (cache pinning, §4.4)."""
        owner = self.ring.owner(oid)
        self.n_dispatched += 1
        if not needs_gpu:
            return owner, owner, False
        if self.queue_depth.get(owner, 0) > self.theta:
            spill = self.least_loaded(exclude=owner)
            if spill != owner and self.queue_depth.get(spill, 0) < \
                    self.queue_depth.get(owner, 0):
                self.n_spillover += 1
                return owner, spill, True
        return owner, owner, False
