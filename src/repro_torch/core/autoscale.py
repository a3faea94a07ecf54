"""Cost-model-driven elastic autoscaling (closes the ROADMAP's open item).

The paper's §6.4 economics (Eq. 3-4) price LatentBox as a trade between
persistent storage and on-demand GPU decode — but a *live* cluster must
make that trade continuously: "given this diurnal load, how many decode
GPUs and how much cache?".  :class:`AutoscaleController` is the answer as
a control loop.  Every control window it consumes a
:class:`WindowObs` — arrival volume, decode-GPU occupancy, hit-class mix,
and the plant's queue-delay tail — and picks the **cheapest feasible**
plant among one-step moves along three knobs:

  * decode-GPU count per node   (``GpuQueue.resize`` on the simulator,
                                 virtual fleet width on the engine)
  * total cache bytes per node  (``TierWalk.set_cache_capacity`` — the
                                 capacity *handoff* API: the controller
                                 owns the total, the
                                 :class:`~repro.core.tuner.MarginalHitTuner`
                                 keeps sole ownership of the alpha split)
  * shard count                 (``ShardedLatentBox.add_shard`` /
                                 ``remove_shard``, riding the existing
                                 segment-shipping migration)

Feasibility is an SLO rule: a candidate is feasible when its *predicted*
decode utilization (the window's measured busy-ms divided by the
candidate's capacity-ms) stays under the scale-up band and the observed
queue-delay p99 respects ``queue_slo_ms``.  Cost ranks candidates via
:class:`~repro.core.cost_model.CostParams` prices — GPUs at $/hr, cache
and durable bytes at the S3 $/GB-month rate — so a cache step is chosen
over a GPU step exactly when it is cheaper *and* predicted to absorb the
demand.

Stability machinery (all enforced here, property-tested in
``tests/test_autoscale.py``):

  * **hysteresis bands** — scale up above ``util_high``, down below
    ``util_low``, and a scale-down must keep predicted utilization under
    the band *midpoint* so it cannot immediately re-trigger a scale-up;
  * **cooldown windows** — after any action the controller holds for
    ``cooldown_windows`` control windows;
  * **scale-down safety** — never below ``min_gpus_per_node`` /
    ``min_cache_frac`` / the replication factor R (the sharded wrapper
    pins ``min_shards`` to R), and the ``shard_guard`` hook refuses a
    shard removal while any shard is dead or a reshard is in flight.

This module is ``core``-only (no ``repro.store`` imports): the backends
own the actuation, the controller owns the policy, and the whole feature
is off unless ``StoreConfig.autoscale=True`` — a disabled box constructs
no controller at all, so the default path is provably untouched.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

from repro_torch.core.cost_model import CostParams

HOURS_PER_MONTH = 730.0

#: Actions the controller can take (event ``action`` values).
SCALE_UP_ACTIONS = ("gpu_up", "cache_up", "shard_up")
SCALE_DOWN_ACTIONS = ("gpu_down", "cache_down", "shard_down")


@dataclasses.dataclass
class AutoscaleConfig:
    """Control-loop knobs.  Defaults are deliberately conservative: wide
    hysteresis, a cooldown after every action, single-step moves."""

    window: int = 64              #: requests per control window
    cooldown_windows: int = 2     #: hold-off windows after any action
    util_high: float = 0.80       #: scale-up band (predicted decode util)
    util_low: float = 0.30        #: scale-down band
    queue_slo_ms: float = 250.0   #: queue-delay p99 feasibility bound
    # -- knob bounds ---------------------------------------------------------
    min_gpus_per_node: int = 1
    max_gpus_per_node: int = 8
    #: Cache bounds as fractions of the *configured* bytes-per-node, so one
    #: config serves differently sized plants.
    min_cache_frac: float = 0.25
    max_cache_frac: float = 4.0
    cache_step: float = 2.0       #: grow/shrink multiplier per cache action
    min_shards: int = 1
    max_shards: int = 16
    # -- knob enablement (the sharded wrapper owns only the shard knob) ------
    gpu_knob: bool = True
    cache_knob: bool = True
    shard_knob: bool = False
    #: Modeled fraction of decode demand one cache step absorbs (scaled by
    #: the window's decode fraction).  Conservative by design: the real
    #: gain is workload-dependent and the marginal-hit tuner, not this
    #: constant, owns the split once the bytes exist.
    cache_gain: float = 0.25
    # -- prices --------------------------------------------------------------
    params: CostParams = dataclasses.field(default_factory=CostParams)
    #: Decode-GPU $/hr; ``None`` uses ``params.p_gpu_hr_h100``.
    gpu_price_hr: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class PlantState:
    """One point in the configuration space the controller moves through."""

    gpus_per_node: int
    n_nodes: int
    cache_bytes_per_node: float
    n_shards: int = 1

    @property
    def total_gpus(self) -> int:
        return self.n_shards * self.n_nodes * self.gpus_per_node

    @property
    def total_cache_bytes(self) -> float:
        return self.n_shards * self.n_nodes * self.cache_bytes_per_node


@dataclasses.dataclass(frozen=True)
class WindowObs:
    """One control window's feedback, as both backends can produce it."""

    requests: int                 #: requests served this window
    span_ms: float                #: window span (sim clock / wall clock)
    busy_ms: float                #: summed decode-GPU occupancy
    decode_frac: float = 1.0      #: fraction of requests that decoded
    queue_p99_ms: float = 0.0     #: queue-delay p99 over the window


@dataclasses.dataclass(frozen=True)
class ScaleEvent:
    """One applied decision (kept for trajectories and benchmarks)."""

    window_index: int
    action: str
    reason: str
    util: float
    queue_p99_ms: float
    state: PlantState             #: plant AFTER the action
    cost_per_hr: float            #: of the new plant


class AutoscaleController:
    """Picks the cheapest SLO-feasible plant, one step per control window.

    The controller is pure policy: it never touches a cache or a GPU
    queue itself.  The owning backend calls :meth:`step` with a complete
    window's observations; a returned :class:`ScaleEvent` carries the new
    :class:`PlantState` for the backend to actuate (resize GPU queues,
    hand new capacity to the tier walk, add/remove a shard).
    """

    def __init__(self, state: PlantState,
                 config: Optional[AutoscaleConfig] = None, *,
                 shard_guard: Optional[Callable[[], bool]] = None):
        self.cfg = config or AutoscaleConfig()
        self.state = state
        self._base_cache = float(state.cache_bytes_per_node)
        self._shard_guard = shard_guard
        self.events: List[ScaleEvent] = []
        self.scale_ups = 0
        self.scale_downs = 0
        self._cooldown = 0
        self._window_index = 0

    # -- §6.4 pricing ---------------------------------------------------------
    @property
    def gpu_price_hr(self) -> float:
        if self.cfg.gpu_price_hr is not None:
            return float(self.cfg.gpu_price_hr)
        return float(self.cfg.params.p_gpu_hr_h100)

    def cost_per_hr(self, s: PlantState) -> float:
        """Provisioned $/hr of a plant: decode GPUs at the configured
        $/hr plus cache DRAM priced at the storage $/GB-month rate (the
        same convention Eq. 4 uses for the pixel-cache term)."""
        p = self.cfg.params
        gpu = s.total_gpus * self.gpu_price_hr
        cache = (s.total_cache_bytes / 1e9) * p.p_s3_gb_mo / HOURS_PER_MONTH
        return gpu + cache

    # -- feasibility ----------------------------------------------------------
    @staticmethod
    def utilization(obs: WindowObs, s: PlantState) -> float:
        if obs.span_ms <= 0.0 or s.total_gpus <= 0:
            return 0.0
        return obs.busy_ms / (obs.span_ms * s.total_gpus)

    def _predicted_util(self, obs: WindowObs, cand: PlantState) -> float:
        """Predicted utilization at a candidate: the window's measured
        decode demand spread over the candidate's capacity; cache moves
        model a ``cache_gain`` demand change instead."""
        cur = self.state
        util = self.utilization(obs, cand)
        gain = self.cfg.cache_gain * max(0.0, min(1.0, obs.decode_frac))
        if cand.cache_bytes_per_node > cur.cache_bytes_per_node:
            util *= (1.0 - gain)
        elif cand.cache_bytes_per_node < cur.cache_bytes_per_node:
            util *= (1.0 + gain)
        return util

    # -- candidate generation -------------------------------------------------
    def _with(self, **kw) -> PlantState:
        return dataclasses.replace(self.state, **kw)

    def _shard_down_safe(self) -> bool:
        if self.state.n_shards <= max(1, self.cfg.min_shards):
            return False
        return self._shard_guard() if self._shard_guard is not None else True

    def _candidates(self, up: bool) -> List:
        cfg, s = self.cfg, self.state
        out = []
        if up:
            if cfg.gpu_knob and s.gpus_per_node < cfg.max_gpus_per_node:
                out.append(("gpu_up",
                            self._with(gpus_per_node=s.gpus_per_node + 1)))
            if cfg.cache_knob and (s.cache_bytes_per_node * cfg.cache_step
                                   <= self._base_cache * cfg.max_cache_frac):
                out.append(("cache_up", self._with(
                    cache_bytes_per_node=s.cache_bytes_per_node
                    * cfg.cache_step)))
            if cfg.shard_knob and s.n_shards < cfg.max_shards:
                out.append(("shard_up", self._with(n_shards=s.n_shards + 1)))
        else:
            if cfg.gpu_knob and s.gpus_per_node > cfg.min_gpus_per_node:
                out.append(("gpu_down",
                            self._with(gpus_per_node=s.gpus_per_node - 1)))
            if cfg.cache_knob and (s.cache_bytes_per_node / cfg.cache_step
                                   >= self._base_cache * cfg.min_cache_frac):
                out.append(("cache_down", self._with(
                    cache_bytes_per_node=s.cache_bytes_per_node
                    / cfg.cache_step)))
            if cfg.shard_knob and self._shard_down_safe():
                out.append(("shard_down",
                            self._with(n_shards=s.n_shards - 1)))
        return out

    # -- the control step -----------------------------------------------------
    def step(self, obs: WindowObs) -> Optional[ScaleEvent]:
        """One control interval.  Returns the applied :class:`ScaleEvent`
        (``self.state`` already advanced) or ``None`` to hold."""
        self._window_index += 1
        if obs.requests <= 0 or obs.span_ms <= 0.0:
            return None                       # nothing observable: hold
        if self._cooldown > 0:
            self._cooldown -= 1
            return None
        cfg = self.cfg
        util = self.utilization(obs, self.state)
        breach = obs.queue_p99_ms > cfg.queue_slo_ms
        if util > cfg.util_high or breach:
            reason = (f"util {util:.2f} > {cfg.util_high:.2f}" if not breach
                      else f"queue p99 {obs.queue_p99_ms:.0f}ms > SLO "
                           f"{cfg.queue_slo_ms:.0f}ms")
            return self._act(obs, util, reason, up=True)
        if util < cfg.util_low and obs.queue_p99_ms < 0.5 * cfg.queue_slo_ms:
            return self._act(obs, util,
                             f"util {util:.2f} < {cfg.util_low:.2f}",
                             up=False)
        return None

    def _act(self, obs: WindowObs, util: float, reason: str,
             up: bool) -> Optional[ScaleEvent]:
        cfg = self.cfg
        cands = self._candidates(up)
        if not cands:
            return None
        if up:
            # cheapest candidate predicted back inside the band; if none
            # qualifies, the one buying the most headroom (lowest predicted
            # utilization) — partial relief beats holding under overload
            feas = [(a, s) for a, s in cands
                    if self._predicted_util(obs, s) <= cfg.util_high]
            if feas:
                action, new = min(feas, key=lambda c: self.cost_per_hr(c[1]))
            else:
                action, new = min(
                    cands, key=lambda c: self._predicted_util(obs, c[1]))
        else:
            # biggest $/hr saving whose predicted utilization stays under
            # the band MIDPOINT — the hysteresis gap that prevents a
            # shrink from immediately re-triggering a scale-up
            mid = 0.5 * (cfg.util_low + cfg.util_high)
            feas = [(a, s) for a, s in cands
                    if self._predicted_util(obs, s) <= mid]
            if not feas:
                return None
            action, new = min(feas, key=lambda c: self.cost_per_hr(c[1]))
        self.state = new
        self._cooldown = cfg.cooldown_windows
        if up:
            self.scale_ups += 1
        else:
            self.scale_downs += 1
        ev = ScaleEvent(self._window_index, action, reason, util,
                        obs.queue_p99_ms, new, self.cost_per_hr(new))
        self.events.append(ev)
        return ev

    # -- introspection --------------------------------------------------------
    def summary(self) -> dict:
        s = self.state
        return {"scale_up_events": self.scale_ups,
                "scale_down_events": self.scale_downs,
                "autoscale_windows": self._window_index,
                "autoscale_gpus_per_node": s.gpus_per_node,
                "autoscale_cache_bytes_per_node": s.cache_bytes_per_node,
                "autoscale_shards": s.n_shards,
                "autoscale_cost_per_hr": self.cost_per_hr(s)}
