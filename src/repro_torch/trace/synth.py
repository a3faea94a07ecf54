"""Synthetic CompanyX-like access trace (paper §3.1).

The paper's 35-month / 2.07 B-request production trace is proprietary; this
module generates a statistically matched stand-in reproducing the four
observations that drive LatentBox's design:

  O1  Zipf-like popularity (alpha ~ 1.11): top 1% of images ~ 39% of views,
      top 10% ~ 71%, most images nearly never re-accessed.
  O2  rapid post-birth decay: per-image access rate drops >100x within a
      year for every popularity tier (hot is a phase, not a property).
  O3  a persistent miss residual at practical cache sizes.
  O4  heavy-tailed re-access intervals: ~38% within an hour, ~68% within a
      day, a long tail beyond 30 days.

Construction: objects are born over the trace window with slowly growing
intensity; each object gets a Zipf lifetime weight and its accesses are
placed at post-birth ages drawn from a truncated Lomax (power-law) decay.
Everything is vectorized numpy; ~5 M requests generate in a few seconds.

Beyond the stationary baseline, :func:`make_trace` exposes a suite of
named scenarios (diurnal load cycle, flash-crowd spike, Zipf-popularity
drift, sequential scan, multi-tenant mix) that stress the cache/tuner in
ways a single Zipf stream cannot — see :data:`SCENARIOS`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

DAY_S = 86_400.0
HOUR_S = 3_600.0


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    n_objects: int = 200_000
    n_requests: int = 4_000_000
    span_days: float = 90.0
    zipf_alpha: float = 1.11        # view-count ~ rank^{-alpha}
    decay_a0_days: float = 1.0      # Lomax scale (post-birth half-life knob)
    decay_beta: float = 1.8         # Lomax shape (>1; larger = faster decay)
    birth_growth: float = 1.0       # births/day grows by this factor over span
    burst_frac: float = 0.35        # fraction of re-accesses in a short burst
    burst_scale_s: float = 40 * 60  # mean burst re-access interval (40 min)
    n_models: int = 1500            # distinct generator models (Table 1 style)
    seed: int = 0


@dataclasses.dataclass
class SyntheticTrace:
    """``timestamps`` seconds from trace start (sorted), parallel arrays.

    Timestamps are *open-loop* arrival times: every scenario places its
    requests by an arrival process (Poisson given the request count for
    the stochastic scenarios, evenly spaced for the deterministic scan),
    independent of how fast the store serves them — which is what lets
    the serving runtime measure queueing delay at all.  ``slo_class``
    (when present) carries a per-object SLO class: 0 = ``interactive``,
    1 = ``batch``; the ``multi_tenant`` scenario fills it per tenant.
    """

    timestamps: np.ndarray          # float64 [R]
    object_ids: np.ndarray          # int64   [R]
    birth_time: np.ndarray          # float64 [N] per-object birth
    model_ids: np.ndarray           # int32   [N] per-object generator model
    config: TraceConfig
    slo_class: Optional[np.ndarray] = None   # int8 [N], 0=interactive 1=batch

    @property
    def n_requests(self) -> int:
        return len(self.timestamps)

    @property
    def n_objects(self) -> int:
        return len(self.birth_time)

    def save(self, path: str) -> None:
        extra = {}
        if self.slo_class is not None:
            extra["slo_class"] = self.slo_class
        np.savez_compressed(
            path, timestamps=self.timestamps, object_ids=self.object_ids,
            birth_time=self.birth_time, model_ids=self.model_ids,
            config=np.array([repr(dataclasses.asdict(self.config))]), **extra)

    @staticmethod
    def load(path: str) -> "SyntheticTrace":
        z = np.load(path, allow_pickle=False)
        cfg = TraceConfig(**eval(str(z["config"][0])))  # trusted local artifact
        return SyntheticTrace(z["timestamps"], z["object_ids"],
                              z["birth_time"], z["model_ids"], cfg,
                              slo_class=(z["slo_class"]
                                         if "slo_class" in z.files else None))

    # -- derived views --------------------------------------------------------
    def window(self, t0_s: float, t1_s: float) -> "SyntheticTrace":
        lo, hi = np.searchsorted(self.timestamps, [t0_s, t1_s])
        return SyntheticTrace(self.timestamps[lo:hi], self.object_ids[lo:hi],
                              self.birth_time, self.model_ids, self.config,
                              slo_class=self.slo_class)

    def downsample_objects(self, n_keep: int, seed: int = 0) -> "SyntheticTrace":
        """Paper §6.1: sample object IDs, keep ALL accesses to the sample."""
        rng = np.random.default_rng(seed)
        uniq = np.unique(self.object_ids)
        keep = rng.choice(uniq, size=min(n_keep, len(uniq)), replace=False)
        mask = np.isin(self.object_ids, keep)
        return SyntheticTrace(self.timestamps[mask], self.object_ids[mask],
                              self.birth_time, self.model_ids, self.config,
                              slo_class=self.slo_class)

    def characterize(self) -> Dict[str, float]:
        """Observed O1/O4 statistics (compare against the paper's numbers)."""
        ids = self.object_ids
        counts = np.bincount(ids, minlength=self.n_objects)
        viewed = counts[counts > 0]
        order = np.sort(viewed)[::-1]
        csum = np.cumsum(order)
        total = csum[-1]
        n = len(order)
        top1 = csum[max(1, n // 100) - 1] / total
        top10 = csum[max(1, n // 10) - 1] / total
        lt10 = float(np.mean(viewed < 10))
        once = float(np.mean(viewed == 1))
        # re-access intervals
        ts_sorted_by_obj = np.lexsort((self.timestamps, ids))
        t = self.timestamps[ts_sorted_by_obj]
        o = ids[ts_sorted_by_obj]
        same = o[1:] == o[:-1]
        gaps = (t[1:] - t[:-1])[same]
        stats = {
            "top1_share": float(top1),
            "top10_share": float(top10),
            "frac_lt10_views": lt10,
            "frac_once": once,
            "reaccess_1h": float(np.mean(gaps <= HOUR_S)) if len(gaps) else 0.0,
            "reaccess_1d": float(np.mean(gaps <= DAY_S)) if len(gaps) else 0.0,
            "reaccess_gt30d": float(np.mean(gaps > 30 * DAY_S)) if len(gaps) else 0.0,
            "n_requests": float(self.n_requests),
            "n_viewed_objects": float(n),
        }
        return stats


def _zipf_weights(n: int, alpha: float, rng: np.random.Generator) -> np.ndarray:
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = ranks ** (-alpha)
    rng.shuffle(w)                       # rank order decoupled from object id
    return w / w.sum()


def _sample_births(n: int, span_s: float, growth: float,
                   rng: np.random.Generator) -> np.ndarray:
    """Birth intensity grows linearly by ``growth`` over the span; sample via
    inverse CDF of f(t) ∝ 1 + growth*t/span."""
    u = rng.random(n)
    if growth <= 1e-9:
        return u * span_s
    g = growth
    # CDF(t) = (t + g t^2 / (2 span)) / (span (1 + g/2)); solve quadratic.
    a = g / (2.0 * span_s)
    c = -u * span_s * (1.0 + g / 2.0)
    t = (-1.0 + np.sqrt(1.0 - 4.0 * a * c)) / (2.0 * a)
    return np.clip(t, 0.0, span_s)


def _sample_lomax_trunc(a0_s: float, beta: float, max_age_s: np.ndarray,
                        rng: np.random.Generator) -> np.ndarray:
    """Ages from density ∝ (1 + a/a0)^(-beta) truncated to [0, max_age]."""
    # CDF(a) = 1 - (1 + a/a0)^(1-beta)  (beta > 1)
    fmax = 1.0 - (1.0 + np.maximum(max_age_s, 0.0) / a0_s) ** (1.0 - beta)
    u = rng.random(len(max_age_s)) * fmax
    a = a0_s * ((1.0 - u) ** (1.0 / (1.0 - beta)) - 1.0)
    return np.clip(a, 0.0, max_age_s)


def _finalize(timestamps: np.ndarray, object_ids: np.ndarray,
              n_objects: int, model_ids: Optional[np.ndarray],
              birth_time: Optional[np.ndarray],
              cfg: TraceConfig,
              slo_class: Optional[np.ndarray] = None) -> SyntheticTrace:
    """Sort a (timestamps, ids) pair into a SyntheticTrace, filling the
    per-object arrays scenarios don't model (births at t=0, one model)."""
    order = np.argsort(timestamps, kind="stable")
    if birth_time is None:
        birth_time = np.zeros(n_objects, dtype=np.float64)
    if model_ids is None:
        model_ids = np.zeros(n_objects, dtype=np.int32)
    return SyntheticTrace(np.asarray(timestamps, np.float64)[order],
                          np.asarray(object_ids, np.int64)[order],
                          birth_time, model_ids, cfg, slo_class=slo_class)


def _zipf_choice(n_objects: int, n_requests: int, alpha: float,
                 rng: np.random.Generator,
                 weights: Optional[np.ndarray] = None) -> np.ndarray:
    w = _zipf_weights(n_objects, alpha, rng) if weights is None else weights
    return rng.choice(n_objects, size=n_requests, p=w).astype(np.int64)


# ---------------------------------------------------------------------------
# named scenarios — the workload suite beyond the stationary CompanyX trace
# ---------------------------------------------------------------------------

def _scenario_companyx(cfg: TraceConfig, rng: np.random.Generator,
                       **_kw) -> SyntheticTrace:
    """The paper-calibrated stationary baseline (O1-O4)."""
    return generate_trace(cfg)


def _scenario_diurnal(cfg: TraceConfig, rng: np.random.Generator,
                      amplitude: float = 0.8, period_days: float = 1.0,
                      **_kw) -> SyntheticTrace:
    """Daily load cycle: arrival intensity lambda(t) = 1 + A sin(2 pi t/P)
    over Zipf-popular objects.  Sampled by inverting the cumulative
    intensity on a dense grid (exact up to grid resolution)."""
    span_s = cfg.span_days * DAY_S
    period_s = period_days * DAY_S
    a = float(np.clip(amplitude, 0.0, 1.0))
    grid = np.linspace(0.0, span_s, 8192)
    cum = grid + a * (period_s / (2 * np.pi)) * (
        1.0 - np.cos(2 * np.pi * grid / period_s))
    u = np.sort(rng.random(cfg.n_requests)) * cum[-1]
    ts = np.interp(u, cum, grid)
    ids = _zipf_choice(cfg.n_objects, cfg.n_requests, cfg.zipf_alpha, rng)
    return _finalize(ts, ids, cfg.n_objects, None, None, cfg)


def _scenario_flash_crowd(cfg: TraceConfig, rng: np.random.Generator,
                          spike_start_frac: float = 0.5,
                          spike_dur_frac: float = 0.05,
                          spike_frac: float = 0.3,
                          n_viral: int = 8, **_kw) -> SyntheticTrace:
    """Steady Zipf background plus a short spike in which ``spike_frac`` of
    all requests hammer ``n_viral`` previously-cold objects (a post going
    viral).  The viral objects are born at the spike start."""
    if cfg.n_objects < 2:
        raise ValueError("flash_crowd needs >= 2 objects (a viral set and "
                         "a background population)")
    span_s = cfg.span_days * DAY_S
    n_spike = int(cfg.n_requests * spike_frac)
    n_base = cfg.n_requests - n_spike
    n_viral = min(n_viral, cfg.n_objects - 1)   # keep background mass > 0
    # background avoids the viral ids so they are genuinely cold pre-spike
    w = _zipf_weights(cfg.n_objects, cfg.zipf_alpha, rng)
    viral = np.arange(cfg.n_objects - n_viral, cfg.n_objects, dtype=np.int64)
    w[viral] = 0.0
    w /= w.sum()
    base_ids = _zipf_choice(cfg.n_objects, n_base, cfg.zipf_alpha, rng,
                            weights=w)
    base_ts = rng.random(n_base) * span_s
    t0 = spike_start_frac * span_s
    dur = max(spike_dur_frac * span_s, 1.0)
    spike_ids = viral[rng.integers(0, n_viral, size=n_spike)]
    spike_ts = t0 + rng.random(n_spike) * dur
    ts = np.concatenate([base_ts, spike_ts])
    ids = np.concatenate([base_ids, spike_ids])
    births = np.zeros(cfg.n_objects)
    births[viral] = t0
    return _finalize(ts, ids, cfg.n_objects, None, births, cfg)


def _scenario_zipf_drift(cfg: TraceConfig, rng: np.random.Generator,
                         n_phases: int = 2, **_kw) -> SyntheticTrace:
    """Popularity drift: the span splits into ``n_phases`` equal phases and
    the Zipf rank order flips between consecutive phases (phase 1's hottest
    objects become phase 2's coldest).  The marginal-hit tuner must
    re-converge after each flip — ``tests/test_tuner.py`` locks that in."""
    span_s = cfg.span_days * DAY_S
    ranks = np.arange(1, cfg.n_objects + 1, dtype=np.float64)
    w = ranks ** (-cfg.zipf_alpha)
    perm = rng.permutation(cfg.n_objects)       # id -> rank decoupling
    per_phase = np.array_split(np.arange(cfg.n_requests), n_phases)
    ts_parts, id_parts = [], []
    for p, idx in enumerate(per_phase):
        wp = w if p % 2 == 0 else w[::-1]       # the popularity flip
        weights = np.empty(cfg.n_objects)
        weights[perm] = wp / wp.sum()
        id_parts.append(_zipf_choice(cfg.n_objects, len(idx),
                                     cfg.zipf_alpha, rng, weights=weights))
        lo, hi = p / n_phases, (p + 1) / n_phases
        ts_parts.append((lo + rng.random(len(idx)) * (hi - lo)) * span_s)
    return _finalize(np.concatenate(ts_parts), np.concatenate(id_parts),
                     cfg.n_objects, None, None, cfg)


def _scenario_scan(cfg: TraceConfig, rng: np.random.Generator,
                   passes: Optional[int] = None,
                   poisson: bool = False, **_kw) -> SyntheticTrace:
    """Sequential sweep over the whole object space (batch re-encode /
    integrity audit): the cache-adversarial workload — every request is
    maximally far from its previous access.  Default: exactly
    ``n_requests`` requests (the last pass may be partial); with an
    explicit ``passes`` the trace is exactly ``passes * n_objects``.

    Arrivals are evenly spaced (a scan is a paced batch job, and the
    default trace must stay seed-independent); ``poisson=True`` swaps in
    Poisson arrival times at the same mean rate while keeping the
    sequential id order, for open-loop runtime studies."""
    if passes is None:
        n_total = cfg.n_requests
    else:
        n_total = int(passes) * cfg.n_objects
    n_passes = -(-n_total // cfg.n_objects)          # ceil
    ids = np.tile(np.arange(cfg.n_objects, dtype=np.int64),
                  n_passes)[:n_total]
    if poisson:
        # order statistics of U(0, span) = Poisson arrivals given the count
        ts = np.sort(rng.random(len(ids))) * cfg.span_days * DAY_S
    else:
        ts = np.linspace(0.0, cfg.span_days * DAY_S, len(ids), endpoint=False)
    return _finalize(ts, ids, cfg.n_objects, None, None, cfg)


def _scenario_multi_tenant(cfg: TraceConfig, rng: np.random.Generator,
                           n_tenants: int = 4,
                           tenant_alphas: Optional[Sequence[float]] = None,
                           tenant_share_alpha: float = 1.0,
                           tenant_slos: Optional[Sequence[str]] = None,
                           **_kw) -> SyntheticTrace:
    """T tenants with disjoint object pools: tenant traffic shares follow a
    Zipf over tenants, and each tenant has its own per-pool skew (some
    tenants serve one viral asset, others a flat archive).  ``model_ids``
    carries the owning tenant of every object, and ``slo_class`` the
    tenant's SLO class (``tenant_slos``, one of ``interactive``/``batch``
    per tenant; default alternates, starting interactive) — together the
    keys the serving runtime's QoS and admission layers act on."""
    n_tenants = max(1, min(n_tenants, cfg.n_objects))
    if tenant_alphas is None:
        # spread skews from heavy (first tenant) to near-uniform (last)
        tenant_alphas = np.linspace(cfg.zipf_alpha + 0.3, 0.2, n_tenants)
    if tenant_slos is None:
        tenant_slos = ["interactive" if t % 2 == 0 else "batch"
                       for t in range(n_tenants)]
    if len(tenant_slos) != n_tenants or \
            any(s not in ("interactive", "batch") for s in tenant_slos):
        raise ValueError("tenant_slos needs one 'interactive'/'batch' entry "
                         f"per tenant ({n_tenants}): {tenant_slos!r}")
    pools = np.array_split(np.arange(cfg.n_objects, dtype=np.int64),
                           n_tenants)
    shares = np.arange(1, n_tenants + 1, dtype=np.float64) \
        ** (-tenant_share_alpha)
    shares /= shares.sum()
    tenant_of_req = rng.choice(n_tenants, size=cfg.n_requests, p=shares)
    ids = np.empty(cfg.n_requests, dtype=np.int64)
    for t in range(n_tenants):
        mask = tenant_of_req == t
        pool = pools[t]
        local = _zipf_choice(len(pool), int(mask.sum()),
                             float(tenant_alphas[t]), rng)
        ids[mask] = pool[local]
    ts = rng.random(cfg.n_requests) * cfg.span_days * DAY_S
    model_ids = np.empty(cfg.n_objects, dtype=np.int32)
    slo_class = np.empty(cfg.n_objects, dtype=np.int8)
    for t, pool in enumerate(pools):
        model_ids[pool] = t
        slo_class[pool] = 0 if tenant_slos[t] == "interactive" else 1
    return _finalize(ts, ids, cfg.n_objects, model_ids, None, cfg,
                     slo_class=slo_class)


#: Named workloads of the scenario suite.  Every generator takes
#: ``(TraceConfig, rng, **knobs)`` and returns a :class:`SyntheticTrace`;
#: ``make_trace`` is the one public entry point.
SCENARIOS = {
    "companyx": _scenario_companyx,
    "diurnal": _scenario_diurnal,
    "flash_crowd": _scenario_flash_crowd,
    "zipf_drift": _scenario_zipf_drift,
    "scan": _scenario_scan,
    "multi_tenant": _scenario_multi_tenant,
}


def list_scenarios() -> List[str]:
    return sorted(SCENARIOS)


def make_trace(scenario: str = "companyx",
               config: Optional[TraceConfig] = None,
               n_objects: Optional[int] = None,
               n_requests: Optional[int] = None,
               span_days: Optional[float] = None,
               seed: Optional[int] = None,
               load_factor: float = 1.0,
               **knobs) -> SyntheticTrace:
    """Generate a named workload: ``make_trace("flash_crowd", n_objects=...)``.

    The common size knobs override ``config`` fields; scenario-specific
    knobs (``amplitude``, ``spike_frac``, ``n_phases``, ``passes``,
    ``n_tenants``, ``tenant_slos``, ...) pass through to the generator.
    ``load_factor`` scales the open-loop arrival *rate* of any scenario:
    timestamps divide by it (2.0 = the same requests arrive twice as
    fast), which is how the runtime benchmarks sweep a scenario from
    underload into overload without changing its access pattern.
    Consumed by ``core/replay.py``, ``core/cluster.py``,
    ``benchmarks/bench_trace.py`` and the conformance harnesses.
    """
    if scenario not in SCENARIOS:
        raise KeyError(f"unknown scenario {scenario!r}; "
                       f"pick one of {list_scenarios()}")
    if load_factor <= 0:
        raise ValueError(f"load_factor must be > 0: {load_factor!r}")
    cfg = config or TraceConfig()
    overrides = {k: v for k, v in (("n_objects", n_objects),
                                   ("n_requests", n_requests),
                                   ("span_days", span_days),
                                   ("seed", seed)) if v is not None}
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    rng = np.random.default_rng(cfg.seed)
    trace = SCENARIOS[scenario](cfg, rng, **knobs)
    if load_factor != 1.0:
        trace = dataclasses.replace(
            trace, timestamps=trace.timestamps / float(load_factor))
    return trace


def generate_trace(config: Optional[TraceConfig] = None) -> SyntheticTrace:
    cfg = config or TraceConfig()
    rng = np.random.default_rng(cfg.seed)
    span_s = cfg.span_days * DAY_S

    births = _sample_births(cfg.n_objects, span_s, cfg.birth_growth, rng)
    weights = _zipf_weights(cfg.n_objects, cfg.zipf_alpha, rng)

    # Discount each object's weight by its remaining lifetime mass so that
    # late-born objects don't get impossible request budgets.
    frac_life = 1.0 - (1.0 + (span_s - births) / (cfg.decay_a0_days * DAY_S)) ** (
        1.0 - cfg.decay_beta)
    eff = weights * frac_life
    lam = cfg.n_requests * eff / eff.sum()
    counts = rng.poisson(lam)

    total = int(counts.sum())
    oid = np.repeat(np.arange(cfg.n_objects, dtype=np.int64), counts)
    birth_of = np.repeat(births, counts)
    max_age = span_s - birth_of
    ages = _sample_lomax_trunc(cfg.decay_a0_days * DAY_S, cfg.decay_beta,
                               max_age, rng)

    ts = birth_of + ages

    # O4's short-interval mass: a fraction of each object's re-accesses are
    # bursty follow-ups to the previous access rather than independent draws
    # from the decay profile.  Implement by snapping a random subset of
    # accesses to (previous access of same object) + Exp(burst_scale).
    order = np.lexsort((ts, oid))
    ts_o = ts[order]
    oid_o = oid[order]
    same_prev = np.zeros(total, dtype=bool)
    same_prev[1:] = oid_o[1:] == oid_o[:-1]
    burst = same_prev & (rng.random(total) < cfg.burst_frac)
    # Sequential dependency (burst chains) — resolve with a forward pass on
    # the object-sorted arrays; numpy-friendly since chains share the base.
    delta = rng.exponential(cfg.burst_scale_s, size=total)
    ts_new = ts_o.copy()
    idx = np.nonzero(burst)[0]
    ts_new[idx] = ts_o[idx - 1] + delta[idx]
    ts_new = np.minimum(ts_new, span_s)

    final_order = np.argsort(ts_new, kind="stable")
    timestamps = ts_new[final_order]
    object_ids = oid_o[final_order]

    model_ids = rng.integers(0, cfg.n_models, size=cfg.n_objects).astype(np.int32)
    return SyntheticTrace(timestamps, object_ids, births, model_ids, cfg)
