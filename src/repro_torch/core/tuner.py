"""Online marginal-hit tuning of the image/latent split (paper §4.3).

At the end of each window of ``W`` requests the tuner evaluates the scalar
gradient of the expected per-request latency

    E[T](a) = (1 - MR_img)·0
            + MR_img·[(1 - MR_lat)·T_dec + MR_lat·(T_dec + T_fetch)]

whose derivative at the current operating point is estimated from tail-hit
rates (Eq. 2):

    D = -d_img·[T_dec + T_fetch·MR_lat] + T_fetch·MR_img·d_lat

``D < 0``  => the image tier has the higher marginal value => alpha += step.
``D > 0``  => the latent tier has the higher marginal value => alpha -= step.

``T_decode`` / ``T_fetch`` are exponentially weighted moving averages of
observed latencies, closing the negative feedback loop that absorbs GPU
throttling and storage backpressure (paper Fig. 6).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.core.dual_cache import DualFormatCache, WindowStats


class Ewma:
    """Exponentially weighted moving average with a cold-start default."""

    __slots__ = ("value", "beta", "_initialized")

    def __init__(self, default: float, beta: float = 0.05):
        self.value = float(default)
        self.beta = float(beta)
        self._initialized = False

    def update(self, sample: float) -> float:
        if not self._initialized:
            self.value = float(sample)
            self._initialized = True
        else:
            self.value += self.beta * (float(sample) - self.value)
        return self.value


@dataclasses.dataclass
class TunerConfig:
    window: int = 1_000_000       # W — requests per gradient window
    step: float = 0.005           # Delta — per-window alpha step
    t_decode_ms: float = 40.0     # cold-start T_decode
    t_fetch_ms: float = 140.0     # cold-start T_fetch
    ewma_beta: float = 0.05
    alpha_min: float = 0.0
    alpha_max: float = 1.0


@dataclasses.dataclass
class TunerRecord:
    """One window's tuning decision (kept for Fig. 9-style trajectories)."""

    window_index: int
    alpha_before: float
    alpha_after: float
    gradient: float
    mr_img: float
    mr_lat: float
    delta_img: float
    delta_lat: float
    t_decode_ms: float
    t_fetch_ms: float
    expected_latency_ms: float


class MarginalHitTuner:
    """Drives ``DualFormatCache.set_alpha`` from window statistics."""

    def __init__(self, cache: DualFormatCache, config: Optional[TunerConfig] = None):
        self.cache = cache
        self.cfg = config or TunerConfig()
        self.t_decode = Ewma(self.cfg.t_decode_ms, self.cfg.ewma_beta)
        self.t_fetch = Ewma(self.cfg.t_fetch_ms, self.cfg.ewma_beta)
        self.history: List[TunerRecord] = []
        self._since_window = 0
        self._window_index = 0

    # -- latency observations (feed the EWMAs) ------------------------------
    def observe_decode_ms(self, ms: float) -> None:
        self.t_decode.update(ms)

    def observe_fetch_ms(self, ms: float) -> None:
        self.t_fetch.update(ms)

    # -- per-request hook ----------------------------------------------------
    def on_request(self) -> Optional[TunerRecord]:
        """Call once per request *after* the cache lookup; runs the window
        boundary when W requests have accumulated."""
        self._since_window += 1
        if self._since_window < self.cfg.window:
            return None
        self._since_window = 0
        return self.end_window()

    # -- window boundary ------------------------------------------------------
    @staticmethod
    def gradient(stats: WindowStats, t_decode: float, t_fetch: float) -> float:
        """Eq. 2 — sign prescribes the alpha update direction."""
        mr_lat = stats.mr_lat()
        mr_img = stats.mr_img()
        d_img = stats.delta_img()
        d_lat = stats.delta_lat()
        return -d_img * (t_decode + t_fetch * mr_lat) + t_fetch * mr_img * d_lat

    @staticmethod
    def expected_latency_ms(stats: WindowStats, t_decode: float, t_fetch: float) -> float:
        """Eq. 1 at the measured miss ratios (image hit cost treated as 0)."""
        mr_img, mr_lat = stats.mr_img(), stats.mr_lat()
        return mr_img * ((1 - mr_lat) * t_decode + mr_lat * (t_decode + t_fetch))

    def end_window(self) -> TunerRecord:
        stats = self.cache.end_window()
        t_dec, t_fet = self.t_decode.value, self.t_fetch.value
        d = self.gradient(stats, t_dec, t_fet)
        alpha_before = self.cache.alpha
        if d < 0:
            alpha_after = alpha_before + self.cfg.step
        elif d > 0:
            alpha_after = alpha_before - self.cfg.step
        else:
            alpha_after = alpha_before
        alpha_after = min(self.cfg.alpha_max, max(self.cfg.alpha_min, alpha_after))
        if alpha_after != alpha_before:
            self.cache.set_alpha(alpha_after)
        rec = TunerRecord(
            window_index=self._window_index,
            alpha_before=alpha_before,
            alpha_after=alpha_after,
            gradient=d,
            mr_img=stats.mr_img(),
            mr_lat=stats.mr_lat(),
            delta_img=stats.delta_img(),
            delta_lat=stats.delta_lat(),
            t_decode_ms=t_dec,
            t_fetch_ms=t_fet,
            expected_latency_ms=self.expected_latency_ms(stats, t_dec, t_fet),
        )
        self.history.append(rec)
        self._window_index += 1
        return rec
