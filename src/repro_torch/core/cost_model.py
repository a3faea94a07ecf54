"""Long-term cost projection (paper §6.4, Fig. 8; parameters in Table 5).

Two cost components distinguish the strategies: persistent storage and
on-demand GPU decode.

  C_ImgStore(t)  = N(t) * S_px * P_S3                                  (Eq. 3)
  C_LatentBox(t) = N(t) * (S_lat + f * S_px) * P_S3 + M(t) * P_dec     (Eq. 4)

with an optional Glacier-IR tier for ImgStore (objects older than 5 years
move to cold storage; retrievals priced per GB + per request, demand from
the stratified age-decay fit of O2) and an optional price-decline scenario
(GPU -20 %/yr, storage -10 %/yr).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


#: Bytes per pixel-cache element by stored dtype.  ``uint8`` is the fused
#: decode epilogue's displayable fast path; ``float32`` is what the
#: pre-fusion engine pinned (4x the bytes).
PIXEL_FORMAT_BYTES: Dict[str, int] = {"uint8": 1, "float32": 4}


def pixel_cache_entry_mb(pixel_format: str = "uint8", height: int = 1024,
                         width: int = 1024, channels: int = 3) -> float:
    """Pixel-cache entry size in (decimal, Table-5-convention) MB, derived
    from the stored format instead of hard-coded: H*W*C * bytes/elem.
    1024x1024x3 uint8 -> 3.145728 MB; float32 -> 12.582912 MB."""
    try:
        bpe = PIXEL_FORMAT_BYTES[pixel_format]
    except KeyError:
        raise ValueError(
            f"unknown pixel_format {pixel_format!r}; "
            f"expected one of {sorted(PIXEL_FORMAT_BYTES)}") from None
    return height * width * channels * bpe / 1e6


def params_for_store(store_cfg, base: Optional["CostParams"] = None
                     ) -> "CostParams":
    """Price a :class:`~repro.store.api.StoreConfig`'s actual cache
    charges: the pixel-cache entry term follows the config's
    ``pixel_format`` (duck-typed — any object with that attribute works),
    so controller cost estimates match what the cache really pins."""
    base = base or CostParams()
    fmt = getattr(store_cfg, "pixel_format", "uint8")
    return dataclasses.replace(base, s_px_cache_mb=pixel_cache_entry_mb(fmt))


@dataclasses.dataclass(frozen=True)
class CostParams:
    s_px_mb: float = 1.5               # average PNG, 1024x1024
    #: A pixel-cache entry: raw decoded 1024x1024x3 uint8 HWC (the fused
    #: decode epilogue stores displayable bytes — 4x below the 12.6 MB
    #: float32 arrays the pre-fusion engine pinned).  Derived:
    #: ``pixel_cache_entry_mb("uint8")`` = 1024*1024*3/1e6.
    s_px_cache_mb: float = 3.145728
    s_lat_mb: float = 0.29             # compressed latent, SD 3.5
    p_s3_gb_mo: float = 0.023          # S3 Standard
    p_glacier_gb_mo: float = 0.004     # Glacier IR storage
    p_gir_ret_gb: float = 0.01         # Glacier IR retrieval $/GB
    p_gir_ret_req: float = 0.0001      # Glacier IR retrieval $/request
    p_gpu_hr_h100: float = 2.50
    p_gpu_hr_5090: float = 0.69
    t_dec_ms: float = 40.0
    cache_fraction: float = 0.01       # f — pixel-cache fraction of working set
    m_gpu: float = 0.632               # decode-trigger rate (measured)
    views_per_image_yr: float = 10.2   # lambda
    glacier_age_cutoff_yr: float = 5.0
    # steady state observed at the trace tail
    new_images_per_month: float = 3.76e6
    # age-decay model (O2): view rate at age a ∝ (1 + a/a0)^(-beta)
    decay_a0_yr: float = 0.08
    decay_beta: float = 1.8


@dataclasses.dataclass
class CostScenario:
    gpu_price_decline_yr: float = 0.0      # e.g. 0.20 => -20 %/yr
    storage_price_decline_yr: float = 0.0  # e.g. 0.10 => -10 %/yr


def _old_fraction(months_since_start: np.ndarray, cutoff_mo: float,
                  n0: float, growth_per_mo: float) -> np.ndarray:
    """Fraction of the cumulative corpus older than ``cutoff_mo`` at each t,
    under linear growth N(t) = n0 + g*t."""
    t = months_since_start
    n_t = n0 + growth_per_mo * t
    born_before = np.where(t > cutoff_mo, n0 + growth_per_mo * (t - cutoff_mo), 0.0)
    return np.where(n_t > 0, born_before / n_t, 0.0)


def _glacier_retrieval_rate(p: CostParams, cutoff_yr: float) -> float:
    """Mean views/yr for an image older than the cutoff, from the O2 decay
    fit: lambda(a) ∝ (1+a/a0)^(-beta), normalized so the lifetime mean over
    the first year equals ``views_per_image_yr``."""
    a0, b = p.decay_a0_yr, p.decay_beta
    # normalize: integral over [0, 1yr] of k*(1+a/a0)^-b da = views_per_image_yr
    integ_1yr = a0 / (b - 1.0) * (1.0 - (1.0 + 1.0 / a0) ** (1.0 - b))
    k = p.views_per_image_yr / integ_1yr
    return float(k * (1.0 + cutoff_yr / p.decay_a0_yr) ** (-p.decay_beta))


def project(params: Optional[CostParams] = None,
            scenario: Optional[CostScenario] = None,
            start_year: float = 2023.33,
            horizon_years: float = 26.9,
            n0_images: float = 10e6,
            trace_end_year: float = 2026.25,
            n_trace_end: float = 92.3e6,
            months_step: float = 1.0) -> Dict[str, np.ndarray]:
    """Cumulative cost curves ($) per strategy, monthly resolution.

    Returns dict with 'year' axis plus one cumulative-cost array per setup:
    imgstore, imgstore_glacier, lb_h100, lb_5090.
    """
    p = params or CostParams()
    sc = scenario or CostScenario()
    months = np.arange(0.0, horizon_years * 12.0 + 1e-9, months_step)
    years = months / 12.0

    # corpus: ramp over the trace window (to n_trace_end at trace end),
    # then the steady-state monthly additions observed at the trace tail
    ramp_mo = (trace_end_year - start_year) * 12.0
    ramp = n0_images + (n_trace_end - n0_images) *         np.clip(months / max(ramp_mo, 1e-9), 0.0, 1.0) ** 1.5
    steady = n_trace_end + p.new_images_per_month *         np.maximum(months - ramp_mo, 0.0)
    n_t = np.where(months <= ramp_mo, ramp, steady)
    # price declines start at trace end (paper: "from 2026")
    decl_years = np.maximum(years - ramp_mo / 12.0, 0.0)
    gpu_mult = (1.0 - sc.gpu_price_decline_yr) ** decl_years
    sto_mult = (1.0 - sc.storage_price_decline_yr) ** decl_years

    gb = 1.0 / 1024.0                                           # MB -> GB
    s_px_gb = p.s_px_mb * gb
    s_px_cache_gb = p.s_px_cache_mb * gb
    s_lat_gb = p.s_lat_mb * gb

    # --- ImgStore on S3 Standard (Eq. 3): monthly storage bill, accumulated
    img_monthly = n_t * s_px_gb * p.p_s3_gb_mo * sto_mult
    imgstore = np.cumsum(img_monthly) * months_step

    # --- ImgStore + Glacier IR (5-yr archive cutoff)
    cutoff_mo = p.glacier_age_cutoff_yr * 12.0
    frac_old = _old_fraction(months, cutoff_mo, n0_images, p.new_images_per_month)
    hot = n_t * (1.0 - frac_old) * s_px_gb * p.p_s3_gb_mo
    cold = n_t * frac_old * s_px_gb * p.p_glacier_gb_mo
    ret_rate_yr = _glacier_retrieval_rate(p, p.glacier_age_cutoff_yr)
    ret_req_mo = n_t * frac_old * ret_rate_yr / 12.0
    retrieval = ret_req_mo * (p.p_gir_ret_req + s_px_gb * p.p_gir_ret_gb)
    imgstore_glacier = np.cumsum((hot + cold + retrieval) * sto_mult) * months_step

    # --- LatentBox (Eq. 4): latent + pixel-cache storage, plus GPU decode
    # (the cache term prices raw uint8 pixel-cache entries, not PNGs)
    lb_storage = n_t * (s_lat_gb
                        + p.cache_fraction * s_px_cache_gb) * p.p_s3_gb_mo
    decodes_mo = p.m_gpu * p.views_per_image_yr * n_t / 12.0    # M(t) per month
    gpu_hours_mo = decodes_mo * (p.t_dec_ms / 1e3) / 3600.0
    out = {"year": start_year + years, "imgstore": imgstore,
           "imgstore_glacier": imgstore_glacier}
    for tag, price in (("h100", p.p_gpu_hr_h100), ("5090", p.p_gpu_hr_5090)):
        monthly = lb_storage * sto_mult + gpu_hours_mo * price * gpu_mult
        out[f"lb_{tag}"] = np.cumsum(monthly) * months_step
    return out


HOURS_PER_MONTH = 730.0


def dollars_per_million_requests(summary: Dict, n_requests: int,
                                 params: Optional[CostParams] = None,
                                 gpu_price_hr: Optional[float] = None
                                 ) -> float:
    """Price one serving run as $-per-million-requests from a LatentBox
    ``summary()`` carrying the provisioned-resource time integrals:

      * ``provisioned_gpu_ms``        — sum over time of (GPUs held * dt),
        priced at the decode-GPU $/hr whether busy or idle (you pay for
        what you provision, which is exactly what the autoscaler trades);
      * ``provisioned_cache_byte_ms`` — sum over time of (cache bytes
        held * dt), priced at the storage $/GB-month rate;
      * ``durable_bytes``             — durable footprint, charged for the
        run's span (inferred from the GPU integral / GPU count when
        available; a second-order term at these spans either way).
    """
    p = params or CostParams()
    price = p.p_gpu_hr_h100 if gpu_price_hr is None else float(gpu_price_hr)
    if n_requests <= 0:
        return 0.0
    gpu_ms = float(summary.get("provisioned_gpu_ms", 0.0))
    dollars = (gpu_ms / 3.6e6) * price
    byte_ms = float(summary.get("provisioned_cache_byte_ms", 0.0))
    n_gpus = float(summary.get("decode_gpus", 0.0))
    span_ms = gpu_ms / n_gpus if n_gpus > 0 else 0.0
    byte_ms += float(summary.get("durable_bytes", 0.0)) * span_ms
    gb_hr = byte_ms / 1e9 / 3.6e6
    dollars += gb_hr * p.p_s3_gb_mo / HOURS_PER_MONTH
    return dollars * 1e6 / n_requests


def normalized_horizons(curves: Dict[str, np.ndarray],
                        horizons=(2026.25, 2030.0, 2040.0, 2050.0)
                        ) -> Dict[str, Dict[float, float]]:
    """Fig. 8: cumulative cost at horizons, normalized so ImgStore at the
    first horizon (trace end, March 2026) equals 1."""
    year = curves["year"]
    i0 = int(np.argmin(np.abs(year - horizons[0])))
    ref = curves["imgstore"][i0]
    out: Dict[str, Dict[float, float]] = {}
    for k, v in curves.items():
        if k == "year":
            continue
        out[k] = {h: float(v[int(np.argmin(np.abs(year - h)))] / ref)
                  for h in horizons}
    return out
