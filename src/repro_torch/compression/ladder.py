"""Rate-distortion ladder: named quality rungs for cooling durable latents.

The durable tier used to know exactly one codec setting (lossless LBC1).
The trace analysis says coldness is continuous, so cooling objects now
descend a ladder of lossy latent rates before falling all the way to
recipe-only regeneration:

    rung 0  lossless   LBC1, bit-exact            (hot durable)
    rung 1  high       LBQ1 @ 10 bits/elem
    rung 2  mid        LBQ1 @  8 bits/elem
    rung 3  low        LBQ1 @  6 bits/elem
    rung 4  recipe     no latent bytes at all — regenerate from the
                       stored generation recipe on read

Each rung carries the PSNR/SSIM floor that ``bench_fidelity`` gates it
with, a nominal size scale (used by the byte-accounting simulator, which
stores sizes rather than payloads), and the idle-months trigger that the
default :class:`LadderPolicy` uses to pick a target rung for an object.

Re-encoding is *not* an I/O pass of its own: callers record a target
rung next to the object (a ``RUNG`` intent record in the segment log)
and the compactor transcodes the blob when it next rewrites the
segment — see ``store/durable/compact.py``.  :func:`transcode_blob` and
:func:`transcode_record` are the transformations it applies.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np

from repro_torch.compression.latentcodec import (blob_rung, compress_latent,
                                           compress_latent_lossy,
                                           decompress_latent)

__all__ = [
    "Rung", "RUNGS", "RECIPE_RUNG", "LOSSLESS_RUNG", "resolve_rung",
    "encode_at", "transcode_blob", "scaled_nbytes", "blob_rung",
    "LadderPolicy",
]


@dataclass(frozen=True)
class Rung:
    """One quality level of the durable ladder."""

    index: int
    name: str
    bits: Optional[int]       # quantizer bits/elem; None = lossless, 0 = recipe
    psnr_floor_db: float      # decoded-pixel PSNR floor vs lossless reference
    ssim_floor: float         # decoded-pixel SSIM floor vs lossless reference
    idle_mo: float            # default demotion trigger (months since access)
    scale: float              # nominal bytes fraction vs the lossless blob

    @property
    def lossy(self) -> bool:
        return self.bits is not None and self.bits > 0

    @property
    def is_recipe(self) -> bool:
        return self.bits == 0


# Floors are calibrated against the demo VAE (decoded pixels vs the
# lossless-rung decode; bench_fidelity gates them in CI).  Observed
# minima across the demo/tiny decoders: high ~54 dB / 0.9999,
# mid ~51 dB / 0.9998, low ~43 dB / 0.9988 — the floors sit a few dB
# under that so codec drift fails loudly without flaking.  Lossless and
# recipe rungs reproduce the reference bit-exactly: floors vacuous.
RUNGS = (
    Rung(0, "lossless", None, float("inf"), 1.0, 0.0, 1.00),
    Rung(1, "high", 10, 46.0, 0.995, 1.0, 0.62),
    Rung(2, "mid", 8, 40.0, 0.990, 3.0, 0.50),
    Rung(3, "low", 6, 30.0, 0.950, 6.0, 0.38),
    Rung(4, "recipe", 0, float("inf"), 1.0, 12.0, 0.0),
)

LOSSLESS_RUNG = 0
RECIPE_RUNG = 4

_BY_NAME = {r.name: r for r in RUNGS}


def resolve_rung(rung: Union[int, str, Rung, None]) -> Rung:
    """Accepts an index, a name, a Rung, or None (None -> recipe: the
    pre-ladder ``demote()`` call always meant 'all the way down')."""
    if rung is None:
        return RUNGS[RECIPE_RUNG]
    if isinstance(rung, Rung):
        return rung
    if isinstance(rung, str):
        try:
            return _BY_NAME[rung]
        except KeyError:
            raise ValueError(
                f"unknown rung {rung!r}; want one of {sorted(_BY_NAME)}"
            ) from None
    idx = int(rung)
    if not 0 <= idx < len(RUNGS):
        raise ValueError(f"rung index {idx} out of range [0, {len(RUNGS)})")
    return RUNGS[idx]


def encode_at(arr: np.ndarray, rung: Union[int, str, Rung],
              level: int = 6) -> bytes:
    """Encode a latent tensor at the given rung's codec setting."""
    r = resolve_rung(rung)
    if r.is_recipe:
        raise ValueError("recipe rung stores no latent bytes")
    if r.bits is None:
        return compress_latent(arr, level)
    return compress_latent_lossy(arr, r.bits, rung=r.index, level=level)


def transcode_blob(blob: bytes, rung: Union[int, str, Rung],
                   level: int = 6) -> bytes:
    """Re-encode a durable blob at a colder rung.  No-op if the blob is
    already at (or below) the target quality — the ladder only descends."""
    r = resolve_rung(rung)
    if blob_rung(blob) >= r.index:
        return blob
    return encode_at(decompress_latent(blob), r, level)


def scaled_nbytes(nbytes: float, cur: int, target: int) -> float:
    """Nominal size of a payload-less (simulator) object after demotion
    from rung ``cur`` to rung ``target``."""
    cs = resolve_rung(cur).scale
    ts = resolve_rung(target).scale
    if cs <= 0.0:
        return 0.0
    return float(nbytes) * ts / cs


@dataclass(frozen=True)
class LadderPolicy:
    """Maps idleness to a target rung: the coldest rung whose trigger the
    object's idle time has crossed.  ``None`` means 'stay put'."""

    enabled: bool = True

    def rung_for_idle(self, idle_mo: float, cur: int = 0) -> Optional[int]:
        if not self.enabled:
            return None
        target = max((r.index for r in RUNGS if idle_mo >= r.idle_mo),
                     default=LOSSLESS_RUNG)
        return target if target > cur else None
