"""Persistent kernel autotuner for the decode's four conv kernels on the
card: per-shape sweeps of bit-neutral tile layouts with a versioned
on-disk tuning cache (counterpart of the JAX package's
``kernels/autotune.py``).

The decode rests on one contract: every output's sums have a fixed place
and order, whatever the batch, so a bucket-8 decode gives the bits of
eight batch-1 decodes.  A tuner that keys its entries by bucket may only
choose among launches that give the default's bits.  So the knobs here
are the ones that leave every sum alone:

* ``layout`` of the conv tiles.  ``conv3x3`` runs the ``mma.sync`` tile
  (``csrc/tc_conv_tile.cuh``): 128 output channels a block on 8 warps
  (two blocks per SM) or on 16 (one), or 64 channels on 8 warps (twice
  the blocks); 0 is the hand-picked rule: 16 warps where the 128-wide
  grid fits the SMs once over, else 8.  ``gn_silu_conv3x3`` and
  ``upsample_conv3x3`` run the warpgroup tile
  (``csrc/wg_conv_tile.cuh``), which has one layout (0, or its name 1):
  their sweep times that launch alone;
* ``tile_h`` of ``output_epilogue`` (``csrc/output_epilogue.cu``): 16 or 8
  rows of pixels a block.  0 is 16.

The knobs that do set the sum order are functions of the shape alone and
are not tuned: ``conv3x3.k_split`` (the 32-wide tile's K split),
``gn_silu_conv.stats_slices`` (the statistics pass's slices) and the
epilogue's weight segment.  The 32-wide route (4 < Cout <= 32) and the
CUDA-core route (Cout <= 4) have one candidate each.

* :func:`decode_shapes` derives, from a VAE config, a latent shape and a
  batch bucket, the ``(kernel, call shape)`` set that ``decode_u8``
  launches;
* :func:`candidates` lists a shape's launches, the default first, with
  none twice and none the card cannot hold;
* :func:`tune` sweeps them with a best-of-N timer (injectable: exactly two
  ``timer()`` reads per rep, the device synchronised before the second),
  checks every candidate's output against the default's bit for bit
  (``torch.equal``; a difference raises), and keeps the default on a tie,
  so a winner is never slower than the default under the measurements
  taken;
* :class:`TuningCache` persists the winners in ``tuning_cache.json``,
  versioned, written atomically, and loaded as an empty cache when the
  file is missing, corrupt or of another schema;
* the four kernel wrappers look their launch up through the process-wide
  active cache (:func:`set_active_cache`, :func:`tuned_params`) on every
  CUDA call; a miss, an entry of the JAX package (whose knobs are
  ``rows`` and ``block_cout``) or a malformed one runs the default;
* :class:`KernelAutotuner` is the engine's tune-on-first-miss tuner: the
  engine notes each (bucket, latent shape) it decodes, and ``step`` tunes
  a bounded number of missing keys on the engine's device.  On the CPU
  it times the plain versions, which take no knobs (for the tests only).

Offline: ``python -m repro_torch.kernels.autotune --cache PATH`` (on the
card; ``--device cpu`` runs the plain versions, ``--smoke`` a small grid);
point ``StoreConfig.data_dir`` at the same directory and every reopen
picks the winners up.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

#: 2 since the fused GN conv and the upsampler moved to the warpgroup
#: tile: their layout codes name other launches than version 1's
SCHEMA_VERSION = 2
CACHE_FILENAME = "tuning_cache.json"

#: Kernels the tuner drives (the ``decode_u8`` launch set).
KERNELS = ("conv3x3", "gn_silu_conv3x3", "upsample_conv3x3",
           "output_epilogue")

#: The ``mma.sync`` conv tile's layout codes (``tc_conv_tile.cuh``'s
#: ``Layout``; ``conv3x3``): the rule by grid size, 128 wide on 8 or 16
#: warps, 64 wide on 8 (compiled for the vectorised path only).
RULE, WIDE8, WIDE16, HALF8 = 0, 1, 2, 3
#: The warpgroup conv tile's (``wg_conv_tile.cuh``'s ``Layout``;
#: ``gn_silu_conv3x3`` and ``upsample_conv3x3``): its one layout, two
#: consumer warpgroups a block, by name (0 launches it too).
ROWS2 = 1
#: the kernels that run the warpgroup tile
WG_KERNELS = ("gn_silu_conv3x3", "upsample_conv3x3")
#: The epilogue's tile heights (``output_epilogue.cu``; 8 vectorised only).
TILE_HEIGHTS = (16, 8)

#: The launch arguments that run each kernel's hand-picked default (what
#: the wrappers pass on a miss); candidate 0 of a sweep is what they
#: resolve to for its shape.
DEFAULTS = {
    "conv3x3": {"layout": RULE},
    "gn_silu_conv3x3": {"layout": RULE},
    "upsample_conv3x3": {"layout": RULE},
    "output_epilogue": {"tile_h": 0},
}
#: kernel -> (its knob, the values an entry may give it)
KNOBS = {
    "conv3x3": ("layout", (RULE, WIDE8, WIDE16, HALF8)),
    "gn_silu_conv3x3": ("layout", (RULE, ROWS2)),
    "upsample_conv3x3": ("layout", (RULE, ROWS2)),
    "output_epilogue": ("tile_h", (0,) + TILE_HEIGHTS),
}

#: an H100's SMs: the rule's count where no card is asked (the CPU path)
H100_SMS = 132
#: a block's shared memory and threads on the H100
MAX_SMEM = 232448
MAX_THREADS = 1024


def cache_key(kernel: str, n: int, h: int, w: int, cin: int, cout: int,
              weight_dtype: str) -> str:
    """One tuning-cache key per (kernel, resolution, bucket, weight_dtype)."""
    return f"{kernel}|n{n}|{h}x{w}|{cin}->{cout}|{weight_dtype}"


def weight_tag(w: torch.Tensor) -> str:
    """The key's weight dtype of a kernel weight in its storage form: the
    upsampler's int16 taps (int8 codes collapsed) key as ``"int8"``."""
    return {torch.float32: "float32", torch.bfloat16: "bfloat16",
            torch.int8: "int8", torch.int16: "int8"}[w.dtype]


def device_name(device: torch.device) -> str:
    """What a cache file records as its device: the card's name, or
    ``"cpu"``."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


# ---------------------------------------------------------------------------
# the persistent cache
# ---------------------------------------------------------------------------

class TuningCache:
    """Versioned JSON map ``cache_key -> {'layout' or 'tile_h', 'us', ...}``.

    Loading never raises on bad files: a missing, unparseable, or
    wrong-``schema_version`` file gives an *empty* cache (the kernels then
    run their defaults), so a stale cache can cost speed, never
    correctness.  Writes go through a tmp file and ``os.replace``, so a
    crash mid-save leaves the previous cache intact.  The file records the
    device its entries were tuned on (``"device"``: the card's name, or
    ``"cpu"``) where the JAX package's records its JAX backend.
    """

    def __init__(self, path: Optional[str] = None,
                 entries: Optional[Dict[str, Dict[str, Any]]] = None,
                 device: str = "cpu"):
        self.path = path
        self.entries: Dict[str, Dict[str, Any]] = dict(entries or {})
        self.device = device

    @classmethod
    def load(cls, path: Optional[str]) -> "TuningCache":
        cache = cls(path)
        if path is None or not os.path.exists(path):
            return cache
        try:
            with open(path, "r", encoding="utf-8") as f:
                doc = json.load(f)
            if (isinstance(doc, dict)
                    and doc.get("schema_version") == SCHEMA_VERSION
                    and isinstance(doc.get("entries"), dict)):
                cache.entries = {
                    str(k): dict(v) for k, v in doc["entries"].items()
                    if isinstance(v, dict)}
                cache.device = str(doc.get("device", cache.device))
        except (OSError, ValueError):
            pass                        # corrupt file -> clean empty cache
        return cache

    def save(self) -> None:
        if self.path is None:
            return
        doc = {"schema_version": SCHEMA_VERSION, "device": self.device,
               "entries": self.entries}
        tmp = self.path + ".tmp"
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)

    def get(self, key: str) -> Optional[Dict[str, Any]]:
        return self.entries.get(key)

    def put(self, key: str, entry: Dict[str, Any]) -> None:
        self.entries[key] = dict(entry)

    def __len__(self) -> int:
        return len(self.entries)

    def __contains__(self, key: str) -> bool:
        return key in self.entries


_ACTIVE: Optional[TuningCache] = None


def set_active_cache(cache: Optional[TuningCache]) -> None:
    """Install the process-wide cache the kernel wrappers consult (models
    never thread it explicitly)."""
    global _ACTIVE
    _ACTIVE = cache


def get_active_cache() -> Optional[TuningCache]:
    return _ACTIVE


@contextlib.contextmanager
def active_cache(cache: Optional[TuningCache]):
    """Scoped :func:`set_active_cache` (benches/tests)."""
    prev = _ACTIVE
    set_active_cache(cache)
    try:
        yield cache
    finally:
        set_active_cache(prev)


def entry_knobs(kernel: str, entry: Optional[Dict[str, Any]]
                ) -> Dict[str, int]:
    """The knobs of a cache entry for ``kernel``: ``{knob: value}`` when
    the entry has the kernel's knob with an allowed value, else ``{}``."""
    knob, allowed = KNOBS[kernel]
    v = (entry or {}).get(knob)
    if isinstance(v, int) and not isinstance(v, bool) and v in allowed:
        return {knob: v}
    return {}


def tuned_params(kernel: str, x_shape: Sequence[int], cout: int,
                 weight_dtype: str) -> Dict[str, int]:
    """The launch-side lookup: the tuned ``{'layout'}`` or ``{'tile_h'}``
    of this call, or ``{}`` (the kernel's default) on no active cache, a
    miss or an entry without a valid knob of this package."""
    if _ACTIVE is None:
        return {}
    n, h, w, cin = (int(v) for v in x_shape)
    return entry_knobs(kernel, _ACTIVE.get(
        cache_key(kernel, n, h, w, cin, cout, weight_dtype)))


def launch_knob(kernel: str, x_shape: Sequence[int], cout: int,
                w: torch.Tensor) -> int:
    """The knob a wrapper launches ``kernel`` with: the active cache's
    for this call (``w`` the weight in its storage form), else the
    default's launch argument (:data:`DEFAULTS`)."""
    knob = KNOBS[kernel][0]
    return tuned_params(kernel, x_shape, cout, weight_tag(w)).get(
        knob, DEFAULTS[kernel][knob])


# ---------------------------------------------------------------------------
# shape derivation (what will decode_u8 launch?)
# ---------------------------------------------------------------------------

def decode_shapes(cfg, latent_hwc: Tuple[int, int, int],
                  bucket: int) -> List[Dict[str, Any]]:
    """The deduplicated ``(kernel, call shape)`` set of one ``decode_u8``
    at batch size ``bucket``, derived from the decoder architecture, so
    it can run before any launch.  ``cfg`` is a
    :class:`repro_torch.vae.model.VAEConfig`."""
    h, w, c_lat = (int(v) for v in latent_hwc)
    n = int(bucket)
    chs = cfg.block_out_channels
    top = chs[-1]
    shapes: List[Dict[str, Any]] = []
    seen = set()

    def add(kernel, h_, w_, cin, cout):
        spec = {"kernel": kernel, "n": n, "h": h_, "w": w_,
                "cin": cin, "cout": cout, "groups": cfg.groups}
        sig = (kernel, h_, w_, cin, cout)
        if sig not in seen:
            seen.add(sig)
            shapes.append(spec)

    add("conv3x3", h, w, c_lat, top)                 # conv_in
    add("gn_silu_conv3x3", h, w, top, top)           # mid res blocks
    cin = top
    for i, cout in enumerate(reversed(chs)):
        for _ in range(cfg.layers_per_block + 1):
            add("gn_silu_conv3x3", h, w, cin, cout)
            cin = cout
        if i < len(chs) - 1:
            add("upsample_conv3x3", h, w, cout, cout)
            h, w = 2 * h, 2 * w
    add("output_epilogue", h, w, chs[0], cfg.image_channels)
    return shapes


# ---------------------------------------------------------------------------
# candidate grids (mirrors of the C launch rules) + the timed harness
# ---------------------------------------------------------------------------

_TC_TH, _TC_TW, _TC_BK, _TC_PLANE = 4, 32, 16, 232   # tc_conv_tile.cuh
_WIDTHS = {WIDE8: (128, 256), WIDE16: (128, 512), HALF8: (64, 256)}
_EPI_TW, _EPI_HROW, _EPI_W_BYTES = 32, 35, 9 * 3 * 4  # output_epilogue.cu


def _itemsize(kernel: str, weight_dtype: str) -> int:
    """Bytes of one stored weight as the kernel reads it (the upsampler's
    int8 codes arrive collapsed in int16)."""
    if weight_dtype == "int8":
        return 2 if kernel == "upsample_conv3x3" else 1
    return {"float32": 4, "bfloat16": 2}[weight_dtype]


def _one_layout(kernel: str, cout: int) -> bool:
    """The routes with one launch: conv3x3's 32-wide tile and CUDA-core
    tile (Cout <= 32); the warpgroup tile of the fused GN conv and the
    upsampler, and the GN conv's CUDA-core tile (Cout <= 4)."""
    return kernel in WG_KERNELS or (kernel == "conv3x3" and cout <= 32)


def rule_layout(kernel: str, spec: Dict[str, Any], sms: int) -> int:
    """The layout that code 0 runs for a shape of ``conv3x3``'s wide tile:
    16 warps where the 128-wide grid fits the SMs once over, else 8."""
    blocks = (spec["n"] * -(-spec["h"] // _TC_TH) * -(-spec["w"] // _TC_TW)
              * -(-spec["cout"] // 128))
    return WIDE16 if blocks <= sms else WIDE8


def _epilogue_ring(tile_h: int) -> int:
    return 3 * (tile_h + 2) * _EPI_HROW * 4 * 16


def _fits(kernel: str, spec: Dict[str, Any], knobs: Dict[str, int],
          weight_dtype: str) -> bool:
    """Whether a candidate's block fits the card's shared memory and
    threads (and its vectorised-only variant is compiled for the shape)."""
    cin, cout = spec["cin"], spec["cout"]
    if kernel == "output_epilogue":
        th = knobs["tile_h"]
        if th != 16 and cin % 4:
            return False
        cpad = -(-cin // 16) * 16
        wcap = (MAX_SMEM - _epilogue_ring(16)) // _EPI_W_BYTES // 16 * 16
        smem = _epilogue_ring(th) + min(cpad, wcap) * _EPI_W_BYTES
        threads = 4 * (th * _EPI_TW // 4)      # four quarters of a chunk
        return smem <= MAX_SMEM and threads <= MAX_THREADS
    layout = knobs["layout"]
    if layout == RULE:
        return True
    size = _itemsize(kernel, weight_dtype)
    vec = 16 // size
    if layout == HALF8 and (cin % 4 or cout % vec):
        return False
    bn, nt = _WIDTHS[layout]
    rs = bn + max(vec, 8)
    smem = 2 * (2 * _TC_BK * _TC_PLANE) * 4 + 3 * _TC_BK * rs * size
    return smem <= MAX_SMEM and nt <= MAX_THREADS


def candidates(kernel: str, spec: Dict[str, Any], sms: int = H100_SMS,
               weight_dtype: str = "float32") -> List[Dict[str, int]]:
    """The shape's launches, a pure function of the shape, the weight
    dtype and the SM count.  Candidate 0 is the one the hand-picked rule
    runs; no launch is listed twice, and none that does not fit the card
    (or is not compiled for the shape).  The sweep keeps the earliest of
    equal times, so 'no measurable win' keeps the default."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r} (valid: {KERNELS})")
    if kernel == "output_epilogue":
        grid = [{"tile_h": th} for th in TILE_HEIGHTS]
    elif _one_layout(kernel, spec["cout"]):
        return [{"layout": RULE}]
    else:
        grid = [{"layout": rule_layout(kernel, spec, sms)}] + [
            {"layout": v} for v in (WIDE8, WIDE16, HALF8)]
    out: List[Dict[str, int]] = []
    for cand in grid:
        if cand not in out and _fits(kernel, spec, cand, weight_dtype):
            out.append(cand)
    return out


def _make_operands(spec: Dict[str, Any], weight_dtype: str,
                   device: torch.device, seed: int = 0) -> Dict[str, Any]:
    """Seeded synthetic operands for one kernel call, made on the device
    itself (bucket 8 of the SD3.5 decoder's 512 x 512 x 256 conv is 2.1
    GB of input)."""
    from repro_torch.kernels import ref
    from repro_torch.vae.quantize import quantize_int8
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    h, w, cin, cout = spec["h"], spec["w"], spec["cin"], spec["cout"]
    x = randn(spec["n"], h, w, cin)
    wf = randn(3, 3, cin, cout) / math.sqrt(9 * cin)
    ops = {"x": x, "b": randn(cout) * 0.01, "w_scale": None,
           "scale": torch.ones(cin, device=device),
           "bias": torch.zeros(cin, device=device)}
    if weight_dtype == "bfloat16":
        wk = wf.to(torch.bfloat16)
    elif weight_dtype == "int8":
        qw = quantize_int8(wf)
        wk, ops["w_scale"] = qw.q, qw.scale
    else:
        wk = wf
    if spec["kernel"] == "upsample_conv3x3":     # the taps, collapsed once
        wk = ref.storage_phase_weights(wk).contiguous()
    ops["w"] = wk
    return ops


def _make_thunk(spec: Dict[str, Any], o: Dict[str, Any],
                cand: Dict[str, int]) -> Callable[[], torch.Tensor]:
    """A zero-arg callable running one kernel at one candidate launch."""
    from repro_torch.kernels import (conv3x3 as c3, gn_silu_conv as gsc,
                                     output_epilogue as oe,
                                     upsample_conv as uc)
    kernel = spec["kernel"]
    x, w, b, s = o["x"], o["w"], o["b"], o["w_scale"]
    if kernel == "conv3x3":
        return lambda: c3.conv3x3(x, w, b, w_scale=s, **cand)
    if kernel == "upsample_conv3x3":
        return lambda: uc.upsample_conv3x3_taps(x, w, b, w_scale=s, **cand)
    if kernel == "gn_silu_conv3x3":
        return lambda: gsc.gn_silu_conv3x3(x, o["scale"], o["bias"], w, b,
                                           groups=spec["groups"], w_scale=s,
                                           **cand)
    if kernel == "output_epilogue":
        return lambda: oe.output_epilogue(x, o["scale"], o["bias"], w, b,
                                          groups=spec["groups"], w_scale=s,
                                          **cand)
    raise ValueError(f"unknown kernel {kernel!r} (valid: {KERNELS})")


def _no_sync() -> None:
    return None


def _timed(thunk: Callable[[], Any], reps: int,
           timer: Callable[[], float], sync: Callable[[], None]):
    """(best-of-N microseconds, the warm-up call's output)."""
    out = thunk()
    sync()
    best = float("inf")
    for _ in range(max(1, reps)):
        t0 = timer()
        thunk()
        sync()
        best = min(best, timer() - t0)
    return best * 1e6, out


def time_call(thunk: Callable[[], Any], reps: int = 2,
              timer: Callable[[], float] = time.perf_counter,
              sync: Callable[[], None] = _no_sync) -> float:
    """Best-of-N wall time in microseconds.  One untimed warm-up call (it
    loads the kernel), then exactly two ``timer()`` reads per rep, with
    ``sync`` (the device's synchronise, on the card) before the second (a
    scripted fake timer makes winner selection deterministic in tests)."""
    return _timed(thunk, reps, timer, sync)[0]


def _sms(device: torch.device) -> int:
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return H100_SMS


def _sync_of(device: torch.device) -> Callable[[], None]:
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return _no_sync


def tune(spec: Dict[str, Any], weight_dtype: str = "float32",
         device="cpu", reps: int = 2,
         timer: Callable[[], float] = time.perf_counter) -> Dict[str, Any]:
    """Sweep one shape's candidates on ``device``; returns the cache entry.

    The operands are made once, on the device, and freed after the sweep.
    Every candidate's output must equal the default's bit for bit
    (``torch.equal``), or this raises: a tuned launch never changes a bit.
    The default is always measured (candidate 0) and ties keep it, so
    ``entry['us'] <= entry['default_us']`` by construction."""
    dev = torch.device(device)
    kernel = spec["kernel"]
    cands = candidates(kernel, spec, _sms(dev), weight_dtype)
    operands = _make_operands(spec, weight_dtype, dev)
    sync = _sync_of(dev)
    times: List[float] = []
    base = None
    for i, cand in enumerate(cands):
        us, out = _timed(_make_thunk(spec, operands, cand), reps, timer, sync)
        if base is None:
            base = out
        elif not torch.equal(out, base):
            raise RuntimeError(
                f"{kernel} at {spec}: launch {cand} changes the bits of "
                f"the default {cands[0]} ({weight_dtype})")
        times.append(us)
        del out
    del operands, base
    best = min(range(len(cands)), key=lambda i: (times[i], i))
    return {**cands[best], "us": times[best], "default_us": times[0],
            "candidates": len(cands), "candidate_us": times,
            "impl": "cuda" if dev.type == "cuda" else "plain",
            "weight_dtype": weight_dtype}


# ---------------------------------------------------------------------------
# serving side: tune-on-first-miss
# ---------------------------------------------------------------------------

class KernelAutotuner:
    """Bounded tuner the :class:`ServingEngine` drives.

    ``note_bucket`` records a (bucket, latent shape) the engine decodes
    and queues every derived kernel shape the cache does not cover (an
    entry without a valid knob of this package, such as the JAX
    package's, counts as missing); ``step(budget)`` tunes at most
    ``budget`` queued keys on ``device`` (one engine maintenance slice =
    one key by default) and persists the cache after them.  The sweeps
    run the kernels standalone, on the engine's device: on the card the
    kernels themselves, on the CPU their plain versions (which take no
    knobs: the tests' path).  ``step_ms`` keeps the wall ms of every step
    that tuned a key (what serving paid for it).
    """

    def __init__(self, cache: TuningCache, vae_cfg,
                 weight_dtype: str = "float32", device=None, reps: int = 2,
                 timer: Callable[[], float] = time.perf_counter):
        from repro_torch.device import resolve_device
        self.device = resolve_device(device)
        self.cache = cache
        self.cache.device = device_name(self.device)
        self.vae_cfg = vae_cfg
        self.weight_dtype = weight_dtype
        self.reps = reps
        self.timer = timer
        self.step_ms: List[float] = []
        self._queue: List[Tuple[str, Dict[str, Any]]] = []
        self._queued: set = set()

    @property
    def pending(self) -> int:
        return len(self._queue)

    def note_bucket(self, bucket: int,
                    latent_hwc: Tuple[int, int, int]) -> int:
        """Queue every kernel shape of this (bucket, latent) decode that
        the cache does not cover yet; returns how many were queued."""
        added = 0
        for spec in decode_shapes(self.vae_cfg, latent_hwc, bucket):
            key = cache_key(spec["kernel"], spec["n"], spec["h"], spec["w"],
                            spec["cin"], spec["cout"], self.weight_dtype)
            if (entry_knobs(spec["kernel"], self.cache.get(key))
                    or key in self._queued):
                continue
            self._queued.add(key)
            self._queue.append((key, spec))
            added += 1
        return added

    def step(self, budget: int = 1) -> List[str]:
        """Tune up to ``budget`` queued keys; persists the cache if any
        were tuned and returns their keys."""
        t0 = time.perf_counter()
        tuned: List[str] = []
        while self._queue and len(tuned) < budget:
            key, spec = self._queue.pop(0)
            self._queued.discard(key)
            self.cache.put(key, tune(spec, weight_dtype=self.weight_dtype,
                                     device=self.device, reps=self.reps,
                                     timer=self.timer))
            tuned.append(key)
        if tuned:
            self.cache.save()
            self.step_ms.append((time.perf_counter() - t0) * 1e3)
        return tuned


# ---------------------------------------------------------------------------
# offline pre-tuning CLI
# ---------------------------------------------------------------------------

def _cli_sweep(cache: TuningCache, vae_cfg, latent_hwc, buckets,
               weight_dtypes, device, reps, verbose: bool = True) -> int:
    tuned = 0
    for wd in weight_dtypes:
        tuner = KernelAutotuner(cache, vae_cfg, weight_dtype=wd,
                                device=device, reps=reps)
        for b in buckets:
            tuner.note_bucket(b, latent_hwc)
        while tuner.pending:
            for key in tuner.step(4):
                e = cache.get(key)
                tuned += 1
                if verbose:
                    knob = KNOBS[key.split("|")[0]][0]
                    speed = e["default_us"] / max(e["us"], 1e-9)
                    print(f"  {key}: {knob}={e[knob]} of "
                          f"{e['candidates']} {e['us']:.0f}us "
                          f"({speed:.2f}x vs default)")
    return tuned


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="Offline kernel pre-tuner for the decode's conv "
                    "kernels (persists winners to a versioned tuning cache "
                    "that StoreConfig.data_dir picks up)")
    p.add_argument("--cache", default=os.path.join("artifacts",
                                                   CACHE_FILENAME))
    p.add_argument("--smoke", action="store_true",
                   help="small grid: demo decoder, buckets 1/2, "
                        "float32+bfloat16, 1 rep")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default; raises without one) or cpu (the "
                        "plain versions, which take no knobs)")
    p.add_argument("--buckets", type=int, nargs="+", default=None)
    p.add_argument("--latent", type=int, nargs=3, default=None,
                   metavar=("H", "W", "C"))
    p.add_argument("--weight-dtypes", nargs="+", default=None,
                   choices=("float32", "bfloat16", "int8"))
    p.add_argument("--reps", type=int, default=None)
    args = p.parse_args(argv)

    from repro_torch.device import resolve_device
    from repro_torch.vae.model import DEMO_VAE as vae_cfg
    device = resolve_device(args.device)
    if args.smoke:
        buckets = args.buckets or (1, 2)
        wdtypes = args.weight_dtypes or ("float32", "bfloat16")
        reps = args.reps or 1
    else:
        buckets = args.buckets or (1, 2, 4, 8)
        wdtypes = args.weight_dtypes or ("float32", "bfloat16", "int8")
        reps = args.reps or 3
    latent = tuple(args.latent or (8, 8, 4))

    cache = TuningCache.load(args.cache)
    print(f"tuning {vae_cfg.name} decoder @ latent {latent}, "
          f"buckets {tuple(buckets)}, weight_dtypes {tuple(wdtypes)}, "
          f"device={device_name(device)} ({len(cache)} cached entries "
          f"loaded)")
    n = _cli_sweep(cache, vae_cfg, latent, buckets, wdtypes, device, reps)
    cache.save()
    print(f"tuned {n} new keys -> {args.cache} ({len(cache)} total)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
