#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's read path, its write and regeneration
path and its LM serving path on one NVIDIA GPU and hold every Hopper
kernel against its plain PyTorch version.

    python3 chip_smoke.py                    # needs one GPU and nvcc

Phases, each printing one JSON line (any failure exits non-zero):

1. device       card name and power limit, torch/CUDA versions, the
                kernels' build from ``src/repro_torch/kernels/csrc``;
2. kernels      each kernel against its plain version on the card at the
                shapes that one 512x512 uint8 decode, one encode and one
                float decode of the SD3.5-width VAE give it, and at the
                Qwen2-7B prefill's and decode step's attention shapes (bf16
                and fp32, with a sliding-window case): max error and
                tolerance, median ms (CUDA events; for the LM shapes the
                kernels' device time under ``torch.profiler``), the plain
                version's ms, a library call's ms, FLOPs, bytes and the
                bound; then the totals of each pass, and the plain
                ``downsample``'s ms per encode;
3. invariance   a bucket-8 decode bit-identical to eight batch-1 decodes;
4. slice        the read path: ``LatentBox.engine(device="cuda")`` at
                SD3.5-VAE width serving seeded Zipf requests of latent
                puts: hit classes, decodes, batches, per-image decode ms
                per bucket, and each of its kernels' launches (all > 0);
5. write        the write and regeneration path: recipe and uint8-image
                puts at 512x512, demotions, seeded Zipf requests; the
                regenerated reads, their blobs byte-identical to the first
                puts, their pixels equal to a direct decode, each kernel's
                launches (all > 0), encode device ms, median regen ms, and
                one read through a float32-pixel box against ``decode``;
6. crossdevice  the same VAE at a 16x16 latent and a 128x128 image on the
                GPU and on the CPU (the plain path): uint8 within +-1 LSB,
                float trunk, float decode and encoder mean within a
                relative tolerance; and a small fp32 qwen2-family LM's
                prefill and decode steps, logits within a relative
                tolerance;
7. lm           the LM serving path: ``build_model`` of Qwen2-7B at full
                width and depth in bf16 (seeded random weights), a prefill
                of 4 x 2048 seeded tokens, 64 greedy ``decode_step``s:
                parameters, peak memory, prefill and decode-step ms and
                tokens/s, each attention kernel's launches (one per layer
                and pass), and decode-after-prefill logits against a
                prefill one token longer.

Then a ``{"kernels": [...]}`` summary line (times summed over one uint8
decode, one encode and one float decode of a 512x512 image, one Qwen2-7B
prefill and one decode step; launches summed over the slice, write and lm
phases), the ``nvidia-smi`` name and power-limit line, and as the last
line ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count":
...}}``.  Full lines also go to ``chiprun_out/chip_smoke.jsonl``.  The
script imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import gc
import json
import statistics
from collections import Counter
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
REPS = 10                 # timed runs per kernel measurement
LATENT_HW = 64            # 64x64x16 latent -> 512x512 image
SLICE_OBJECTS = 48
SLICE_REQUESTS = 160
SLICE_WINDOW = 8
WRITE_RECIPES = 24        # objects put by recipe (oids 0-23)
WRITE_IMAGES = 8          # objects put as uint8 pixels (oids 24-31)
WRITE_DEMOTED = tuple(range(0, 16, 2))    # recipe objects left recipe-only
WRITE_REQUESTS = 96
LM_ARCH = "qwen2-7b"
LM_BATCH = 4
LM_PROMPT = 2048          # prompt tokens per sequence
LM_MAX_LEN = 2112         # KV-cache slots: prompt + 64 steps
LM_STEPS = 64             # greedy decode steps
LM_WINDOW = 512           # the sliding-window kernel case
DECODE_LENGTHS = (2049, 2080, 1500, 7)    # ragged cache lengths, one step
VAE_PASSES = ("decode", "encode", "float_decode")
PASSES = VAE_PASSES + ("lm_prefill", "lm_decode_step")

#: kernel -> (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "conv3x3": ("src/repro_torch/kernels/csrc/conv3x3.cu",
                "src/repro/kernels/conv3x3.py:76"),
    "gn_silu_conv3x3": ("src/repro_torch/kernels/csrc/conv3x3.cu",
                        "src/repro/kernels/gn_silu_conv.py:84"),
    "upsample_conv3x3": ("src/repro_torch/kernels/csrc/upsample_conv.cu",
                         "src/repro/kernels/upsample_conv.py:102"),
    "output_epilogue": ("src/repro_torch/kernels/csrc/conv3x3.cu",
                        "src/repro/kernels/output_epilogue.py:82"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:78"),
    "group_norm_silu": ("src/repro_torch/kernels/csrc/gn_silu.cu",
                        "src/repro/kernels/gn_silu.py:63"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:62"),
}


class SmokeFailure(RuntimeError):
    pass


def emit(log, phase: str, **fields) -> None:
    line = json.dumps({"phase": phase, **fields})
    print(line, flush=True)
    log.write(line + "\n")
    log.flush()


def need(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def card_peaks(name: str):
    """(fp32 FLOP/s outside the tensor cores, HBM bytes/s, description,
    dense bf16 tensor-core FLOP/s) of the part, from NVIDIA's data sheets,
    read off the device name."""
    if "PCIe" in name:
        return (51e12, 2.0e12, "H100 PCIe: 51 TFLOP/s fp32, 756 TFLOP/s "
                "bf16 dense tensor, 2.0 TB/s", 756e12)
    if "NVL" in name:
        return (60e12, 3.9e12, "H100 NVL: 60 TFLOP/s fp32, 835 TFLOP/s bf16 "
                "dense tensor, 3.9 TB/s", 835e12)
    return (67e12, 3.35e12, "H100 SXM: 67 TFLOP/s fp32, 989 TFLOP/s bf16 "
            "dense tensor, 3.35 TB/s", 989e12)


# ---------------------------------------------------------------------------
# the decode's kernel calls, derived from the config like _decode_trunk
# ---------------------------------------------------------------------------

def decode_calls(cfg, latent_hw: int):
    """[(kernel, shape args)] of one decode of one image, in order."""
    chs = cfg.block_out_channels
    top, s = chs[-1], latent_hw
    calls = [("conv3x3", (s, s, cfg.latent_channels, top))]
    calls += [("gn_silu_conv3x3", (s, s, top, top))] * 2
    calls += [("flash_attention", (s * s, top))]
    calls += [("gn_silu_conv3x3", (s, s, top, top))] * 2
    cin = top
    for i, cout in enumerate(reversed(chs)):
        for _ in range(cfg.layers_per_block + 1):
            calls += [("gn_silu_conv3x3", (s, s, cin, cout)),
                      ("gn_silu_conv3x3", (s, s, cout, cout))]
            cin = cout
        if i < len(chs) - 1:
            calls.append(("upsample_conv3x3", (s, s, cout, cout)))
            s *= 2
    calls.append(("output_epilogue", (s, s, chs[0], cfg.image_channels)))
    return calls


def float_decode_calls(cfg, latent_hw: int):
    """The float ``decode``: the same trunk, then the standalone GroupNorm
    + SiLU and ``conv_out`` in place of the fused epilogue."""
    calls = decode_calls(cfg, latent_hw)
    _, (s, _, c0, cout) = calls.pop()
    return calls + [("group_norm_silu", (s, s, c0, c0)),
                    ("conv3x3", (s, s, c0, cout))]


def encode_calls(cfg, image_hw: int):
    """[(kernel or "downsample", shape args)] of one encode of one image,
    in order, derived from the config like ``vae.model.encode``."""
    chs = cfg.block_out_channels
    s = image_hw
    calls = [("conv3x3", (s, s, cfg.image_channels, chs[0]))]
    cin = chs[0]
    for i, cout in enumerate(chs):
        for _ in range(cfg.layers_per_block):
            calls += [("gn_silu_conv3x3", (s, s, cin, cout)),
                      ("gn_silu_conv3x3", (s, s, cout, cout))]
            cin = cout
        if i < len(chs) - 1:
            calls.append(("downsample", (s, s, cout, cout)))
            s //= 2
    top = chs[-1]
    calls += [("gn_silu_conv3x3", (s, s, top, top))] * 2
    calls += [("flash_attention", (s * s, top))]
    calls += [("gn_silu_conv3x3", (s, s, top, top))] * 2
    calls += [("group_norm_silu", (s, s, top, top)),
              ("conv3x3", (s, s, top, 2 * cfg.latent_channels))]
    return calls


def work(kernel: str, args):
    """(FLOPs, bytes) one image's call needs: each input read once, each
    output written once; the upsampler counted in its phase form (16 taps
    over H*W, the least work known for the function), the downsampler as
    a stride-2 conv (9 taps over its H*W/4 outputs)."""
    if kernel == "flash_attention":
        s, d = args
        return 4.0 * s * s * d, 4.0 * 4 * s * d
    h, w, cin, cout = args
    px = h * w
    if kernel == "group_norm_silu":
        return 10.0 * px * cin, 4.0 * (2 * px * cin + 2 * cin)
    if kernel == "downsample":
        opx = ((h - 2) // 2 + 1) * ((w - 2) // 2 + 1)
        return (2.0 * opx * 9 * cin * cout,
                4.0 * (px * cin + 9 * cin * cout + cout + opx * cout))
    if kernel == "upsample_conv3x3":
        return (2.0 * px * 16 * cin * cout,
                4.0 * (px * cin + 9 * cin * cout + cout + 4 * px * cout))
    flops = 2.0 * px * 9 * cin * cout
    out_bytes = (1 if kernel == "output_epilogue" else 4) * px * cout
    if kernel != "conv3x3":
        flops += 10.0 * px * cin          # statistics, normalise, SiLU
    in_bytes = 4.0 * (px * cin + 9 * cin * cout + cout + 2 * cin)
    return flops, in_bytes + out_bytes


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def cuda_ms(torch, fn, reps: int) -> float:
    """Median ms of ``fn`` over ``reps`` runs, each between CUDA events,
    after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(torch, log, state):
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    secs = build.build_all()
    wall = time.perf_counter() - t0
    report = {n: build.ptxas_report(n) for n in build.SOURCES}
    (OUT_DIR / "ptxas.json").write_text(json.dumps(report, indent=1))
    name = torch.cuda.get_device_name(0)
    state["smi"] = nvidia_smi("name,power.limit")
    state["peaks"] = card_peaks(name)
    emit(log, "device", nvidia_smi=state["smi"], name=name,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, build_wall_s=wall, build_s=secs,
         peaks=state["peaks"][2],
         ptxas={n: [ln for ln in v if "Used" in ln]
                for n, v in report.items()})


def kernel_inputs(torch, kernel, args, gen):
    """Seeded inputs of one image's call on the card."""
    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    if kernel == "flash_attention":
        s, d = args
        return [randn(1, 1, s, d) for _ in range(3)]
    h, w, cin, cout = args
    x = randn(1, h, w, cin)
    if kernel == "group_norm_silu":
        return [x, 1.0 + randn(cin, scale=0.1), randn(cin, scale=0.1)]
    wt = randn(3, 3, cin, cout, scale=(9 * cin) ** -0.5)
    b = randn(cout, scale=0.1)
    if kernel in ("conv3x3", "upsample_conv3x3"):
        return [x, wt, b]
    gamma = 1.0 + randn(cin, scale=0.1)
    beta = randn(cin, scale=0.1)
    if kernel == "output_epilogue":
        wt = wt * 0.35                 # keep most pixels off the clamp
    return [x, gamma, beta, wt, b]


def phase_kernels(torch, log, state):
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.gn_silu_conv import gn_stats
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.vae.model import SD35_VAE
    groups = SD35_VAE.groups
    wrappers = {
        "conv3x3": lambda a: ops.conv3x3(*a),
        "gn_silu_conv3x3": lambda a: ops.gn_silu_conv3x3(*a, groups=groups),
        "upsample_conv3x3": lambda a: ops.upsample_conv3x3(*a),
        "output_epilogue": lambda a: ops.output_epilogue(*a, groups=groups),
        "flash_attention": lambda a: ops.flash_attention(*a),
        "group_norm_silu": lambda a: ops.group_norm_silu(*a, groups=groups),
    }
    plains = {
        "conv3x3": lambda a: ref.conv3x3_ref(*a),
        "gn_silu_conv3x3": lambda a: ref.gn_silu_conv3x3_ref(*a, groups),
        "upsample_conv3x3": lambda a: ref.upsample_conv3x3_ref(*a),
        "output_epilogue": lambda a: ref.output_epilogue_ref(*a, groups),
        "flash_attention": lambda a: ref.flash_attention_ref(*a),
        "group_norm_silu": lambda a: ref.group_norm_silu_ref(*a, groups),
    }

    def library(kernel, a):
        """PyTorch's own calls for the same work: F.conv2d (TF32 off) on
        the conv's own input (normalised, or upsampled, outside the
        timing) for the convs, scaled_dot_product_attention for attention,
        F.group_norm then F.silu on the channels-last view for the
        standalone GroupNorm + SiLU."""
        if kernel == "flash_attention":
            return lambda: F.scaled_dot_product_attention(*a)
        if kernel == "group_norm_silu":
            xc = a[0].permute(0, 3, 1, 2)
            return lambda: F.silu(F.group_norm(xc, groups, a[1], a[2], 1e-6))
        x, wt, b = a[0], a[-2], a[-1]
        if kernel in ("gn_silu_conv3x3", "output_epilogue"):
            x = ref.group_norm_silu_ref(x, a[1], a[2], groups)
        if kernel == "upsample_conv3x3":
            x = x.repeat_interleave(2, 1).repeat_interleave(2, 2)
        xc = x.permute(0, 3, 1, 2)                    # NHWC as channels_last
        wc = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        return lambda: F.conv2d(xc, wc, b, padding=1)

    image_hw = 8 * LATENT_HW
    passes = {"decode": decode_calls(SD35_VAE, LATENT_HW),
              "encode": encode_calls(SD35_VAE, image_hw),
              "float_decode": float_decode_calls(SD35_VAE, LATENT_HW)}
    # (kernel, shape) -> calls in each pass, in first-seen order
    checks = {}
    for name, calls in passes.items():
        for key, n in Counter(c for c in calls if c[0] in KERNELS).items():
            checks.setdefault(key, dict.fromkeys(VAE_PASSES, 0))[name] = n
    # attention also at a 1024x1024 image's 16,384 tokens (checked, not
    # part of any pass's totals)
    top = SD35_VAE.block_out_channels[-1]
    checks.setdefault(("flash_attention", (16384, top)),
                      dict.fromkeys(VAE_PASSES, 0))
    gen = torch.Generator(device="cuda").manual_seed(1234)
    flop_peak, byte_peak = state["peaks"][:2]
    totals = {p: {k: dict.fromkeys(TOTAL_FIELDS, 0.0) for k in KERNELS}
              for p in PASSES}
    max_err = dict.fromkeys(KERNELS, 0.0)
    for (kernel, args), per_pass in checks.items():
        a = kernel_inputs(torch, kernel, args, gen)
        got = wrappers[kernel](a)
        want = plains[kernel](a)
        torch.cuda.synchronize()
        need(tuple(got.shape) == tuple(want.shape) and got.dtype == want.dtype,
             f"{kernel}{args}: kernel gives {tuple(got.shape)} {got.dtype}, "
             f"plain {tuple(want.shape)} {want.dtype}")
        need(bool(torch.isfinite(got.float()).all()), f"{kernel}{args}: "
             "non-finite output")
        if kernel == "output_epilogue":
            err = float((got.int() - want.int()).abs().max())
            tol, why = 1.0, ("uint8 +-1 LSB: only the fp32 sum order differs, "
                             "which can move a value across a rounding edge")
        else:
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            tol = 1e-4 * max(1.0, scale)
            why = ("fp32 with another summation order (up to 9*Cin or d "
                   "terms, or a group's statistics): 1e-4 relative to the "
                   "output's max")
        need(err <= tol, f"{kernel}{args}: max error {err} > {tol}")
        ms = cuda_ms(torch, lambda: wrappers[kernel](a), REPS)
        plain_ms = cuda_ms(torch, lambda: plains[kernel](a), REPS)
        lib_ms = cuda_ms(torch, library(kernel, a), REPS)
        flops, nbytes = work(kernel, args)
        extra = {}
        if kernel == "group_norm_silu":
            # its first pass alone: how the time splits between the two
            extra["stats_pass_ms"] = cuda_ms(
                torch, lambda: gn_stats(a[0], groups, 1e-6), REPS)
        row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, flops=flops,
                   ops_ms=flops / flop_peak * 1e3, bytes=nbytes)
        emit(log, "kernel", name=kernel, shape=list(args), calls=per_pass,
             max_abs_err=err, tol=tol, tol_reason=why, **row,
             bound_ms=with_bound(dict(row), byte_peak)["bound_ms"],
             tflops=flops / ms / 1e9, **extra)
        max_err[kernel] = max(max_err[kernel], err)
        add_to_totals(totals, kernel, per_pass, row)
        del a, got, want
        torch.cuda.empty_cache()
    lm_attention_checks(torch, log, state, totals, max_err)
    for per_kernel in totals.values():
        for t in per_kernel.values():
            with_bound(t, byte_peak)
    down = time_downsample(torch, log, state, passes["encode"])
    for p in PASSES:
        extra = {"plain_downsample": down} if p == "encode" else {}
        if p in VAE_PASSES:
            extra["image"] = [image_hw] * 2
        emit(log, f"kernels_per_{p}",
             total_flops=sum(t["flops"] for t in totals[p].values()),
             total_ms=sum(t["ms"] for t in totals[p].values()),
             totals=totals[p], **extra)
    # the summary line: one uint8 decode + one encode + one float decode +
    # one LM prefill + one LM decode step
    summ = {}
    for k in KERNELS:
        t = {f: sum(totals[p][k][f] for p in PASSES) for f in TOTAL_FIELDS}
        summ[k] = with_bound(t, byte_peak)
        summ[k]["max_abs_err"] = max_err[k]
    state["kernel_totals"] = summ


#: what each pass's per-kernel totals sum (``ops_ms``: FLOPs over the peak
#: of their type, so bf16 and fp32 work add up)
TOTAL_FIELDS = ("ms", "plain_ms", "library_ms", "flops", "ops_ms", "bytes",
                "calls")


def add_to_totals(totals, kernel, per_pass, row):
    for p, n in per_pass.items():
        t = totals[p][kernel]
        for f in TOTAL_FIELDS:
            t[f] += n * (1 if f == "calls" else row[f])


def with_bound(t, byte_peak):
    """Add the least time (ms) the card needs for ``t``'s operations
    (``ops_ms``, at the peak of their type) and bytes, and which of the
    two bounds it."""
    t_ops, t_bytes = t["ops_ms"], t["bytes"] / byte_peak * 1e3
    t["bound_ms"] = max(t_ops, t_bytes)
    t["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return t


def time_downsample(torch, log, state, encode):
    """The encoder's strided downsamplers, plain tensor code (nine strided
    fp32 matmuls per image, TF32 off): ms per shape and per encode."""
    from repro_torch.vae import layers as L
    gen = torch.Generator(device="cuda").manual_seed(4321)
    flop_peak, byte_peak = state["peaks"][:2]
    total = {"ms": 0.0, "flops": 0.0, "ops_ms": 0.0, "bytes": 0.0, "calls": 0}
    for args, n in Counter(a for k, a in encode if k == "downsample").items():
        h, w, c, _ = args
        x = torch.randn((1, h, w, c), generator=gen, device="cuda")
        p = {"conv": {"w": torch.randn((3, 3, c, c), generator=gen,
                                       device="cuda") * (9 * c) ** -0.5,
                      "b": torch.zeros(c, device="cuda")}}
        ms = cuda_ms(torch, lambda: L.downsample(x, p), REPS)
        flops, nbytes = work("downsample", args)
        emit(log, "downsample", shape=list(args), calls_per_encode=n, ms=ms,
             flops=flops, bytes=nbytes,
             bound_ms=max(flops / flop_peak, nbytes / byte_peak) * 1e3,
             tflops=flops / ms / 1e9)
        total["ms"] += n * ms
        total["flops"] += n * flops
        total["ops_ms"] += n * flops / flop_peak * 1e3
        total["bytes"] += n * nbytes
        total["calls"] += n
    return with_bound(total, byte_peak)


# ---------------------------------------------------------------------------
# the LM's attention kernels
# ---------------------------------------------------------------------------

def lm_attention_cases(cfg):
    """[(kernel, shape, dtype name, calls per pass)] at the shapes the
    Qwen2-7B serving run gives the attention kernels: the causal prefill
    of 4 x 2048 tokens (28 calls per prefill), the same with a 512-token
    window (checked, in no pass), and one decode step against a cache of
    2112 slots with ragged lengths (28 calls per step); bf16 (the model's
    type) and fp32 (checked, in no pass)."""
    n, hq, hkv, d = LM_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cases = []
    for dt in ("bfloat16", "float32"):
        main = dt == "bfloat16"
        prefill = dict(n=n, hq=hq, hkv=hkv, sq=LM_PROMPT, skv=LM_PROMPT, d=d,
                       causal=True)
        cases.append(("flash_attention", dict(prefill, window=None), dt,
                      {"lm_prefill": cfg.n_layers} if main else {}))
        cases.append(("flash_attention", dict(prefill, window=LM_WINDOW), dt,
                      {}))
        cases.append(("decode_attention",
                      dict(n=n, hq=hq, hkv=hkv, s=LM_MAX_LEN, d=d,
                           lengths=list(DECODE_LENGTHS)), dt,
                      {"lm_decode_step": cfg.n_layers} if main else {}))
    return cases


def attention_work(kernel, shape, elt):
    """(FLOPs, bytes) the call needs: 4 d FLOPs per (query, kept key) pair
    (q k^T and p v), each input read once and the output written once; the
    decode counts the cache rows below each length only."""
    d, hq, hkv = shape["d"], shape["hq"], shape["hkv"]
    if kernel == "decode_attention":
        rows = sum(shape["lengths"])
        return (4.0 * d * hq * rows,
                elt * (2 * shape["n"] * hq * d + 2 * hkv * rows * d)
                + 4 * shape["n"])
    sq, skv, w = shape["sq"], shape["skv"], shape["window"]
    pairs = 0
    for i in range(sq):
        qpos = i + skv - sq
        hi = min(skv, qpos + 1) if shape["causal"] else skv
        lo = max(0, qpos - w + 1) if w else 0
        pairs += max(0, hi - lo)
    n = shape["n"]
    return (4.0 * d * hq * n * pairs,
            elt * n * (2 * hq * sq * d + 2 * hkv * skv * d))


def lm_attention_checks(torch, log, state, totals, max_err):
    """Each LM attention case: kernel against its plain version on the
    same inputs (TF32 off), then median ms of the kernel, the plain
    version and ``F.scaled_dot_product_attention``."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    cfg = get_config(LM_ARCH)
    flop_peak, byte_peak, _, bf16_peak = state["peaks"]
    gen = torch.Generator(device="cuda").manual_seed(2024)
    for kernel, shape, dt, per_pass in lm_attention_cases(cfg):
        dtype = getattr(torch, dt)
        n, hq, hkv, d = shape["n"], shape["hq"], shape["hkv"], shape["d"]
        if kernel == "flash_attention":
            dims = [(n, hq, shape["sq"], d)] + [(n, hkv, shape["skv"], d)] * 2
        else:
            dims = [(n, hq, d)] + [(n, hkv, shape["s"], d)] * 2
        q, k, v = (torch.randn(s_, generator=gen, device="cuda").to(dtype)
                   for s_ in dims)
        if kernel == "flash_attention":
            kw = dict(causal=shape["causal"], window=shape["window"])
            run = lambda: ops.flash_attention(q, k, v, **kw)       # noqa: E731
            plain = lambda: ref.flash_attention_ref(q, k, v, **kw)  # noqa: E731
            if shape["window"] is None:
                lib = lambda: F.scaled_dot_product_attention(       # noqa: E731
                    q, k, v, is_causal=True, enable_gqa=True)
            else:
                pos = torch.arange(shape["sq"], device="cuda")
                mask = (pos[None, :] <= pos[:, None]) & \
                    (pos[None, :] > pos[:, None] - shape["window"])
                lib = lambda: F.scaled_dot_product_attention(       # noqa: E731
                    q, k, v, attn_mask=mask, enable_gqa=True)
        else:
            lens = torch.tensor(shape["lengths"], device="cuda")
            run = lambda: ops.decode_attention(q, k, v, lens)      # noqa: E731
            plain = lambda: ref.decode_attention_ref(q, k, v, lens)  # noqa: E731
            mask = (torch.arange(shape["s"], device="cuda")[None, :]
                    < lens[:, None])[:, None, None, :]
            lib = lambda: F.scaled_dot_product_attention(           # noqa: E731
                q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)
        got, want = run(), plain()
        torch.cuda.synchronize()
        label = f"{kernel}[{dt}]{shape}"
        need(got.shape == want.shape and got.dtype == want.dtype == dtype,
             f"{label}: kernel gives {tuple(got.shape)} {got.dtype}")
        need(bool(torch.isfinite(got.float()).all()),
             f"{label}: non-finite output")
        err = float((got.float() - want.float()).abs().max())
        rel = 1e-4 if dtype == torch.float32 else 1e-2
        tol = rel * float(want.float().abs().max())
        need(err <= tol, f"{label}: max error {err} > {tol}")
        # a decode call's kernels take tens of microseconds, less than the
        # host needs to issue the wrapper, so CUDA events around one call
        # time the host; the profiler's device time is the kernels' own
        times, event = {}, {}
        for key, fn in (("ms", run), ("plain_ms", plain), ("library_ms", lib)):
            try:
                event[key] = cuda_ms(torch, fn, REPS)
                times[key] = device_ms(torch, fn, REPS) or event[key]
            except RuntimeError as exc:  # no SDPA backend for this case
                if key != "library_ms":
                    raise
                times[key] = event[key] = None
                event["library_note"] = str(exc).splitlines()[0][:200]
        flops, nbytes = attention_work(kernel, shape, q.element_size())
        peak = bf16_peak if dtype == torch.bfloat16 else flop_peak
        row = dict(times, flops=flops, ops_ms=flops / peak * 1e3,
                   bytes=nbytes)
        emit(log, "kernel", name=kernel, dtype=dt, shape=shape,
             calls=per_pass, max_abs_err=err, tol=tol,
             tol_reason=(f"{rel:g} relative to the output's max: fp32 "
                         "softmax and sums in another order"
                         + ("; bf16 output rounding" if rel > 1e-4 else "")),
             **row, timing="device time (torch.profiler), per call",
             event_times=event,
             bound_ms=with_bound(dict(row), byte_peak)["bound_ms"],
             peak_tflops=peak / 1e12, tflops=flops / row["ms"] / 1e9)
        row["library_ms"] = row["library_ms"] or 0.0
        max_err[kernel] = max(max_err[kernel], err)
        add_to_totals(totals, kernel, per_pass, row)
        del q, k, v, got, want
        torch.cuda.empty_cache()


def sd35_vae(torch, device):
    from repro_torch.vae.model import SD35_VAE, VAE, calibrate_output_range
    vae = VAE(SD35_VAE, seed=0, device=device)
    gain = calibrate_output_range(vae)
    return vae, gain


def phase_invariance(torch, log, state):
    vae = state.setdefault("vae", sd35_vae(torch, "cuda"))[0]
    rng = state["np"].random.default_rng(5)
    z = rng.standard_normal((8, LATENT_HW, LATENT_HW, 16)).astype("float32")
    batch = vae.decode_u8(z).cpu()
    singles = [vae.decode_u8(z[i:i + 1]).cpu() for i in range(8)]
    same = [bool(torch.equal(batch[i:i + 1], singles[i])) for i in range(8)]
    need(all(same), f"bucket 8 differs from batch-1 decodes: {same}")
    need(tuple(batch.shape) == (8, 8 * LATENT_HW, 8 * LATENT_HW, 3),
         f"decode shape {tuple(batch.shape)}")
    emit(log, "invariance", bucket=8, bit_identical=same,
         image_std=float(batch.float().std()))


def phase_slice(torch, log, state):
    np = state["np"]
    from repro_torch.core.tuner import TunerConfig
    from repro_torch.kernels import ops
    from repro_torch.store import LatentBox, StoreConfig
    vae, gain = state.setdefault("vae", sd35_vae(torch, "cuda"))
    side = 8 * LATENT_HW
    image_bytes = float(side * side * 3)
    rng = np.random.default_rng(11)
    latents = [rng.standard_normal((LATENT_HW, LATENT_HW, 16))
               .astype(np.float16) for _ in range(SLICE_OBJECTS)]
    ranks = np.arange(1, SLICE_OBJECTS + 1, dtype=np.float64)
    p = ranks ** -1.1
    trace = [int(t) for t in rng.choice(SLICE_OBJECTS, SLICE_REQUESTS,
                                        p=p / p.sum())]
    # two nodes of 6 MB: a few decoded images and a dozen latents each, so
    # both tiers evict; the tuner window never fires (deterministic classes)
    cfg = StoreConfig(n_nodes=2, cache_bytes_per_node=6e6,
                      image_bytes=image_bytes, latent_bytes=1.2e5,
                      promote_threshold=2, tuner=TunerConfig(window=10**9),
                      decode_buckets=(1, 2, 4, 8))
    box = LatentBox.engine(vae=vae, config=cfg, device="cuda")
    t0 = time.perf_counter()
    box.backend.engine.prewarm_decode((LATENT_HW, LATENT_HW, 16))
    prewarm_s = time.perf_counter() - t0
    for oid, z in enumerate(latents):
        box.put(oid, latent=z)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = []
    for s in range(0, len(trace), SLICE_WINDOW):
        results += box.get_many(trace[s:s + SLICE_WINDOW])
    serve_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    state["launches"] = {"slice": launches}
    path = {k for k, _ in decode_calls(vae.cfg, LATENT_HW)}
    need(all(launches[k] > 0 for k in path),
         f"a kernel of the read path was never launched: {launches}")
    for r in results:
        need(r.payload is not None and r.payload.shape == (side, side, 3)
             and r.payload.dtype == np.uint8, f"bad payload for {r.oid}")
    # served pixels are the direct batch-1 decode's, bit for bit
    for oid in sorted(set(trace))[:3]:
        direct = vae.decode_u8(latents[oid][None].astype(np.float32))[0].cpu()
        served = next(r.payload for r in results if r.oid == oid)
        need(bool(np.array_equal(direct.numpy(), served)),
             f"served pixels of {oid} differ from a direct decode")
    summ = box.summary()
    eng = box.backend.engine
    hits = {}
    for r in results:
        hits[r.hit_class] = hits.get(r.hit_class, 0) + 1
    # host wall clock of each served batch (dispatch to pixels on the host),
    # per real image, as the engine feeds its tuner
    served_ms = {str(b): {
        "batches": len(v), "real_images": sum(n for _, n in v),
        "median_batch_ms": statistics.median(ms for ms, _ in v),
        "median_per_image_ms": statistics.median(ms / n for ms, n in v)}
        for b, v in sorted(eng.batcher.bucket_ms.items())}
    # device time of a full bucket, CUDA events around decode_u8
    zero = np.zeros((LATENT_HW, LATENT_HW, 16), np.float32)
    device_ms = {}
    for b in cfg.decode_buckets:
        zb = torch.from_numpy(np.stack([zero] * b)).cuda()
        ms = cuda_ms(torch, lambda: vae.decode_u8(zb), 3)
        device_ms[str(b)] = {"batch_ms": ms, "per_image_ms": ms / b}
    emit(log, "slice", image=[side, side], objects=SLICE_OBJECTS,
         requests=SLICE_REQUESTS, window=SLICE_WINDOW,
         decoder_params=vae.decoder_params, calibration_gain=gain,
         prewarm_s=prewarm_s, serve_s=serve_s, hit_classes=hits,
         distinct_objects=len(set(trace)),
         pixel_cached_objects=summ["pixel_cached_objects"],
         decodes=summ["decodes"], batches=summ["decode_batches"],
         coalesced=summ["coalesced_decodes"],
         padded_slots=eng.batcher.stats["padded_slots"],
         served_decode_ms=served_ms, device_decode_ms=device_ms,
         launches=launches,
         image_mean=float(np.mean([r.payload.mean() for r in results])))


def phase_write(torch, log, state):
    """The write and regeneration path at SD3.5-VAE width: recipe and
    uint8-image puts, demotions, then a seeded Zipf trace in windows."""
    np = state["np"]
    from repro_torch.compression.latentcodec import decompress_latent
    from repro_torch.core.regen_tier import Recipe
    from repro_torch.core.tuner import TunerConfig
    from repro_torch.kernels import ops
    from repro_torch.store import LatentBox, StoreConfig
    from repro_torch.vae.model import param_count
    vae = state.setdefault("vae", sd35_vae(torch, "cuda"))[0]
    side = 8 * LATENT_HW
    rng = np.random.default_rng(17)
    n = WRITE_RECIPES + WRITE_IMAGES
    images = [rng.integers(0, 256, (side, side, 3), dtype=np.uint8)
              for _ in range(WRITE_IMAGES)]
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** -1.1
    trace = [int(t) for t in rng.choice(n, WRITE_REQUESTS, p=p / p.sum())]

    def cfg(**kw):
        return StoreConfig(n_nodes=2, cache_bytes_per_node=6e6,
                           image_bytes=float(side * side * 3),
                           latent_bytes=1.2e5, promote_threshold=2,
                           tuner=TunerConfig(window=10**9),
                           decode_buckets=(1, 2, 4, 8), **kw)

    box = LatentBox.engine(vae=vae, config=cfg(), device="cuda")
    store = box.backend.store
    box.backend.engine.prewarm_decode((LATENT_HW, LATENT_HW, 16))
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blobs, put_ms = {}, {"recipe": [], "image": []}
    for oid in range(n):
        t1 = time.perf_counter()
        if oid < WRITE_RECIPES:
            box.put(oid, recipe=Recipe(seed=1000 + oid, height=side,
                                       width=side, scale=0.5))
            put_ms["recipe"].append((time.perf_counter() - t1) * 1e3)
        else:
            box.put(oid, image=images[oid - WRITE_RECIPES])
            put_ms["image"].append((time.perf_counter() - t1) * 1e3)
        blobs[oid] = store.get(oid)
    put_s = time.perf_counter() - t0
    for oid in WRITE_DEMOTED:
        need(box.demote(oid), f"demote({oid}) refused")
        need(store.get(oid) is None, f"{oid} kept its blob after demote")
    t0 = time.perf_counter()
    results = []
    for s in range(0, len(trace), SLICE_WINDOW):
        results += box.get_many(trace[s:s + SLICE_WINDOW])
    serve_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    state["launches"]["write"] = launches
    path = {k for k, _ in decode_calls(vae.cfg, LATENT_HW)
            + encode_calls(vae.cfg, side)} & set(KERNELS)
    need(all(launches[k] > 0 for k in path),
         f"a kernel of the write path was never launched: {launches}")
    for r in results:
        need(r.payload is not None and r.payload.shape == (side, side, 3)
             and r.payload.dtype == np.uint8, f"bad payload for {r.oid}")
    regen = [r for r in results if r.regenerated]
    need(len(regen) > 0, "no read was regenerated")
    regen_oids = sorted({r.oid for r in regen})
    for oid in regen_oids:
        need(oid in WRITE_DEMOTED, f"{oid} regenerated but never demoted")
        need(store.get(oid) == blobs[oid],
             f"regenerated blob of {oid} differs from its first put")
    # served pixels of a regenerated object equal a direct batch-1 decode
    for oid in regen_oids[:3]:
        z = np.asarray(decompress_latent(blobs[oid]), np.float32)[None]
        direct = vae.decode_u8(z)[0].cpu().numpy()
        served = next(r.payload for r in regen if r.oid == oid)
        need(bool(np.array_equal(direct, served)),
             f"served pixels of regenerated {oid} differ from a direct "
             "decode")
    # device time of one encode (batch 1), CUDA events around encode_mean
    x = torch.from_numpy(images[0].astype(np.float32) / 127.5 - 1.0)[None]
    x = x.cuda()
    encode_ms = cuda_ms(torch, lambda: vae.encode_mean(x), 3)
    # one read through a float32-pixel box, against vae.decode
    fbox = LatentBox.engine(vae=vae, config=cfg(pixel_format="float32"),
                            device="cuda")
    z16 = np.asarray(decompress_latent(blobs[WRITE_RECIPES]))
    fbox.put(0, latent=z16)
    fres = fbox.get(0)
    want = vae.decode(z16.astype(np.float32)[None])[0].cpu().numpy()
    need(fres.payload.dtype == np.float32 and fres.payload.shape ==
         (side, side, 3), f"float32 box payload {fres.payload.dtype} "
         f"{fres.payload.shape}")
    ferr = float(np.abs(fres.payload - want).max())
    need(ferr <= 1e-5, f"float32 box pixels differ from decode by {ferr}")
    hits = Counter(r.hit_class for r in results)
    emit(log, "write", image=[side, side], recipe_puts=WRITE_RECIPES,
         image_puts=WRITE_IMAGES, demoted=list(WRITE_DEMOTED),
         requests=WRITE_REQUESTS, window=SLICE_WINDOW,
         encoder_params=param_count(vae.encoder),
         put_s=put_s, serve_s=serve_s,
         median_put_ms={k: statistics.median(v) for k, v in put_ms.items()},
         hit_classes=dict(hits), regenerated=len(regen),
         regenerated_objects=regen_oids, regen_blobs_identical=True,
         regen_pixels_equal_direct_decode=True,
         median_regen_ms=statistics.median(r.latency_ms["regen"]
                                           for r in regen),
         median_regen_read_decode_ms=statistics.median(
             r.latency_ms["decode"] for r in regen),
         encode_device_ms=encode_ms, float32_get_max_abs_err=ferr,
         float32_get_bit_identical=ferr == 0.0, launches=launches)


def phase_crossdevice(torch, log, state):
    from repro_torch.vae.model import VAE, map_params
    vae = state.setdefault("vae", sd35_vae(torch, "cuda"))[0]
    cpu = VAE(vae.cfg, device="cpu",
              params=map_params(vae.decoder, lambda t: t.cpu()),
              encoder_params=map_params(vae.encoder, lambda t: t.cpu()))
    rng = state["np"].random.default_rng(13)
    z = rng.standard_normal((1, 16, 16, 16)).astype("float32")
    t_gpu = vae.decode_trunk(z).cpu()
    t_cpu = cpu.decode_trunk(z)
    rel = float((t_gpu - t_cpu).abs().max() / t_cpu.abs().max())
    u_gpu = vae.decode_u8(z).cpu()
    u_cpu = cpu.decode_u8(z)
    lsb = int((u_gpu.int() - u_cpu.int()).abs().max())
    f_gpu = vae.decode(z).cpu()
    f_cpu = cpu.decode(z)
    f_rel = float((f_gpu - f_cpu).abs().max() / f_cpu.abs().max())
    x = rng.uniform(-1, 1, (1, 128, 128, 3)).astype("float32")
    e_gpu = vae.encode_mean(x).cpu()
    e_cpu = cpu.encode_mean(x)
    e_rel = float((e_gpu - e_cpu).abs().max() / e_cpu.abs().max())
    need(tuple(u_gpu.shape) == (1, 128, 128, 3), f"shape {tuple(u_gpu.shape)}")
    need(tuple(e_gpu.shape) == (1, 16, 16, 16), f"shape {tuple(e_gpu.shape)}")
    need(rel <= 1e-4, f"float trunk differs by {rel} (relative) > 1e-4")
    need(lsb <= 1, f"uint8 decode differs by {lsb} LSB > 1")
    need(f_rel <= 1e-4, f"float decode differs by {f_rel} (relative) > 1e-4")
    need(e_rel <= 1e-4, f"encoder mean differs by {e_rel} (relative) > 1e-4")
    lm = crossdevice_lm(torch, state)
    emit(log, "crossdevice", latent=[16, 16, 16], image=[128, 128],
         trunk_rel_err=rel, float_decode_rel_err=f_rel,
         encode_mean_rel_err=e_rel, tol=1e-4,
         tol_reason="fp32 through 30 convs (decoder) or 22 (encoder), GN "
                    "and attention with other summation orders on the two "
                    "devices; relative to the output's max",
         u8_max_lsb=lsb, u8_tol=1, lm=lm)


def crossdevice_lm(torch, state):
    """A small fp32 qwen2-family LM (4 layers, d_model 512, 8 q heads over
    2 kv heads) on the card and on the CPU from the same weights: prefill
    of 2 x 45 tokens, then 4 decode steps; logits within 1e-4 of their max
    (TF32 off)."""
    import dataclasses
    from repro_torch.configs import build_model, get_config
    from repro_torch.models.lm import CausalLM
    from repro_torch.vae.model import map_params
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=4, d_model=512,
                              n_heads=8, n_kv_heads=2, d_ff=1024,
                              vocab_size=4096, dtype=torch.float32)
    gpu = build_model(cfg, device="cuda", seed=7)
    cpu = CausalLM(cfg, device="cpu",
                   params=map_params(gpu.params, lambda t: t.cpu()))
    toks = state["np"].random.default_rng(19).integers(0, cfg.vocab_size,
                                                       (2, 49))
    gl, gc = gpu.prefill(toks[:, :45], max_len=56)
    cl, cc = cpu.prefill(toks[:, :45], max_len=56)
    errs = []
    for t in range(45, 50):
        errs.append(float((gl.cpu() - cl).abs().max() / cl.abs().max()))
        need(errs[-1] <= 1e-4, f"small LM logits differ by {errs[-1]} "
             f"(relative) > 1e-4 at position {t}")
        if t < 49:
            gl, gc = gpu.decode_step(gc, toks[:, t])
            cl, cc = cpu.decode_step(cc, toks[:, t])
    k_rel = float((gc["k"].cpu() - cc["k"]).abs().max() / cc["k"].abs().max())
    need(k_rel <= 1e-4, f"small LM KV cache differs by {k_rel} > 1e-4")
    return {"config": {"n_layers": 4, "d_model": 512, "heads": [8, 2],
                       "d_ff": 1024, "vocab": 4096, "dtype": "float32"},
            "prompt": [2, 45], "decode_steps": 4,
            "logits_rel_err": errs, "kv_cache_rel_err": k_rel, "tol": 1e-4}


def device_ms(torch, fn, reps: int):
    """The device time (ms) of one call of ``fn``: its kernels' own time
    under ``torch.profiler``, averaged over ``reps`` calls (0 where the
    profiler sees no device activity)."""
    return profile_share(torch, fn, reps)["device_ms"]


def profile_share(torch, fn, steps: int):
    """Run ``fn`` ``steps`` times under ``torch.profiler``: wall ms per
    step (host clock, profiler on), device ms per step (the kernels' own
    time, as the profiler table's "Self CUDA" total sums it), their ratio,
    and the ten kernels with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()                                         # warm, outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    dev = [(e.key, e.self_device_time_total / 1e3 / steps, e.count // steps)
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    device = sum(ms for _, ms, _ in dev)
    top = sorted(dev, key=lambda r: -r[1])[:10]
    return {"steps": steps, "wall_ms": wall, "device_ms": device,
            "busy_share": device / wall if device > 0 else None,
            "device_launches": sum(n for _, _, n in dev),
            "top": [{"kernel": k[:90], "ms": ms, "count": n}
                    for k, ms, n in top]}


def phase_lm(torch, log, state):
    """The LM serving path at full Qwen2-7B width and depth in bf16: one
    prefill of 4 x 2048 seeded tokens, then 64 greedy decode steps; then
    decode-after-prefill logits against a prefill one token longer."""
    np = state["np"]
    from repro_torch.configs import build_model, get_config
    from repro_torch.kernels import ops
    state.pop("vae", None)                      # free the VAE phases' memory
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_bytes = torch.cuda.memory_allocated()
    prompts = np.random.default_rng(23).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(prompts, max_len=LM_MAX_LEN)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    after_prefill = ops.launch_counts()
    tok = logits.argmax(-1)
    first = tok.clone()
    wall, dev = [], []
    for _ in range(LM_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t1 = time.perf_counter()
        start.record()
        logits, cache = model.decode_step(cache, tok)
        tok = logits.argmax(-1)
        stop.record()
        stop.synchronize()
        wall.append((time.perf_counter() - t1) * 1e3)
        dev.append(start.elapsed_time(stop))
    launches = ops.launch_counts()
    state["launches"]["lm"] = launches
    L = cfg.n_layers
    need(after_prefill["flash_attention"] == L and
         after_prefill["decode_attention"] == 0,
         f"prefill launched {after_prefill}, expected {L} flash_attention")
    need(launches["flash_attention"] == L and
         launches["decode_attention"] == L * LM_STEPS and
         sum(launches.values()) == L * (1 + LM_STEPS),
         f"the LM run launched {launches}, expected {L} flash_attention "
         f"and {L * LM_STEPS} decode_attention")
    need(tuple(logits.shape) == (LM_BATCH, cfg.vocab_size) and
         bool(torch.isfinite(logits.float()).all()), "bad decode logits")
    need(bool((cache["pos"] == LM_PROMPT + LM_STEPS).all()),
         f"cache positions {cache['pos'].tolist()}")
    peak = torch.cuda.max_memory_allocated()
    del cache, logits

    # decode_step on x after prefill(p) against the last logits of
    # prefill(p + [x]): 2049 positions, a ragged tile for the kernel
    t0 = time.perf_counter()
    lp, c = model.prefill(prompts, max_len=LM_MAX_LEN)
    torch.cuda.synchronize()
    warm_prefill_ms = (time.perf_counter() - t0) * 1e3
    ld, c = model.decode_step(c, first)
    del c
    longer = np.concatenate([prompts, first.cpu().numpy()[:, None]], axis=1)
    lf, _ = model.prefill(longer)
    del _
    # where the time goes: device kernel time against wall time, one
    # prefill and four decode steps under torch.profiler
    holder = {}

    def run_prefill():
        holder["l"], holder["c"] = model.prefill(prompts, max_len=LM_MAX_LEN)

    def run_step():
        holder["l"], holder["c"] = model.decode_step(
            holder["c"], holder["l"].argmax(-1))

    prof_prefill = profile_share(torch, run_prefill, 1)
    prof_step = profile_share(torch, run_step, 4)
    del holder
    err = float((ld.float() - lf.float()).abs().max())
    scale = float(lf.float().abs().max())
    need(err <= 2e-2 * scale, f"decode-after-prefill logits differ from a "
         f"prefill of {LM_PROMPT + 1} tokens by {err} > 2e-2 * {scale}")
    steps = LM_BATCH * LM_PROMPT
    emit(log, "lm", arch=LM_ARCH, dtype="bfloat16", layers=L,
         d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads],
         head_dim=cfg.head_dim, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
         params=model.n_params, param_count_config=cfg.param_count(),
         weights_bytes=weights_bytes, init_s=init_s,
         max_memory_allocated=peak, batch=LM_BATCH, prompt=LM_PROMPT,
         max_len=LM_MAX_LEN, decode_steps=LM_STEPS,
         prefill_ms=prefill_ms, prefill_tokens_per_s=steps / prefill_ms * 1e3,
         warm_prefill_ms=warm_prefill_ms,
         warm_prefill_tokens_per_s=steps / warm_prefill_ms * 1e3,
         decode_step_ms_median=statistics.median(dev),
         decode_step_wall_ms_median=statistics.median(wall),
         decode_step_ms=[round(x, 4) for x in dev],
         decode_tokens_per_s=LM_BATCH / statistics.median(dev) * 1e3,
         launches=launches, launches_after_prefill=after_prefill,
         first_tokens=first.tolist(),
         profile_prefill=prof_prefill, profile_decode_step=prof_step,
         consistency_max_abs_err=err, consistency_logit_max=scale,
         consistency_rel_err=err / scale, consistency_tol=2e-2,
         consistency_tol_reason="bf16 weights and activations: the "
                                "decode step's [4, 1] products and the "
                                "decode kernel against the prefill's "
                                "[4, 2049] products and the flash kernel; "
                                "relative to the max |logit|")


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script measures the card "
              "and does not fall back to the CPU", file=sys.stderr)
        return 3
    OUT_DIR.mkdir(exist_ok=True)
    state = {"np": np}
    with open(OUT_DIR / "chip_smoke.jsonl", "w") as log:
        phase_device(torch, log, state)
        phase_kernels(torch, log, state)
        phase_invariance(torch, log, state)
        phase_slice(torch, log, state)
        phase_write(torch, log, state)
        phase_crossdevice(torch, log, state)
        phase_lm(torch, log, state)
        totals = state["kernel_totals"]
        launches = {k: sum(run[k] for run in state["launches"].values())
                    for k in KERNELS}
        line = json.dumps({"kernels": [
            {"name": k, "route": "cuda", "source": src, "replaces": rep,
             "launches": launches[k],
             "max_abs_err": totals[k]["max_abs_err"],
             "ms": totals[k]["ms"], "plain_ms": totals[k]["plain_ms"],
             "bound_ms": totals[k]["bound_ms"],
             "bound_by": totals[k]["bound_by"],
             "library_ms": totals[k]["library_ms"]}
            for k, (src, rep) in KERNELS.items()]})
        print(line, flush=True)
        log.write(line + "\n")
    print(state["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
