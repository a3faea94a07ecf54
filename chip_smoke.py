#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's read path, its write and regeneration
path, its persistent sharded store, its serving runtime and its LM
serving paths (dense, RWKV-6, Mamba-2 hybrid) on one NVIDIA GPU and hold
every Hopper kernel against its plain PyTorch version.

    python3 chip_smoke.py                    # needs one GPU and nvcc

Phases, each printing one JSON line and then a ``timing`` line with its
wall seconds (any failure exits non-zero):

1. device       card name and power limit, torch/CUDA versions, the
                kernels' build from ``src/repro_torch/kernels/csrc``;
2. kernels      each kernel against its plain version on the card at the
                shapes that one 512x512 uint8 decode, one encode and one
                float decode of the SD3.5-width VAE give it, at the
                Qwen2-7B prefill's and decode step's attention shapes (bf16
                and fp32, with a sliding-window case), at zamba2-2.7b's
                shared-block attention shapes (head_dim 80), and
                ``rwkv6_scan`` at the rwkv6-7b prefill's shape (with and
                without an initial state, and with decays from w = -10 to
                w = 4) and decode step's (t = 1, the state updated in
                place): max error and tolerance, median
                ms (CUDA events; for the LM shapes the kernels' device
                time under ``torch.profiler``; for the decode attention
                also with a cold L2, ``cold_ms``, beside SDPA's), the
                plain version's ms, a
                library call's ms where one exists, FLOPs, bytes and the
                bound (at the peak of what the kernel runs on: for fp32
                work in 3xTF32, three TF32 products per fp32 one at the
                TF32 peak), and what the kernel runs on (``design``); for
                the three GroupNorm kernels also the statistics pass alone
                (``stats_pass_ms``, CUDA events; ``stats_pass_device_ms``,
                ``torch.profiler``), the call's device ms and the bound
                with the statistics' own read (``two_pass_bound_ms``); for
                ``output_epilogue`` the share of bytes off by 1 LSB; then
                the totals of each pass, and the plain
                ``downsample``'s ms per encode.  The upsampler's lines
                also carry its two costs apart: ``phase_collapse_ms``
                (the wrapper's per-call tap collapse) and ``kernel_ms``
                (the launch alone, from taps collapsed beforehand).  The
                four conv kernels' bf16 and int8 weight cases at every
                decode shape, each
                against its plain version at the fp32 tolerance, with
                its ms beside the fp32 case's, and their totals over one
                uint8 decode per weight dtype;
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
6. store        the persistent, sharded and replicated store:
                ``LatentBox.open(path, shards=4, replication=2, hedge=...,
                device="cuda")`` at SD3.5-VAE width: latent, uint8-image
                and recipe puts, recipe-only and lossy demotions (the
                lossy ones transcoded by compaction), a seeded Zipf trace
                served, the box closed and reopened and the trace served
                again (the same bytes), recipe-only objects regenerated
                before and after the reopen (the same bytes), a shard
                killed (its replicas serve the same bytes) and restarted
                (the same bytes), a child process on the card killed with
                SIGKILL mid-stream of latent puts (every acknowledged put
                byte-equal and decoded as its latent); put ms (and with
                fsync), flush ms, reopen ms per shard and MB read, decode
                ms per image through the sharded path, p50/p99 read ms
                healthy and with the dead shard, disk and live bytes,
                write amplification, each kernel's launches (all > 0);
7. stream       the serving runtime at SD3.5-VAE width over boxes of 240
                latent and 16 recipe puts (8 recipe-only): a flash-crowd
                trace served in windows of 8 and through ``serve_stream``
                in drain mode (the same class, node and bytes for every
                request); decode ms per batch over the buckets fitted to
                the runtime's per-dispatch and per-image cost, beside the
                nominal ``from_store`` model; a multi-tenant trace through
                ``serve_stream`` with QoS and admission on under the
                fitted model, at its own rate and at 3 plants of offered
                decode load (``StreamReport.summary()``: served, shed,
                degraded, deadline misses, p50/p99 per SLO class and
                tenant, on the runtime's virtual clock); the flash crowd
                on an engine box with ``autoscale=True`` (scale events,
                ``decode_util``) and on a 2-shard autoscaled engine
                cluster (shard count over time); every image byte-equal
                to the first serving's for its object, each kernel's
                launches (all > 0), the phase's wall seconds;
8. quant        the quantized read path: engines opened with
                ``weight_dtype="bfloat16"`` on the calibrated decoder and
                ``"int8"`` on a grid-snapped copy, each gate at most 1 LSB
                and equal to ``gate_max_lsb`` outside the engine, serving
                a seeded Zipf trace of latent puts in windows: every
                served image within +-1 LSB of the fp32-weight decode,
                bucket 8 bit-identical to batch 1, each kernel's launches
                (all > 0), device ms per image per bucket beside fp32
                weights, ``decoder_storage``; then a raw int8 engine on
                the unsnapped decoder, accepted or refused as its gate
                says;
9. crossdevice  the same VAE at a 16x16 latent and a 128x128 image on the
                GPU and on the CPU (the plain path): uint8 within +-1 LSB,
                float trunk, float decode and encoder mean within a
                relative tolerance; and small fp32 qwen2-, RWKV-6- and
                zamba2-family LMs' prefill and decode steps, logits and
                caches within a relative tolerance;
10. lm          the dense LM serving path: ``build_model`` of Qwen2-7B at
11. ssm         full width and depth in bf16 (seeded random weights), then
12. hybrid      rwkv6-7b, then zamba2-2.7b, each freed before the next is
                built: a prefill of 4 x 2048 seeded tokens, 64 greedy
                ``decode_step``s: parameters, peak memory, prefill and
                decode-step ms and tokens/s, each kernel's launches
                (checked exactly per prefill and per step),
                decode-after-prefill logits against a prefill one token
                longer (bf16, and fp32 on the same weights cast exactly),
                and a ``torch.profiler`` window of a prefill and four
                steps (device-busy share, top kernels).

Then a ``{"kernels": [...]}`` summary line (times summed over one uint8
decode, one encode and one float decode of a 512x512 image, and one
prefill and one decode step of each LM; launches summed over the slice,
write, store, stream, quant, lm, ssm and hybrid phases), the ``nvidia-smi`` name and
power-limit line, and as the last line ``{"ok": true, "device":
{"platform": "gpu", "kind": ..., "count": ...}}``.  Full lines also go to
``chip_smoke.jsonl`` in ``OUT_DIR`` (the repository's output directory).
The script imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import gc
import itertools
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
QUANT_OBJECTS = 16        # latent puts of the quant phase
QUANT_REQUESTS = 64
QUANT_BUCKETS = (1, 2, 4, 8)
GATE_LATENT = (8, 8, 16)  # the engine's gate probes 8x8 latents
LM_ARCH = "qwen2-7b"
SSM_ARCH = "rwkv6-7b"
HYBRID_ARCH = "zamba2-2.7b"
LM_BATCH = 4
LM_PROMPT = 2048          # prompt tokens per sequence
LM_MAX_LEN = 2112         # KV-cache slots: prompt + 64 steps
LM_STEPS = 64             # greedy decode steps
LM_WINDOW = 512           # the sliding-window kernel case
DECODE_LENGTHS = (2049, 2080, 1500, 7)    # ragged cache lengths, one step
VAE_PASSES = ("decode", "encode", "float_decode")
#: each LM serving phase -> the model it serves
SERVE = {"lm": LM_ARCH, "ssm": SSM_ARCH, "hybrid": HYBRID_ARCH}
PASSES = VAE_PASSES + tuple(f"{ph}_{p}" for ph in SERVE
                            for p in ("prefill", "decode_step"))
_BF16 = ("bf16 weights and activations: the decode step's [4, 1] products "
         "and kernels against the prefill's [4, 2049] ones; relative to the "
         "max |logit|")
#: decode-after-prefill tolerance in bf16 per serving phase, and why
CONSISTENCY_TOL = {
    "lm": (2e-2, _BF16),
    "ssm": (2e-2, _BF16),
    "hybrid": (1e-1, _BF16 + "; 63 bf16 blocks (54 Mamba-2 layers, 9 shared "
               "attention blocks), more than twice Qwen2-7B's 28; the "
               "path itself is held to the fp32 tolerance"),
}
FP32_CONSISTENCY_TOL = 1e-3

#: kernel -> (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "conv3x3": ("src/repro_torch/kernels/csrc/conv3x3.cu",
                "src/repro/kernels/conv3x3.py:76"),
    "gn_silu_conv3x3": ("src/repro_torch/kernels/csrc/gn_silu_conv.cu",
                        "src/repro/kernels/gn_silu_conv.py:84"),
    "upsample_conv3x3": ("src/repro_torch/kernels/csrc/upsample_conv.cu",
                         "src/repro/kernels/upsample_conv.py:102"),
    "output_epilogue": ("src/repro_torch/kernels/csrc/output_epilogue.cu",
                        "src/repro/kernels/output_epilogue.py:82"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:78"),
    "group_norm_silu": ("src/repro_torch/kernels/csrc/gn_silu.cu",
                        "src/repro/kernels/gn_silu.py:63"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:62"),
    "rwkv6_scan": ("src/repro_torch/kernels/csrc/rwkv6_scan.cu",
                   "src/repro/kernels/rwkv6_scan.py:55"),
}
#: kernel -> what its CUDA source runs on
DESIGN = {
    "conv3x3": "3xTF32 mma.sync implicit GEMM (tc_conv_tile.cuh): Cout > 32 "
               "on the 128-wide tile, 4 < Cout <= 32 on the 32-wide tile with "
               "K split over a CTA cluster and a DSMEM merge; Cout <= 4 on the "
               "CUDA-core fp32 tile",
    "gn_silu_conv3x3": "3xTF32 mma.sync implicit GEMM (tc_conv_tile.cuh)",
    "upsample_conv3x3": "3xTF32 mma.sync implicit GEMM (tc_conv_tile.cuh), "
                        "phase form: a block per phase, its 4 collapsed "
                        "2x2 taps, 128-wide tile",
    "output_epilogue": "coalesced GN statistics pass (gn_stats.cu), then a "
                       "16x32 tile x 3 outputs a block of 512 threads: the "
                       "whole filter in shared memory once, the halo by "
                       "cp.async in 16-channel chunks through a three-stage "
                       "ring, one barrier a chunk, GN + SiLU once per halo "
                       "element, CUDA-core fp32 products, packed "
                       "uint8 stores",
    "flash_attention": "wgmma bf16, 3xTF32 mma.sync fp32",
    "group_norm_silu": "coalesced GN statistics pass (gn_stats.cu), then a "
                       "float4 apply with four loads in flight a thread "
                       "(CUDA-core fp32; streaming stores above 32 MB)",
    "decode_attention": "one launch: a CTA cluster per (sequence, kv head), "
                        "per-warp cp.async rings, bf16 on mma.sync (q k^T; "
                        "at d 128 p v with p split exactly into 3 bf16), "
                        "DSMEM merge",
    "rwkv6_scan": "prefill (t > DECODE_MAX_T): chunked and state-resident, "
                  "a block per (sequence, head, 64 value columns), 16-token "
                  "sub-chunks, the inter, intra and state products in 3xTF32 "
                  "on mma.sync, pairwise decay products on the CUDA cores, "
                  "cp.async staging; decode: the whole state in the "
                  "registers of 8 warps, 16-byte loads, fixed-order "
                  "shuffles (CUDA-core fp32)",
}
#: kernels whose fp32 work runs in 3xTF32 on the tensor cores: their
#: bound counts three TF32 products per fp32 one at the TF32 peak (a conv
#: with Cout <= CUDA_CORE_COUT runs on the CUDA cores, at the fp32 peak)
TENSOR_CORE = ("conv3x3", "gn_silu_conv3x3", "upsample_conv3x3",
               "flash_attention", "rwkv6_scan")
CUDA_CORE_COUT = 4
#: the conv kernels that take quantized weights, and the storage dtypes
QUANT_KERNELS = ("conv3x3", "gn_silu_conv3x3", "upsample_conv3x3",
                 "output_epilogue")
WEIGHT_DTYPES = ("float32", "bfloat16", "int8")
#: kernels that run the GroupNorm statistics pass (``gn_stats.cu``) first
GN_KERNELS = ("gn_silu_conv3x3", "output_epilogue", "group_norm_silu")
#: kernels no single PyTorch call computes (``library_ms`` null)
NO_LIBRARY = {"rwkv6_scan": "no single PyTorch call computes the RWKV-6 "
                            "recurrence"}


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
    dense bf16 tensor-core FLOP/s, dense TF32 tensor-core FLOP/s) of the
    part, from NVIDIA's data sheets, read off the device name."""
    if "PCIe" in name:
        return (51e12, 2.0e12, "H100 PCIe: 51 TFLOP/s fp32, 756 TFLOP/s "
                "bf16 and 378 TF32 dense tensor, 2.0 TB/s", 756e12, 378e12)
    if "NVL" in name:
        return (60e12, 3.9e12, "H100 NVL: 60 TFLOP/s fp32, 835 TFLOP/s bf16 "
                "and 417 TF32 dense tensor, 3.9 TB/s", 835e12, 417e12)
    return (67e12, 3.35e12, "H100 SXM: 67 TFLOP/s fp32, 989 TFLOP/s bf16 "
            "and 495 TF32 dense tensor, 3.35 TB/s", 989e12, 495e12)


def ops_ms(state, kernel, flops, dtype="float32", cout=None,
           cuda_cores=False):
    """The least time (ms) of ``flops`` on what ``kernel`` runs them on:
    bf16 at the bf16 tensor-core peak; fp32 at the TF32 peak, three
    products per fp32 one, for a kernel in ``TENSOR_CORE`` (a conv's
    ``cout`` above ``CUDA_CORE_COUT``; not ``cuda_cores``, the
    ``rwkv6_scan`` decode kernel), else at the fp32 peak of the CUDA
    cores."""
    fp32_peak, _, _, bf16_peak, tf32_peak = state["peaks"]
    if dtype == "bfloat16":
        return flops / bf16_peak * 1e3
    if kernel in TENSOR_CORE and not cuda_cores and (
            cout is None or cout > CUDA_CORE_COUT):
        return 3.0 * flops / tf32_peak * 1e3
    return flops / fp32_peak * 1e3


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


def kernel_error(kernel, got, want):
    """(max error, tolerance, why) of a kernel's output against its plain
    version's on the same inputs."""
    if kernel == "output_epilogue":
        return (float((got.int() - want.int()).abs().max()), 1.0,
                "uint8 +-1 LSB: only the fp32 sum order differs, which can "
                "move a value across a rounding edge")
    err = float((got - want).abs().max())
    return (err, 1e-4 * max(1.0, float(want.abs().max())),
            "fp32 with another summation order (up to 9*Cin or d terms, or "
            "a group's statistics): 1e-4 relative to the output's max")


def collapse_ms(torch, x, w, b, w_scale=None):
    """The upsampler's two costs apart: ms of the wrapper's per-call phase
    collapse of a stored filter alone (tensor additions on the card, part
    of its ``ms``), and of the kernel launch alone from taps collapsed
    beforehand (``upsample_conv3x3_taps``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.upsample_conv import upsample_conv3x3_taps
    wc = ref.storage_phase_weights(w).contiguous()
    return {"phase_collapse_ms": cuda_ms(
                torch, lambda: ref.storage_phase_weights(w), REPS),
            "kernel_ms": cuda_ms(
                torch, lambda: upsample_conv3x3_taps(x, wc, b, w_scale), REPS)}


def quantized_checks(torch, log, state, kernel, args, a, fp32_ms, calls,
                     wrappers, plains, quant_totals):
    """The bf16 and int8 weight cases of a decode-path conv kernel at one
    decode shape: each against its plain version on the same inputs at
    the fp32 tolerance (bf16 and int8 weights are exact in fp32, so only
    the sum order differs), with its ms beside the fp32 case's.  Returns
    the largest error."""
    from repro_torch.kernels import ops
    from repro_torch.vae.quantize import quantize_int8
    worst = 0.0
    quant_totals["float32"][kernel]["ms"] += calls * fp32_ms
    quant_totals["float32"][kernel]["calls"] += calls
    wt = a[-2]
    for wd in WEIGHT_DTYPES[1:]:
        extra = {}
        wq = wt.bfloat16() if wd == "bfloat16" else quantize_int8(wt)
        w_store, w_scale = ops.weight_parts(wq)
        qa = list(a[:-2]) + [wq, a[-1]]
        pa = list(a[:-2]) + [w_store, a[-1]]
        got = wrappers[kernel](qa)
        want = plains[kernel](pa, w_scale)
        torch.cuda.synchronize()
        need(tuple(got.shape) == tuple(want.shape) and got.dtype == want.dtype,
             f"{kernel}{args} {wd}: shape or dtype differs")
        need(bool(torch.isfinite(got.float()).all()),
             f"{kernel}{args} {wd}: non-finite output")
        err, tol, why = kernel_error(kernel, got, want)
        need(err <= tol, f"{kernel}{args} {wd}: max error {err} > {tol}")
        if kernel == "output_epilogue":
            extra["off_lsb_share"] = off_share(got, want)
        ms = cuda_ms(torch, lambda: wrappers[kernel](qa), REPS)
        plain_ms = cuda_ms(torch, lambda: plains[kernel](pa, w_scale), REPS)
        if kernel == "upsample_conv3x3":
            extra.update(collapse_ms(torch, a[0], w_store, a[-1], w_scale))
        emit(log, "kernel_quant", name=kernel, weight_dtype=wd,
             shape=list(args), calls_per_decode=calls, max_abs_err=err,
             tol=tol, tol_reason=why, ms=ms, plain_ms=plain_ms,
             fp32_ms=fp32_ms, weight_bytes=int(wq.nbytes),
             fp32_weight_bytes=int(wt.nbytes), **extra)
        quant_totals[wd][kernel]["ms"] += calls * ms
        quant_totals[wd][kernel]["calls"] += calls
        worst = max(worst, err)
        del wq, w_store, w_scale, qa, pa, got, want
    return worst


def kernel_fns(torch):
    """The VAE kernels' wrappers, their plain versions (which take an
    integer weight's ``w_scale``) and PyTorch's own call for the same work
    on the same inputs, each keyed by kernel name."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
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
        "conv3x3": lambda a, s=None: ref.conv3x3_ref(*a, w_scale=s),
        "gn_silu_conv3x3": lambda a, s=None: ref.gn_silu_conv3x3_ref(
            *a, groups, w_scale=s),
        "upsample_conv3x3": lambda a, s=None: ref.upsample_conv3x3_ref(
            *a, w_scale=s),
        "output_epilogue": lambda a, s=None: ref.output_epilogue_ref(
            *a, groups, w_scale=s),
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

    return wrappers, plains, library


def vae_kernel_shapes():
    """(kernel, shape) -> its calls in one 512x512 uint8 decode, encode and
    float decode of the SD3.5-width VAE, in first-seen order."""
    from repro_torch.vae.model import SD35_VAE
    passes = {"decode": decode_calls(SD35_VAE, LATENT_HW),
              "encode": encode_calls(SD35_VAE, 8 * LATENT_HW),
              "float_decode": float_decode_calls(SD35_VAE, LATENT_HW)}
    shapes = {}
    for name, calls in passes.items():
        for key, n in Counter(c for c in calls if c[0] in KERNELS).items():
            shapes.setdefault(key, dict.fromkeys(VAE_PASSES, 0))[name] = n
    return shapes


def off_share(got, want) -> float:
    """The share of a uint8 output's values that differ from the plain
    version's (each by 1 LSB where the check holds)."""
    return float((got != want).float().mean())


def measure_kernel(torch, state, kernel, args, a, fns):
    """One VAE kernel call on inputs ``a``: its output held against the
    plain version's, its ms, the plain version's and the library call's
    (CUDA events), FLOPs, bytes and bounds; for a GroupNorm kernel also
    the statistics pass alone (``stats_pass_ms`` in CUDA events,
    ``stats_pass_device_ms`` the device time of its two kernels under
    ``torch.profiler``, which leaves out the host's launch gaps that the
    events count at small shapes), the call's device time, launches and
    device kernels the same way, and the bound of the two passes
    (``two_pass_bound_ms``: the statistics' own read of x beside the
    kernel's bytes)."""
    from repro_torch.kernels.gn_silu_conv import gn_stats
    from repro_torch.vae.model import SD35_VAE
    wrappers, plains, library = fns
    got = wrappers[kernel](a)
    want = plains[kernel](a)
    torch.cuda.synchronize()
    need(tuple(got.shape) == tuple(want.shape) and got.dtype == want.dtype,
         f"{kernel}{args}: kernel gives {tuple(got.shape)} {got.dtype}, "
         f"plain {tuple(want.shape)} {want.dtype}")
    need(bool(torch.isfinite(got.float()).all()), f"{kernel}{args}: "
         "non-finite output")
    err, tol, why = kernel_error(kernel, got, want)
    need(err <= tol, f"{kernel}{args}: max error {err} > {tol}")
    extra = {"off_lsb_share": off_share(got, want)} \
        if kernel == "output_epilogue" else {}
    del got, want
    flops, nbytes = work(kernel, args)
    cout = None if kernel == "flash_attention" else args[-1]
    row = dict(max_abs_err=err, tol=tol, tol_reason=why,
               ms=cuda_ms(torch, lambda: wrappers[kernel](a), REPS),
               plain_ms=cuda_ms(torch, lambda: plains[kernel](a), REPS),
               library_ms=cuda_ms(torch, library(kernel, a), REPS),
               flops=flops, ops_ms=ops_ms(state, kernel, flops, cout=cout),
               bytes=nbytes, stats_pass_ms=0.0, stats_bytes=0.0)
    if kernel in GN_KERNELS:
        groups = SD35_VAE.groups
        stats = lambda: gn_stats(a[0], groups, 1e-6)   # noqa: E731
        prof = profile_share(torch, stats, REPS)
        kern = profile_share(torch, lambda: wrappers[kernel](a), REPS)
        row.update(stats_pass_ms=cuda_ms(torch, stats, REPS),
                   stats_bytes=4.0 * args[0] * args[1] * args[2])
        stats_bound = row["stats_bytes"] / state["peaks"][1] * 1e3
        extra.update(
            stats_pass_device_ms=prof["device_ms"],
            stats_bound_ms=stats_bound,
            stats_device_share=(stats_bound / prof["device_ms"]
                                if prof["device_ms"] else None),
            stats_device_launches=prof["device_launches"],
            device_ms=kern["device_ms"],
            device_launches=kern["device_launches"],
            device_kernels=kern["top"])
    if kernel == "upsample_conv3x3":
        extra.update(collapse_ms(torch, a[0], a[1], a[2]))
    with_bound(row, state["peaks"][1])
    row.update(tflops=flops / row["ms"] / 1e9, **extra)
    return row


def vae_kernel_checks(torch, log, state, names=None):
    """``measure_kernel`` at every shape of ``vae_kernel_shapes`` of the
    kernels in ``names`` (all of them if None), each a ``kernel`` line,
    with the quantized weight cases of the decode's conv kernels.
    Returns the totals per pass and kernel, the largest error per kernel
    and the upsampler's launches alone per pass."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.vae.model import SD35_VAE
    names = set(KERNELS if names is None else names)
    fns = kernel_fns(torch)
    checks = {key: n for key, n in vae_kernel_shapes().items()
              if key[0] in names}
    if "flash_attention" in names:
        # attention also at a 1024x1024 image's 16,384 tokens (checked,
        # not part of any pass's totals)
        top = SD35_VAE.block_out_channels[-1]
        checks.setdefault(("flash_attention", (16384, top)),
                          dict.fromkeys(VAE_PASSES, 0))
    gen = torch.Generator(device="cuda").manual_seed(1234)
    totals = {p: {k: dict.fromkeys(TOTAL_FIELDS, 0.0) for k in KERNELS}
              for p in PASSES}
    max_err = dict.fromkeys(KERNELS, 0.0)
    # the upsampler's launches alone (taps collapsed beforehand), per pass
    kernel_alone = dict.fromkeys(VAE_PASSES, 0.0)
    # weight dtype -> kernel -> ms and calls over one uint8 decode
    quant_totals = {wd: {k: {"ms": 0.0, "calls": 0} for k in QUANT_KERNELS}
                    for wd in WEIGHT_DTYPES}
    for (kernel, args), per_pass in checks.items():
        a = kernel_inputs(torch, kernel, args, gen)
        row = measure_kernel(torch, state, kernel, args, a, fns)
        emit(log, "kernel", name=kernel, design=DESIGN[kernel],
             shape=list(args), calls=per_pass, **row)
        if kernel == "upsample_conv3x3":
            for p, n in per_pass.items():
                kernel_alone[p] += n * row["kernel_ms"]
        max_err[kernel] = max(max_err[kernel], row["max_abs_err"])
        add_to_totals(totals, kernel, per_pass, row)
        if kernel in QUANT_KERNELS and per_pass["decode"]:
            wrappers, plains, _ = fns
            qerr = quantized_checks(torch, log, state, kernel, args, a,
                                    row["ms"], per_pass["decode"], wrappers,
                                    plains, quant_totals)
            max_err[kernel] = max(max_err[kernel], qerr)
        del a
        torch.cuda.empty_cache()
    emit(log, "kernels_quant_per_decode", image=[8 * LATENT_HW] * 2,
         totals=quant_totals,
         total_ms={wd: sum(t["ms"] for t in quant_totals[wd].values())
                   for wd in quant_totals})
    return totals, max_err, kernel_alone


def phase_kernels(torch, log, state):
    from repro_torch.vae.model import SD35_VAE
    image_hw = 8 * LATENT_HW
    byte_peak = state["peaks"][1]
    totals, max_err, kernel_alone = vae_kernel_checks(torch, log, state)
    lm_attention_checks(torch, log, state, totals, max_err)
    rwkv6_checks(torch, log, state, totals, max_err)
    for per_kernel in totals.values():
        for t in per_kernel.values():
            with_bound(t, byte_peak)
    down = time_downsample(torch, log, state,
                           encode_calls(SD35_VAE, image_hw))
    for p in PASSES:
        extra = {"plain_downsample": down} if p == "encode" else {}
        if p in VAE_PASSES:
            extra["image"] = [image_hw] * 2
            extra["upsample_conv3x3_kernel_ms"] = kernel_alone[p]
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
#: of what runs them, so bf16 and fp32 work add up)
TOTAL_FIELDS = ("ms", "plain_ms", "library_ms", "flops", "ops_ms", "bytes",
                "calls", "stats_pass_ms", "stats_bytes")


def add_to_totals(totals, kernel, per_pass, row):
    for p, n in per_pass.items():
        t = totals[p][kernel]
        for f in TOTAL_FIELDS:
            t[f] += n * (1 if f == "calls" else row.get(f, 0.0))


def with_bound(t, byte_peak):
    """Add the least time (ms) the card needs for ``t``'s operations
    (``ops_ms``, at the peak of their type) and bytes, and which of the
    two bounds it; where ``t`` counts a GroupNorm statistics read
    (``stats_bytes``), also the two passes' bound with it."""
    t_ops, t_bytes = t["ops_ms"], t["bytes"] / byte_peak * 1e3
    t["bound_ms"] = max(t_ops, t_bytes)
    t["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    if t.get("stats_bytes"):
        t["two_pass_bound_ms"] = max(
            t_ops, (t["bytes"] + t["stats_bytes"]) / byte_peak * 1e3)
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

def lm_attention_cases(get_config):
    """[(arch, kernel, shape, dtype name, calls per pass)] at the shapes the
    serving runs give the attention kernels.  Qwen2-7B: the causal prefill
    of 4 x 2048 tokens (28 calls per prefill), the same with a 512-token
    window (checked, in no pass), and one decode step against a cache of
    2112 slots with ragged lengths (28 calls per step), in bf16 (the
    model's type) and fp32 (checked, in no pass).  zamba2-2.7b's shared
    block (head_dim 80, 32 q over 32 kv heads): its causal prefill and its
    decode step, 9 calls each per pass, bf16."""
    cases = []
    cfg = get_config(LM_ARCH)
    n, hq, hkv, d = LM_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    for dt in ("bfloat16", "float32"):
        main = dt == "bfloat16"
        prefill = dict(n=n, hq=hq, hkv=hkv, sq=LM_PROMPT, skv=LM_PROMPT, d=d,
                       causal=True)
        cases.append((LM_ARCH, "flash_attention", dict(prefill, window=None),
                      dt, {"lm_prefill": cfg.n_layers} if main else {}))
        cases.append((LM_ARCH, "flash_attention",
                      dict(prefill, window=LM_WINDOW), dt, {}))
        cases.append((LM_ARCH, "decode_attention",
                      dict(n=n, hq=hq, hkv=hkv, s=LM_MAX_LEN, d=d,
                           lengths=list(DECODE_LENGTHS)), dt,
                      {"lm_decode_step": cfg.n_layers} if main else {}))
    zc = get_config(HYBRID_ARCH)
    napp = zc.n_layers // zc.attn_every
    n, hq, hkv, d = LM_BATCH, zc.n_heads, zc.n_kv_heads, zc.head_dim
    cases.append((HYBRID_ARCH, "flash_attention",
                  dict(n=n, hq=hq, hkv=hkv, sq=LM_PROMPT, skv=LM_PROMPT, d=d,
                       causal=True, window=None), "bfloat16",
                  {"hybrid_prefill": napp}))
    cases.append((HYBRID_ARCH, "decode_attention",
                  dict(n=n, hq=hq, hkv=hkv, s=LM_MAX_LEN, d=d,
                       lengths=list(DECODE_LENGTHS)), "bfloat16",
                  {"hybrid_decode_step": napp}))
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
    byte_peak = state["peaks"][1]
    gen = torch.Generator(device="cuda").manual_seed(2024)
    for arch, kernel, shape, dt, per_pass in lm_attention_cases(get_config):
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
            # int32, as the model's cache positions are: no cast kernel
            lens = torch.tensor(shape["lengths"], device="cuda",
                                dtype=torch.int32)
            run = lambda: ops.decode_attention(q, k, v, lens)      # noqa: E731
            plain = lambda: ref.decode_attention_ref(q, k, v, lens)  # noqa: E731
            mask = (torch.arange(shape["s"], device="cuda")[None, :]
                    < lens[:, None])[:, None, None, :]
            lib = lambda: F.scaled_dot_product_attention(           # noqa: E731
                q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)
        got, want = run(), plain()
        torch.cuda.synchronize()
        label = f"{arch} {kernel}[{dt}]{shape}"
        need(got.shape == want.shape and got.dtype == want.dtype == dtype,
             f"{label}: kernel gives {tuple(got.shape)} {got.dtype}")
        need(bool(torch.isfinite(got.float()).all()),
             f"{label}: non-finite output")
        err = float((got.float() - want.float()).abs().max())
        rel = 1e-4 if dtype == torch.float32 else 1e-2
        tol = rel * float(want.float().abs().max())
        need(err <= tol, f"{label}: max error {err} > {tol}")
        per_seq = {}
        if kernel == "decode_attention":
            # each sequence also against its own largest output: a long
            # sequence's outputs are far smaller than a short one's, so a
            # fault in its share of the rows would hide under the batch's
            seq_err = [float((got[i].float() - want[i].float()).abs().max())
                       for i in range(n)]
            seq_tol = [rel * float(want[i].float().abs().max())
                       for i in range(n)]
            for i, (e, t) in enumerate(zip(seq_err, seq_tol)):
                need(e <= t, f"{label}: sequence {i} (length "
                     f"{shape['lengths'][i]}) max error {e} > {t}")
            per_seq = dict(seq_max_abs_err=seq_err, seq_tol=seq_tol)
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
        row = dict(times, flops=flops, ops_ms=ops_ms(state, kernel, flops, dt),
                   bytes=nbytes)
        cold = {}
        if kernel == "decode_attention":
            cold = cold_decode_times(torch, q, k, v, lens, mask)
            for key in ("cold_ms", "library_cold_ms"):
                t = state["cold"].setdefault(kernel, {})
                t[key] = t.get(key, 0.0) + sum(per_pass.values()) * (
                    cold[key] or 0.0)
        emit(log, "kernel", name=kernel, design=DESIGN[kernel], arch=arch,
             dtype=dt, shape=shape, **cold, **per_seq,
             calls=per_pass, max_abs_err=err, tol=tol,
             tol_reason=(f"{rel:g} relative to the output's max: fp32 "
                         "softmax and sums in another order"
                         + ("; bf16 output rounding" if rel > 1e-4 else "")
                         + ("; seq_tol: the same, each sequence against its "
                            "own max" if per_seq else "")),
             **row, timing="device time (torch.profiler), per call",
             event_times=event,
             bound_ms=with_bound(dict(row), byte_peak)["bound_ms"],
             peak_tflops=flops / row["ops_ms"] / 1e9,
             tflops=flops / row["ms"] / 1e9)
        row["library_ms"] = row["library_ms"] or 0.0
        max_err[kernel] = max(max_err[kernel], err)
        add_to_totals(totals, kernel, per_pass, row)
        del q, k, v, got, want
        torch.cuda.empty_cache()


def cold_decode_times(torch, q, k, v, lens, mask):
    """Device ms per call of the decode-attention kernel and of SDPA with a
    cold L2: each call takes the next of enough copies of q and the caches
    that together they hold four times the L2, so the rows a call reads
    were evicted since their last use, as in a decode step whose layers'
    caches never fit in L2."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    per_copy = sum(t.numel() * t.element_size() for t in (q, k, v))
    n = max(2, -(-4 * l2 // per_copy))
    copies = [tuple(t.clone() for t in (q, k, v)) for _ in range(n)]
    out = {"cold_copies": n, "l2_bytes": l2}
    calls = {"cold_ms": lambda a: ops.decode_attention(*a, lens),
             "library_cold_ms": lambda a: F.scaled_dot_product_attention(
                 a[0][:, :, None], a[1], a[2], attn_mask=mask,
                 enable_gqa=True)}
    for key, call in calls.items():
        it = itertools.cycle(copies)
        try:
            out[key] = device_ms(torch, lambda: call(next(it)), REPS) or None
        except RuntimeError:             # no SDPA backend for this case
            if key != "library_cold_ms":
                raise
            out[key] = None
    del copies
    return out


def rwkv6_work(shape, elt):
    """(FLOPs, bytes) of one ``rwkv6_scan`` call: 5 d^2 + 7 d operations
    per (sequence, head, token) -- r . S (2 d^2), k (x) v (d^2), dec S + kv
    (2 d^2), the bonus sum r u k (3 d) and its product with v (2 d), the
    decay's two exponentials (2 d) -- at the fp32 rate; r, k, v (``elt``
    bytes each), w and u read once, the initial state read once where one
    is given, the output (``elt``) and the final state written once."""
    n, h, t, d = shape["n"], shape["h"], shape["t"], shape["d"]
    elems = n * h * t * d
    flops = float(n * h * t * (5 * d * d + 7 * d))
    nbytes = (3 * elt * elems + 4 * elems + 4 * h * d + elt * elems
              + 4 * n * h * d * d * (2 if shape["state"] else 1))
    return flops, float(nbytes)


def rwkv6_checks(torch, log, state, totals, max_err):
    """``rwkv6_scan`` at the rwkv6-7b serving run's shapes: the prefill of
    4 x 2048 tokens over 64 heads of 64 (r/k/v bf16 as the model gives
    them, w fp32; with the zeroed cache state the prefill passes, 32 calls
    per prefill, and with a random state, none, and decays from w = -10,
    dec = 1 - 4.5e-5, to w = 4, a log-decay of -54.6 a token, checked), and
    the decode step (t = 1, the state updated in place, 32 calls per step;
    the decode kernel, ``DECODE_MAX_T``).  Against the sequential plain
    version on the same inputs; device time under ``torch.profiler``, the
    plain version by CUDA events."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.rwkv6_scan import DECODE_MAX_T
    cfg = get_config(SSM_ARCH)
    d = cfg.ssm_head_dim
    h = cfg.d_model // d
    byte_peak = state["peaks"][1]
    gen = torch.Generator(device="cuda").manual_seed(2025)
    base = dict(n=LM_BATCH, h=h, d=d)
    cases = [(dict(base, t=LM_PROMPT, state="zeros"),
              {"ssm_prefill": cfg.n_layers}),
             (dict(base, t=LM_PROMPT, state="random"), {}),
             (dict(base, t=LM_PROMPT, state=None), {}),
             (dict(base, t=LM_PROMPT, state="random", w=[-10.0, 4.0]), {}),
             (dict(base, t=1, state="random", in_place=True),
              {"ssm_decode_step": cfg.n_layers})]
    for shape, per_pass in cases:
        n, t = shape["n"], shape["t"]

        def randn(*dims, scale=1.0):
            return torch.randn(dims, generator=gen, device="cuda") * scale
        r, k, v = (randn(n, h, t, d).to(torch.bfloat16) for _ in range(3))
        if "w" in shape:                          # uniform in [lo, hi]
            lo, hi = shape["w"]
            w = lo + (hi - lo) * torch.rand((n, h, t, d), generator=gen,
                                            device="cuda")
        else:
            w = randn(n, h, t, d, scale=0.3) - 2.0    # w0 = -2 plus the LoRA
        u = randn(h, d, scale=0.1)
        s0 = {"zeros": torch.zeros((n, h, d, d), device="cuda"),
              "random": randn(n, h, d, d, scale=0.5),
              None: None}[shape["state"]]
        want, want_s = ref.rwkv6_scan_ref(r, k, v, w, u, s0)
        if shape.get("in_place"):
            cache = s0.clone()
            got, got_s = ops.rwkv6_scan(r, k, v, w, u, cache, out_state=cache)
            need(got_s is cache, "rwkv6_scan did not write the given state")

            def run():
                ops.rwkv6_scan(r, k, v, w, u, cache, out_state=cache)
        else:
            got, got_s = ops.rwkv6_scan(r, k, v, w, u, s0)

            def run():
                ops.rwkv6_scan(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        label = f"rwkv6_scan{shape}"
        need(got.dtype == torch.bfloat16 and got.shape == want.shape and
             got_s.dtype == torch.float32, f"{label}: kernel gives "
             f"{tuple(got.shape)} {got.dtype}, state {got_s.dtype}")
        need(bool(torch.isfinite(got.float()).all()) and
             bool(torch.isfinite(got_s).all()), f"{label}: non-finite output")
        err = float((got.float() - want.float()).abs().max())
        tol = 1e-2 * float(want.float().abs().max())
        s_err = float((got_s - want_s).abs().max())
        s_tol = 1e-4 * float(want_s.abs().max())
        need(err <= tol, f"{label}: max error {err} > {tol}")
        need(s_err <= s_tol, f"{label}: state error {s_err} > {s_tol}")
        ms = device_ms(torch, run, REPS)
        event_ms = cuda_ms(torch, run, REPS)
        plain_ms = cuda_ms(torch, lambda: ref.rwkv6_scan_ref(
            r, k, v, w, u, s0), 3 if t > 1 else REPS)
        flops, nbytes = rwkv6_work(shape, r.element_size())
        row = dict(ms=ms or event_ms, plain_ms=plain_ms, library_ms=0.0,
                   flops=flops, ops_ms=ops_ms(state, "rwkv6_scan", flops,
                                              cuda_cores=t <= DECODE_MAX_T),
                   bytes=nbytes)
        bound = with_bound(dict(row), byte_peak)
        emit(log, "kernel", name="rwkv6_scan", design=DESIGN["rwkv6_scan"],
             arch=SSM_ARCH,
             dtype="bfloat16 r/k/v, fp32 w/u/state", shape=shape,
             calls=per_pass, max_abs_err=err, tol=tol,
             tol_reason="1e-2 of the output's max: one bf16 rounding of "
                        "each output on both sides, from fp32 sums over d "
                        "in another order",
             state_max_abs_err=s_err, state_tol=s_tol,
             state_tol_reason="1e-4 of the state's max: fp32, the update "
                              "as one fma against a multiply and an add",
             **row, timing="device time (torch.profiler), per call",
             event_ms=event_ms, library_note=NO_LIBRARY["rwkv6_scan"],
             bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
             tflops=flops / row["ms"] / 1e9)
        max_err["rwkv6_scan"] = max(max_err["rwkv6_scan"], err)
        add_to_totals(totals, "rwkv6_scan", per_pass, row)
        del r, k, v, w, u, s0, got, got_s, want, want_s
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
    state["slice_decode_ms"] = served_ms
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


STORE_SHARDS = 4
STORE_REPLICATION = 2
STORE_LATENTS = 192       # latent puts (oids 0-191)
STORE_IMAGES = 16         # uint8 image puts (oids 192-207)
STORE_RECIPES = 16        # recipe puts (oids 208-223)
STORE_RECIPE_ONLY = tuple(range(208, 216))          # demoted to recipe-only
STORE_LOSSY = tuple(range(0, STORE_LATENTS, 24))     # demoted to "low"
STORE_REQUESTS = 256
STORE_FSYNC_PUTS = 32     # latent puts timed on a box with fsync=True
STORE_KILL_ACKS = 12      # acknowledged puts before the child is killed
STORE_DEAD_SHARD = 1
STORE_KILL_SEED = 29      # the kill check's latents: (seed, oid)

# the child of the kill check: a box on the card taking latent puts, one
# line per acknowledged (durable) put, until it is killed
STORE_CHILD = r"""
import sys
sys.path.insert(0, {src!r})
import numpy as np
from repro_torch.store import LatentBox, StoreConfig
from repro_torch.vae.model import SD35_VAE, VAE
vae = VAE(SD35_VAE, seed=0, device="cuda")
box = LatentBox.open({path!r}, vae=vae, config=StoreConfig(n_nodes=2),
                     device="cuda")
for oid in range(1 << 30):
    z = np.random.default_rng(({seed}, oid)).standard_normal(
        ({hw}, {hw}, 16)).astype(np.float16)
    if box.put(oid, latent=z).durable:
        print("ACK", oid, flush=True)
"""


def store_kill_latent(np, oid: int):
    return np.random.default_rng((STORE_KILL_SEED, oid)).standard_normal(
        (LATENT_HW, LATENT_HW, 16)).astype(np.float16)


def store_kill_check(torch, np, vae, root, cfg):
    """A child process opens a box on the card and puts latents; it is
    SIGKILLed after ``STORE_KILL_ACKS`` acknowledged puts, mid-stream.
    The reopened box holds every acknowledged blob byte for byte and
    serves each as a direct decode of its latent."""
    import signal
    from repro_torch.compression.latentcodec import compress_latent
    from repro_torch.store import LatentBox
    path = str(Path(root) / "killed")
    code = STORE_CHILD.format(src=str(ROOT / "src"), path=path,
                              seed=STORE_KILL_SEED, hw=LATENT_HW)
    proc = subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    acked = []
    try:
        t0 = time.perf_counter()
        for line in proc.stdout:
            if line.startswith("ACK"):
                acked.append(int(line.split()[1]))
            if (len(acked) >= STORE_KILL_ACKS
                    or time.perf_counter() - t0 > 240):
                break
        proc.send_signal(signal.SIGKILL)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=60)
        err = proc.stderr.read()
    need(len(acked) >= STORE_KILL_ACKS, f"the child acknowledged {acked} "
         f"before it stopped; its stderr ends {err[-400:]!r}")
    need(proc.returncode == -signal.SIGKILL,
         f"the child ended with {proc.returncode}, not SIGKILL")
    t0 = time.perf_counter()
    box = LatentBox.open(path, vae=vae, config=cfg, device="cuda")
    reopen_ms = (time.perf_counter() - t0) * 1e3
    rec = dict(box.backend.durable_log.recovery_stats)
    recovered = len(list(box.backend.durable_log.object_oids()))
    store = box.backend.store
    lat = {oid: store_kill_latent(np, oid) for oid in acked}
    for oid in acked:
        need(store.get(oid) == compress_latent(lat[oid]),
             f"acknowledged put {oid} did not survive the kill byte for byte")
    served = {}
    for s in range(0, len(acked), SLICE_WINDOW):
        served.update((r.oid, r.payload)
                      for r in box.get_many(acked[s:s + SLICE_WINDOW]))
    box.close()
    for oid in acked:
        direct = vae.decode_u8(lat[oid].astype(np.float32)[None])[0]
        need(bool(np.array_equal(direct.cpu().numpy(), served[oid])),
             f"pixels of acknowledged put {oid} differ from a direct decode")
    return {"acked": len(acked), "recovered_objects": recovered,
            "reopen_ms": reopen_ms, "recovery_stats": rec}


def phase_store(torch, log, state):
    """The persistent, sharded and replicated store at SD3.5-VAE width:
    ``LatentBox.open(path, shards=4, replication=2, hedge=...,
    device="cuda")``.  A first opening puts latents, uint8 images and
    recipes, demotes some to recipe-only and some to a lossy rung, and
    closes; a second reopens, compacts until every lossy transcode is
    done, serves a seeded Zipf trace, regenerates the recipe-only
    objects, and closes; a third reopens and serves the same requests
    (the same bytes), regenerates (the same bytes), then kills a shard
    (replicas serve the same bytes) and restarts it (the same bytes).
    Then the kill check (``store_kill_check``)."""
    import tempfile
    np = state["np"]
    from repro_torch.core.regen_tier import Recipe
    from repro_torch.core.tuner import TunerConfig
    from repro_torch.kernels import ops
    from repro_torch.store import LatentBox, StoreConfig
    from repro_torch.store.replication import HedgeConfig
    vae = state.setdefault("vae", sd35_vae(torch, "cuda"))[0]
    side = 8 * LATENT_HW
    image_bytes = side * side * 3
    rng = np.random.default_rng(23)
    latents = [rng.standard_normal((LATENT_HW, LATENT_HW, 16))
               .astype(np.float16) for _ in range(STORE_LATENTS)]
    images = [rng.integers(0, 256, (side, side, 3), dtype=np.uint8)
              for _ in range(STORE_IMAGES)]
    n = STORE_LATENTS + STORE_IMAGES + STORE_RECIPES
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** -1.1
    trace = [int(t) for t in rng.permutation(n)[
        rng.choice(n, STORE_REQUESTS, p=p / p.sum())]]

    def cfg(**kw):
        # two nodes of 6 MB per shard, as in the slice phase
        return StoreConfig(n_nodes=2, cache_bytes_per_node=6e6,
                           image_bytes=float(image_bytes),
                           latent_bytes=1.2e5, promote_threshold=2,
                           tuner=TunerConfig(window=10**9),
                           decode_buckets=(1, 2, 4, 8), **kw)

    launches = Counter()

    def driven(fn):
        """Run one piece of the store path between a reset and a read of
        the launch counts."""
        ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        launches.update(ops.launch_counts())
        return out

    tmp = tempfile.TemporaryDirectory(prefix="lbx-store-",
                                      dir=str(OUT_DIR))
    root = Path(tmp.name)
    path = root / "cluster"

    def open_box():
        t0 = time.perf_counter()
        box = LatentBox.open(path, vae=vae, config=cfg(),
                             shards=STORE_SHARDS,
                             replication=STORE_REPLICATION,
                             hedge=HedgeConfig(), device="cuda")
        ms = (time.perf_counter() - t0) * 1e3
        shards = box.backend.shards.values()
        scanned = {
            "reopen_ms_per_shard": ms / STORE_SHARDS,
            "log_mb_read": sum(
                f.stat().st_size for sh in shards
                for f in Path(sh.backend.durable_log.path).iterdir()
                if f.name.startswith("seg-")) / 1e6,
            "recovery": [dict(sh.backend.durable_log.recovery_stats)
                         for sh in shards]}
        return box, scanned

    def serve(box):
        out, walls = [], []
        for s in range(0, len(trace), SLICE_WINDOW):
            t0 = time.perf_counter()
            res = box.get_many(trace[s:s + SLICE_WINDOW])
            walls.append((time.perf_counter() - t0) * 1e3)
            out += res
        for r in out:
            need(r.payload is not None and r.payload.shape == (side, side, 3)
                 and r.payload.dtype == np.uint8, f"bad payload for {r.oid}")
        ms = [r.latency_ms["total"] for r in out]
        return out, {"p50_read_ms": float(np.percentile(ms, 50)),
                     "p99_read_ms": float(np.percentile(ms, 99)),
                     "median_window_wall_ms": statistics.median(walls),
                     "hit_classes": dict(Counter(r.hit_class for r in out)),
                     "failovers": sum(r.failover for r in out),
                     "hedged": sum(r.hedged for r in out)}

    def same(a, b, what):
        bad = [x.oid for x, y in zip(a, b)
               if not np.array_equal(x.payload, y.payload)]
        need(not bad, f"{what}: images of {sorted(set(bad))} differ")

    def regenerate(box):
        """Read every recipe-only object once (each regenerates), and
        leave them recipe-only again."""
        for oid in STORE_RECIPE_ONLY:
            if not box.stat(oid).demoted:
                need(box.demote(oid), f"demote({oid}) refused")
        res = box.get_many(list(STORE_RECIPE_ONLY))
        need(all(r.regenerated for r in res), "a recipe-only read did not "
             "regenerate")
        for oid in STORE_RECIPE_ONLY:
            need(box.demote(oid), f"demote({oid}) refused after regen")
        return res

    try:
        # -- opening 1: puts, demotions, flush, close ----------------------
        box, _ = open_box()
        box.backend.shards[0].backend.engine.prewarm_decode(
            (LATENT_HW, LATENT_HW, 16))

        def puts():
            ms = {"latent": [], "image": [], "recipe": []}
            for oid in range(n):
                t0 = time.perf_counter()
                if oid < STORE_LATENTS:
                    r = box.put(oid, latent=latents[oid])
                    kind = "latent"
                elif oid < STORE_LATENTS + STORE_IMAGES:
                    r = box.put(oid, image=images[oid - STORE_LATENTS])
                    kind = "image"
                else:
                    r = box.put(oid, recipe=Recipe(seed=2000 + oid,
                                                   height=side, width=side,
                                                   scale=0.5))
                    kind = "recipe"
                ms[kind].append((time.perf_counter() - t0) * 1e3)
                need(r.durable, f"put {oid} was not acknowledged durable")
            return ms

        put_ms = driven(puts)
        for oid in STORE_RECIPE_ONLY:
            need(box.demote(oid), f"demote({oid}) refused")
        for oid in STORE_LOSSY:
            need(box.demote(oid, "low"), f"demote({oid}, 'low') refused")
        t0 = time.perf_counter()
        box.flush()
        flush_ms = (time.perf_counter() - t0) * 1e3
        lossless = {oid: box.stat(oid).durable_bytes for oid in STORE_LOSSY}
        box.close()
        # put latency with fsync on every acknowledgement, on a cluster
        # of the same shape
        fbox = LatentBox.open(root / "fsync", vae=vae,
                              config=cfg(fsync=True), shards=STORE_SHARDS,
                              replication=STORE_REPLICATION,
                              hedge=HedgeConfig(), device="cuda")
        fsync_ms = []
        for oid in range(STORE_FSYNC_PUTS):
            t0 = time.perf_counter()
            fbox.put(oid, latent=latents[oid])
            fsync_ms.append((time.perf_counter() - t0) * 1e3)
        fbox.close()

        # -- opening 2: reopen, compact, serve, regenerate, close ----------
        box, reopen2 = open_box()
        for sh in box.backend.shards.values():
            store = sh.backend.store
            for _ in range(64):
                if not store.backend.stats()["pending_rungs"]:
                    break
                store.maybe_compact()
        logs = [sh.backend.durable_log.stats()
                for sh in box.backend.shards.values()]
        pending = sum(st["pending_rungs"] for st in logs)
        reencoded = sum(st["reencoded_records"] for st in logs)
        need(pending == 0, f"{pending} lossy demotions still pending after "
             "compaction")
        need(reencoded >= len(STORE_LOSSY),
             f"compaction transcoded {reencoded} records")
        for oid in STORE_LOSSY:
            st = box.stat(oid)
            need(st.rung_name == "low" and st.durable_bytes < lossless[oid],
                 f"{oid} was not transcoded: {st}")
        box.flush()
        first, healthy = driven(lambda: serve(box))
        regen1 = driven(lambda: regenerate(box))
        eng = [sh.backend.engine for sh in box.backend.shards.values()]
        bucket_ms = {}
        for e in eng:
            for b, v in e.batcher.bucket_ms.items():
                bucket_ms.setdefault(b, []).extend(v)
        sharded_decode = {str(b): {
            "batches": len(v), "real_images": sum(k for _, k in v),
            "median_per_image_ms": statistics.median(ms / k for ms, k in v)}
            for b, v in sorted(bucket_ms.items())}
        summ = box.summary()
        disk = {k: summ[k] for k in (
            "durable_disk_bytes", "durable_live_bytes", "durable_segments",
            "write_amplification", "segments_compacted",
            "replica_disk_bytes")}
        disk["reencoded_records"] = reencoded
        disk["reencode_bytes_saved"] = sum(
            sh.backend.durable_log.stats()["reencode_bytes_saved"]
            for sh in box.backend.shards.values())
        objects = sum(1 for oid in range(n) if box.stat(oid).durable_bytes)
        box.close()

        # -- opening 3: reopen, same bytes; dead shard; restart ------------
        box, reopen3 = open_box()
        second, reopened = driven(lambda: serve(box))
        same(first, second, "reopened serving")
        regen2 = driven(lambda: regenerate(box))
        same(regen1, regen2, "regeneration after reopen")
        cluster = box.backend
        cluster.kill_shard(STORE_DEAD_SHARD)
        third, dead = driven(lambda: serve(box))
        owned = [r for r in third
                 if cluster.shard_of(r.oid) == STORE_DEAD_SHARD]
        need(owned and all(r.failover for r in owned),
             "the dead shard's reads were not served by replicas")
        # the reference's replicas never receive a compaction's lossy
        # transcode (the rewrite keeps its lsn, so nothing is shipped):
        # a replica still holds a "low" object's rung-0 bytes (ROADMAP C).
        # Every image is the healthy serving's, but for such objects of
        # the dead shard, whose image must be the decode of their
        # original latent
        stale = sorted({x.oid for x, y in zip(first, third)
                        if not np.array_equal(x.payload, y.payload)})
        need(all(oid in STORE_LOSSY
                 and cluster.shard_of(oid) == STORE_DEAD_SHARD
                 for oid in stale),
             f"shard {STORE_DEAD_SHARD} dead: images of {stale} differ")
        for oid in stale:
            direct = vae.decode_u8(latents[oid].astype(np.float32)[None])
            served = next(r.payload for r in third if r.oid == oid)
            need(bool(np.array_equal(direct[0].cpu().numpy(), served)),
                 f"failover image of {oid} is not its rung-0 decode")
        dead["stale_lossy_replicas"] = stale
        dead["under_replicated_objects"] = cluster.under_replicated_objects()
        dead["hedges_fired"] = cluster.hedges_fired
        cluster.restart_shard(STORE_DEAD_SHARD)
        fourth, restarted = driven(lambda: serve(box))
        same(first, fourth, f"shard {STORE_DEAD_SHARD} restarted")
        restarted["under_replicated_objects"] = \
            cluster.under_replicated_objects()
        restarted["hedges_fired"] = cluster.hedges_fired
        box.close()
        kill = store_kill_check(torch, np, vae, root, cfg())
    finally:
        tmp.cleanup()
    state["launches"]["store"] = dict(launches)
    path_kernels = {k for k, _ in decode_calls(vae.cfg, LATENT_HW)
                    + encode_calls(vae.cfg, side)} & set(KERNELS)
    need(all(launches[k] > 0 for k in path_kernels),
         f"a kernel of the store path was never launched: {dict(launches)}")
    emit(log, "store", card=state["smi"], image=[side, side],
         shards=STORE_SHARDS, replication=STORE_REPLICATION,
         nodes_per_shard=2, cache_bytes_per_node=6e6,
         latent_puts=STORE_LATENTS, image_puts=STORE_IMAGES,
         recipe_puts=STORE_RECIPES, recipe_only=list(STORE_RECIPE_ONLY),
         lossy_low=list(STORE_LOSSY), requests=STORE_REQUESTS,
         window=SLICE_WINDOW,
         put_ms_per_object={k: statistics.median(v)
                            for k, v in put_ms.items()},
         fsync_latent_put_ms=statistics.median(fsync_ms),
         # the same first puts without fsync, for a like-for-like ratio
         first_latent_puts_ms=statistics.median(
             put_ms["latent"][:STORE_FSYNC_PUTS]),
         flush_ms=flush_ms, reopen=reopen2, reopen_after_serving=reopen3,
         decode_ms_per_image_sharded=sharded_decode,
         decode_ms_per_image_slice=state.get("slice_decode_ms"),
         healthy=healthy, reopened=reopened, dead_shard=dead,
         restarted=restarted, durable=disk,
         durable_bytes_per_object=disk["durable_live_bytes"] / objects,
         uint8_bytes_per_object=image_bytes,
         durable_over_uint8=disk["durable_live_bytes"] / objects
         / image_bytes,
         kill=kill, reopen_bit_identical=True,
         dead_shard_bit_identical=not dead["stale_lossy_replicas"],
         restart_bit_identical=True, regeneration_bit_identical=True,
         launches=dict(launches))


STREAM_LATENTS = 240      # latent puts (oids 0-239)
STREAM_RECIPES = 16       # recipe puts (oids 240-255)
STREAM_RECIPE_ONLY = tuple(range(240, 248))         # demoted to recipe-only
STREAM_REQUESTS = 448     # requests of each trace (512 took 118 s on an H100)
STREAM_SHARDED_REQUESTS = 128
STREAM_SEED = 31          # latents and both traces
STREAM_OVERLOAD = 3.0     # offered decode load over one plant, overload run
STREAM_AUTOSCALE = dict(window=32, cooldown_windows=0)


def phase_stream(torch, log, state):
    """The serving runtime at SD3.5-VAE width, on boxes of 240 latent and
    16 recipe puts (8 left recipe-only, so reads regenerate).  A
    flash-crowd trace served in windows of 8 and, on a fresh box, through
    ``serve_stream`` in drain mode: the same hit class, node and bytes
    for every request.  The card's service model fitted from device ms
    per batch over the buckets and the measured regenerations.  A
    multi-tenant trace through ``serve_stream`` with QoS and admission on
    under that model, at its own rate and at a rate whose offered decode
    load is ``STREAM_OVERLOAD`` plants.  The flash crowd on an engine box
    with ``autoscale=True``, and its first requests on a 2-shard
    autoscaled engine cluster.  Every served image byte-equal to the
    first serving's for its object."""
    np = state["np"]
    from repro_torch.core.autoscale import AutoscaleConfig
    from repro_torch.core.cost_model import params_for_store
    from repro_torch.core.regen_tier import Recipe
    from repro_torch.core.tuner import TunerConfig
    from repro_torch.kernels import ops
    from repro_torch.serve.runtime import (SLO_INTERACTIVE, RuntimeConfig,
                                           requests_from_trace)
    from repro_torch.store import LatentBox, StoreConfig
    from repro_torch.store.api import FULL_MISS, LATENT_HIT, REGEN_MISS
    from repro_torch.trace.synth import make_trace
    t_phase = time.perf_counter()
    vae = state.setdefault("vae", sd35_vae(torch, "cuda"))[0]
    side = 8 * LATENT_HW
    hwc = (LATENT_HW, LATENT_HW, 16)
    n = STREAM_LATENTS + STREAM_RECIPES
    rng = np.random.default_rng(STREAM_SEED)
    latents = [rng.standard_normal(hwc).astype(np.float16)
               for _ in range(STREAM_LATENTS)]
    crowd = make_trace("flash_crowd", n_objects=n,
                       n_requests=STREAM_REQUESTS, seed=STREAM_SEED)
    tenants = make_trace("multi_tenant", n_objects=n,
                         n_requests=STREAM_REQUESTS, seed=STREAM_SEED)
    crowd_ids = [int(o) for o in crowd.object_ids]

    def cfg(**kw):
        # two nodes of 6 MB, as in the slice phase
        return StoreConfig(n_nodes=2, cache_bytes_per_node=6e6,
                           image_bytes=float(side * side * 3),
                           latent_bytes=1.2e5, promote_threshold=2,
                           tuner=TunerConfig(window=10**9),
                           decode_buckets=(1, 2, 4, 8), **kw)

    launches = Counter()

    def driven(fn):
        """Run one piece of the serving path between a reset and a read
        of the launch counts."""
        ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        launches.update(ops.launch_counts())
        return out

    def filled(shards=1, **kw):
        """A fresh box with the phase's corpus: latent and recipe puts,
        the first recipes demoted to recipe-only."""
        box = LatentBox.engine(vae=vae, config=cfg(**kw), shards=shards,
                               device="cuda")

        def puts():
            for oid in range(n):
                if oid < STREAM_LATENTS:
                    box.put(oid, latent=latents[oid])
                else:
                    box.put(oid, recipe=Recipe(seed=3000 + oid, height=side,
                                               width=side, scale=0.5))
            for oid in STREAM_RECIPE_ONLY:
                need(box.demote(oid), f"demote({oid}) refused")
        driven(puts)
        return box

    def windows(box, ids):
        return [r for s in range(0, len(ids), SLICE_WINDOW)
                for r in box.get_many(ids[s:s + SLICE_WINDOW])]

    # -- 1. drain conformance: serve_stream == serve_window ----------------
    box_w = filled()
    box_w.backend.engine.prewarm_decode(hwc)
    t0 = time.perf_counter()
    window = driven(lambda: windows(box_w, crowd_ids))
    window_s = time.perf_counter() - t0
    box_s = filled()
    box_s.backend.engine.prewarm_decode(hwc)
    t0 = time.perf_counter()
    drain = driven(lambda: box_s.serve_stream(
        crowd, RuntimeConfig.conformance(keep_payloads=True)))
    drain_s = time.perf_counter() - t0
    need(drain.outcomes == [(r.hit_class, r.node) for r in window],
         "drain stream classifies unlike serve_window")
    need(len(drain.payloads) == len(window),
         f"drain stream kept {len(drain.payloads)} images of {len(window)}")
    bad = [k for k, r in enumerate(window)
           if r.payload is None or r.payload.shape != (side, side, 3)
           or not np.array_equal(r.payload, drain.payloads[k])]
    need(not bad, f"drain stream images differ at requests {bad[:8]}")
    pixels = {}                    # oid -> the first serving's image
    for r in window:
        pixels.setdefault(r.oid, r.payload)
    regen = [r.latency_ms["regen"] for r in window if r.regenerated]
    need(regen, "no read of the flash crowd regenerated")

    def same_pixels(report, ids, what):
        """Every image of ``report`` equals the first serving's for its
        object; objects that serving never read are read from its box."""
        seen = sorted({ids[k] for k in report.payloads} - set(pixels))
        for r in windows(box_w, seen):
            pixels[r.oid] = r.payload
        bad = sorted({ids[k] for k, px in report.payloads.items()
                      if not np.array_equal(px, pixels[ids[k]])})
        need(not bad, f"{what}: images of {bad[:8]} differ")
        return len(report.payloads)

    # -- 2. the card's service model ----------------------------------------
    buckets = cfg().decode_buckets
    batch_ms = {}
    for b in buckets:
        zb = torch.from_numpy(np.stack(
            [z.astype(np.float32) for z in latents[:b]])).cuda()
        batch_ms[b] = cuda_ms(torch, lambda: vae.decode_u8(zb), 3)
    slope, intercept = np.polyfit(buckets, [batch_ms[b] for b in buckets], 1)
    # host wall ms of the drain stream's batches, dispatch to pixels on
    # the host, per bucket: what the fitted device model leaves out
    served = {b: statistics.median(ms for ms, _ in v) for b, v in
              sorted(box_s.backend.engine.batcher.bucket_ms.items())}
    served_slope, served_intercept = np.polyfit(list(served),
                                                list(served.values()), 1)
    model = {"decode_fixed_ms": max(0.0, float(intercept)),
             "decode_per_image_ms": float(slope),
             "regen_ms": float(statistics.median(regen))}
    nominal = RuntimeConfig.from_store(cfg())

    # -- 3. QoS serving under the fitted model --------------------------------
    tenant_ids = [int(o) for o in tenants.object_ids]
    rcfg = RuntimeConfig.from_store(cfg(), keep_payloads=True, **model)

    def qos_run(trace):
        box = filled()
        t0 = time.perf_counter()
        rep = driven(lambda: box.serve_stream(trace, rcfg))
        wall = time.perf_counter() - t0
        served_images = same_pixels(rep, tenant_ids, "QoS serving")
        c = rep.counters
        need(c["served"] + c["shed"] + c["degraded"] == STREAM_REQUESTS,
             f"requests lost: {c}")
        need(served_images == c["served"],
             f"{c['served']} served but {served_images} images kept")
        summ = rep.summary()
        classes = Counter(h for h, _ in rep.outcomes)
        demand = (model["decode_per_image_ms"]
                  * (classes[LATENT_HIT] + classes[FULL_MISS])
                  + model["regen_ms"] * classes[REGEN_MISS])
        span_ms = float(trace.timestamps[-1] - trace.timestamps[0]) * 1e3
        reqs = requests_from_trace(trace)
        rejected = [r.slo for r, (h, _) in zip(reqs, rep.outcomes)
                    if h in ("shed", "degraded")]
        need(SLO_INTERACTIVE not in rejected,
             "admission rejected an interactive request")
        return {"wall_s": wall, "hit_classes": dict(classes),
                "served_decode_load": demand / span_ms, "summary": summ}

    at_rate = qos_run(tenants)
    # the model's decode demand of the whole trace over its span, in plants
    load_factor = STREAM_OVERLOAD / at_rate["served_decode_load"]
    hot = make_trace("multi_tenant", n_objects=n,
                     n_requests=STREAM_REQUESTS, seed=STREAM_SEED,
                     load_factor=load_factor)
    overload = qos_run(hot)
    c = overload["summary"]
    need(c["shed"] + c["degraded"] > 0,
         f"admission never acted at {STREAM_OVERLOAD} plants of load")

    # -- 4. engine autoscaling ------------------------------------------------
    acfg = AutoscaleConfig(**STREAM_AUTOSCALE,
                           params=params_for_store(cfg()))
    box_a = filled(autoscale=True, autoscale_cfg=acfg)
    eng = box_a.backend.engine
    need(eng.autoscaler is not None, "autoscale=True built no controller")
    t0 = time.perf_counter()
    scaled = driven(lambda: box_a.serve_stream(
        crowd, RuntimeConfig.conformance(keep_payloads=True)))
    scaled_s = time.perf_counter() - t0
    same_pixels(scaled, crowd_ids, "autoscaled serving")
    summ = box_a.summary()
    need(summ["autoscale_windows"] >= STREAM_REQUESTS
         // STREAM_AUTOSCALE["window"] - 1,
         f"the controller stepped {summ['autoscale_windows']} windows")
    autoscaled = {
        "events": [{"window": e.window_index, "action": e.action,
                    "reason": e.reason, "util": e.util,
                    "gpus_per_node": e.state.gpus_per_node,
                    "cache_bytes_per_node": e.state.cache_bytes_per_node}
                   for e in eng.autoscaler.events],
        "hit_classes": dict(Counter(h for h, _ in scaled.outcomes)),
        "wall_s": scaled_s,
        "gpus_per_node": eng.gpus_per_node,
        **{k: summ[k] for k in (
            "scale_up_events", "scale_down_events", "autoscale_windows",
            "autoscale_gpus_per_node", "autoscale_cache_bytes_per_node",
            "decode_gpus", "provisioned_gpu_ms", "decode_util",
            "gpu_seconds")}}

    # -- 5. sharded autoscaling -----------------------------------------------
    box_c = filled(shards=2, autoscale=True, autoscale_cfg=acfg)
    cluster = box_c.backend
    head = crowd_ids[:STREAM_SHARDED_REQUESTS]
    shards_over_time = []

    def sharded():
        out = []
        for s in range(0, len(head), SLICE_WINDOW):
            out += box_c.get_many(head[s:s + SLICE_WINDOW])
            shards_over_time.append(cluster.n_shards)
        return out
    t0 = time.perf_counter()
    res = driven(sharded)
    sharded_s = time.perf_counter() - t0
    bad = sorted({r.oid for r in res
                  if not np.array_equal(r.payload, pixels[r.oid])})
    need(not bad, f"sharded autoscaled serving: images of {bad[:8]} differ")
    csumm = box_c.summary()

    state["launches"]["stream"] = dict(launches)
    path_kernels = {k for k, _ in decode_calls(vae.cfg, LATENT_HW)
                    + encode_calls(vae.cfg, side)} & set(KERNELS)
    need(all(launches[k] > 0 for k in path_kernels),
         f"a kernel of the stream path was never launched: {dict(launches)}")
    emit(log, "stream", card=state["smi"], image=[side, side],
         latent_puts=STREAM_LATENTS, recipe_puts=STREAM_RECIPES,
         recipe_only=list(STREAM_RECIPE_ONLY), requests=STREAM_REQUESTS,
         drain={"window_s": window_s, "stream_s": drain_s,
                "hit_classes": dict(Counter(h for h, _ in drain.outcomes)),
                "dispatches": drain.counters["dispatches"],
                "classes_equal": True, "bytes_equal": True},
         device_batch_ms=batch_ms,
         served_batch_wall_ms=served,
         served_fit={"decode_fixed_ms": float(served_intercept),
                     "decode_per_image_ms": float(served_slope)},
         fitted_model=dict(model, intercept_ms=float(intercept)),
         nominal_model={"decode_fixed_ms": nominal.decode_fixed_ms,
                        "decode_per_image_ms": nominal.decode_per_image_ms,
                        "regen_ms": nominal.regen_ms},
         regenerations=len(regen),
         qos_at_rate=at_rate,
         qos_overload=dict(overload, load_factor=load_factor,
                           offered_decode_load=STREAM_OVERLOAD),
         autoscaled=autoscaled,
         sharded={"requests": len(head),
                  "shards_over_time": shards_over_time, "wall_s": sharded_s,
                  "shard_events": [
                      {"window": e.window_index, "action": e.action,
                       "reason": e.reason, "util": e.util}
                      for e in cluster.autoscaler.events],
                  **{k: csumm[k] for k in (
                      "scale_up_events", "scale_down_events",
                      "autoscale_shards", "autoscale_windows",
                      "decode_util", "provisioned_gpu_ms")}},
         wall_s=time.perf_counter() - t_phase, wall_budget_s=120,
         launches=dict(launches))


def phase_quant(torch, log, state):
    """The quantized read path at SD3.5-VAE width.  Engines opened with
    bf16 weights on the calibrated decoder, int8 on a grid-snapped copy
    and int8 on the calibrated (raw) one: each opens if and only if its
    gate (computed again outside the engine) is at most 1 LSB at every
    bucket.  The bf16 and snapped-int8 configurations then serve a seeded
    Zipf trace of latent puts: through the engine where it opened, else
    window by window through ``VAE.decode_u8`` at that weight dtype, so
    the kernels' quantized cases run either way."""
    np = state["np"]
    from repro_torch.core.tuner import TunerConfig
    from repro_torch.kernels import ops
    from repro_torch.store import LatentBox, StoreConfig
    from repro_torch.vae import quantize as Q
    vae = state.setdefault("vae", sd35_vae(torch, "cuda"))[0]
    side = 8 * LATENT_HW
    rng = np.random.default_rng(29)
    latents = [rng.standard_normal((LATENT_HW, LATENT_HW, 16))
               .astype(np.float16) for _ in range(QUANT_OBJECTS)]
    ranks = np.arange(1, QUANT_OBJECTS + 1, dtype=np.float64)
    p = ranks ** -1.1
    trace = [int(t) for t in rng.choice(QUANT_OBJECTS, QUANT_REQUESTS,
                                        p=p / p.sum())]
    windows = [trace[s:s + SLICE_WINDOW]
               for s in range(0, len(trace), SLICE_WINDOW)]

    def cfg(weight_dtype):
        return StoreConfig(n_nodes=2, cache_bytes_per_node=6e6,
                           image_bytes=float(side * side * 3),
                           latent_bytes=1.2e5, promote_threshold=2,
                           tuner=TunerConfig(window=10**9),
                           decode_buckets=QUANT_BUCKETS,
                           weight_dtype=weight_dtype)

    def open_gated(v, wd):
        """(box or None, outcome, the gate computed outside the engine)."""
        v.set_weight_dtype(wd)
        outside = Q.gate_max_lsb(v, QUANT_BUCKETS, GATE_LATENT)
        rule = "accepted" if max(outside.values()) <= 1 else "refused"
        try:
            box = LatentBox.engine(vae=v, config=cfg(wd), device="cuda")
        except Q.QuantizationGateError:
            box = None
        outcome = "refused" if box is None else "accepted"
        need(outcome == rule, f"{wd}: engine {outcome}, but its gate "
             f"{outside} says {rule}")
        if box is not None:
            gate = box.backend.engine.gate_lsb
            need(gate == outside, f"{wd}: engine gate {gate} != {outside}")
        return box, outcome, outside

    snapped = sd35_vae(torch, "cuda")[0]
    snapped.encoder = None
    Q.snap_to_grid(snapped)
    path = {k for k, _ in decode_calls(vae.cfg, LATENT_HW)}
    runs = {}
    for wd, v, decoder in (("bfloat16", vae, "calibrated"),
                           ("int8", snapped, "calibrated, grid-snapped")):
        box, outcome, gate = open_gated(v, wd)
        if box is not None:
            box.backend.engine.prewarm_decode((LATENT_HW, LATENT_HW, 16))
            for oid, z in enumerate(latents):
                box.put(oid, latent=z)
        else:
            v.decode_u8(np.zeros((1, LATENT_HW, LATENT_HW, 16), np.float32))
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served = []                              # (oid, uint8 HWC pixels)
        hits = Counter()
        for win in windows:
            if box is not None:
                res = box.get_many(win)
                hits.update(r.hit_class for r in res)
                served += [(r.oid, r.payload) for r in res]
            else:
                oids = sorted(set(win))
                imgs = v.decode_u8(np.stack(
                    [latents[o] for o in oids]).astype(np.float32))
                imgs = dict(zip(oids, imgs.cpu().numpy()))
                served += [(o, imgs[o]) for o in win]
        serve_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        state["launches"][f"quant_{wd}"] = launches
        need(all(launches[k] > 0 for k in path),
             f"{wd}: a kernel of the quantized read path was never "
             f"launched: {launches}")
        oracle = {oid: v.decode_u8(latents[oid][None].astype(np.float32),
                                   precision="float32")[0].cpu().numpy()
                  for oid in sorted(set(trace))}
        served_lsb = 0
        for oid, img in served:
            need(img is not None and img.shape == (side, side, 3)
                 and img.dtype == np.uint8, f"{wd}: bad payload for {oid}")
            served_lsb = max(served_lsb, int(np.abs(
                img.astype(np.int16) - oracle[oid].astype(np.int16)).max()))
        # the engine serves only what its gate admitted: within +-1 LSB
        need(box is None or served_lsb <= 1, f"{wd}: served pixels "
             f"{served_lsb} LSB from the fp32-weight decode")
        # bucket 8 bit-identical to batch-1 decodes at this dtype
        z8 = np.stack(latents[:8]).astype(np.float32)
        batch = v.decode_u8(z8).cpu()
        same = [bool(torch.equal(batch[i:i + 1], v.decode_u8(z8[i:i + 1])
                                 .cpu())) for i in range(8)]
        need(all(same), f"{wd}: bucket 8 differs from batch-1: {same}")
        # device ms per image of a full bucket, this dtype and fp32 weights
        device_ms = {}
        for b in QUANT_BUCKETS:
            zb = torch.from_numpy(z8[:b].copy()).cuda()
            ms = cuda_ms(torch, lambda: v.decode_u8(zb), 3)
            ms32 = cuda_ms(torch, lambda: v.decode_u8(zb, precision="float32"),
                           3)
            device_ms[str(b)] = {"per_image_ms": ms / b,
                                 "fp32_per_image_ms": ms32 / b}
        run = dict(decoder=decoder, engine=outcome, gate_lsb=gate,
                   served_by="engine" if box is not None else "decode_u8",
                   serve_s=serve_s, served_max_lsb_vs_fp32=served_lsb,
                   bucket8_bit_identical=same, device_decode_ms=device_ms,
                   launches=launches, decoder_storage=Q.decoder_storage(
                       Q.quantize_decoder(v.decoder, wd)))
        if box is not None:
            summ = box.summary()
            run.update(hit_classes=dict(hits), decodes=summ["decodes"],
                       batches=summ["decode_batches"],
                       quantize_gate_lsb=summ["quantize_gate_lsb"])
        runs[wd] = run
        del box, served, oracle
    need(any(r["engine"] == "accepted" for r in runs.values()),
         "no quantized engine opened: the engine's quantized path did not run")
    del snapped
    torch.cuda.empty_cache()
    # raw int8 on the calibrated (unsnapped) decoder: the gate decides
    _, raw_outcome, raw_gate = open_gated(vae, "int8")
    vae.set_weight_dtype("float32")               # later phases: fp32
    emit(log, "quant", image=[side, side], objects=QUANT_OBJECTS,
         requests=QUANT_REQUESTS, window=SLICE_WINDOW,
         buckets=list(QUANT_BUCKETS), gate_latent=list(GATE_LATENT),
         runs=runs, raw_int8={"engine": raw_outcome, "gate_lsb": raw_gate},
         fp32_storage=Q.decoder_storage(vae.decoder),
         lsb_tol=1, lsb_tol_reason="the engine's open-time gate: quantized "
         "uint8 within +-1 LSB of the fp32-weight decode at every bucket; "
         "a configuration above it is refused")


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
    lms = [crossdevice_lm(torch, state, arch) for arch in CROSS_LMS]
    emit(log, "crossdevice", latent=[16, 16, 16], image=[128, 128],
         trunk_rel_err=rel, float_decode_rel_err=f_rel,
         encode_mean_rel_err=e_rel, tol=1e-4,
         tol_reason="fp32 through 30 convs (decoder) or 22 (encoder), GN "
                    "and attention with other summation orders on the two "
                    "devices; relative to the output's max",
         u8_max_lsb=lsb, u8_tol=1, lms=lms)


#: small fp32 models of each served family for the crossdevice phase
CROSS_LMS = {
    LM_ARCH: dict(n_layers=4, d_model=512, n_heads=8, n_kv_heads=2,
                  d_ff=1024, vocab_size=4096),
    SSM_ARCH: dict(n_layers=4, d_model=512, ssm_head_dim=64, d_ff=1024,
                   vocab_size=4096),
    HYBRID_ARCH: dict(n_layers=4, attn_every=2, d_model=640, n_heads=8,
                      n_kv_heads=8, ssm_head_dim=64, ssm_state=64,
                      d_ff=1024, vocab_size=4096),
}


def crossdevice_lm(torch, state, arch):
    """A small fp32 model of ``arch``'s family (``CROSS_LMS``; the zamba2
    one at head_dim 80) on the card and on the CPU from the same weights:
    prefill of 2 x 45 tokens, then 4 decode steps; logits, and the KV or
    SSM state caches, within 1e-4 of their max (TF32 off)."""
    import dataclasses
    from repro_torch.configs import build_model, get_config
    from repro_torch.models.lm import CausalLM
    from repro_torch.vae.model import map_params
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch), dtype=torch.float32,
                              **CROSS_LMS[arch])
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
        need(errs[-1] <= 1e-4, f"small {arch} logits differ by {errs[-1]} "
             f"(relative) > 1e-4 at position {t}")
        if t < 49:
            gl, gc = gpu.decode_step(gc, toks[:, t])
            cl, cc = cpu.decode_step(cc, toks[:, t])
    leaves = {k: (gc[k], cc[k]) for k in ("k", "shared_k") if k in cc}
    leaves.update({f"ssm.{k}": (gc["ssm"][k], v)
                   for k, v in cc.get("ssm", {}).items()})
    cache_rel = {}
    for key, (g, c) in leaves.items():
        cache_rel[key] = float((g.cpu() - c).abs().max()
                               / max(float(c.abs().max()), 1e-30))
        need(cache_rel[key] <= 1e-4, f"small {arch} cache {key} differs by "
             f"{cache_rel[key]} > 1e-4")
    return {"arch": arch, "config": dict(model_shape(cfg), dtype="float32"),
            "prompt": [2, 45], "decode_steps": 4,
            "logits_rel_err": errs, "cache_rel_err": cache_rel, "tol": 1e-4}


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


def expected_launches(cfg):
    """(per prefill, per decode step) kernel launches of a serving run:
    RWKV-6 one ``rwkv6_scan`` per layer; the hybrid one attention kernel
    per shared-block application (Mamba-2 has no kernel); dense one per
    layer."""
    if cfg.ssm_type == "rwkv6":
        return {"rwkv6_scan": cfg.n_layers}, {"rwkv6_scan": cfg.n_layers}
    n = (cfg.n_layers // cfg.attn_every if cfg.family == "hybrid"
         else cfg.n_layers)
    return {"flash_attention": n}, {"decode_attention": n}


def model_shape(cfg):
    """The widths a serving line reports for ``cfg``."""
    out = dict(layers=cfg.n_layers, d_model=cfg.d_model, d_ff=cfg.d_ff,
               vocab=cfg.vocab_size, tied=cfg.tie_embeddings)
    if cfg.ssm_type == "rwkv6":
        out.update(heads=cfg.d_model // cfg.ssm_head_dim,
                   head_dim=cfg.ssm_head_dim)
        return out
    out.update(heads=[cfg.n_heads, cfg.n_kv_heads], head_dim=cfg.head_dim)
    if cfg.ssm_type == "mamba2":
        d_in = cfg.ssm_expand * cfg.d_model
        out.update(d_inner=d_in, ssm_heads=d_in // cfg.ssm_head_dim,
                   ssm_head_dim=cfg.ssm_head_dim, ssm_state=cfg.ssm_state,
                   conv_width=cfg.conv_width, attn_every=cfg.attn_every,
                   shared_applications=cfg.n_layers // cfg.attn_every)
    return out


def phase_serve(torch, log, state, phase: str):
    """One LM serving path (``SERVE[phase]``) at full width and depth in
    bf16: one prefill of 4 x 2048 seeded tokens, then 64 greedy decode
    steps, each kernel's launches checked exactly; then decode-after-
    prefill logits against a prefill one token longer, in bf16 and in
    fp32 (the same weights cast exactly), and a profiler window of a
    prefill and four steps.  The model is freed on return."""
    import dataclasses
    np = state["np"]
    from repro_torch.configs import build_model, get_config
    from repro_torch.kernels import ops
    from repro_torch.models.lm import CausalLM
    state.pop("vae", None)                      # free the VAE phases' memory
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    arch = SERVE[phase]
    cfg = get_config(arch)
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_bytes = torch.cuda.memory_allocated()
    n_params = model.n_params
    prompts = np.random.default_rng(23).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))
    per_prefill, per_step = expected_launches(cfg)

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
    state["launches"][phase] = launches
    want_prefill = {k: per_prefill.get(k, 0) for k in KERNELS}
    want_all = {k: per_prefill.get(k, 0) + LM_STEPS * per_step.get(k, 0)
                for k in KERNELS}
    need(after_prefill == want_prefill,
         f"{arch} prefill launched {after_prefill}, expected {want_prefill}")
    need(launches == want_all,
         f"{arch} run launched {launches}, expected {want_all}")
    need(tuple(logits.shape) == (LM_BATCH, cfg.vocab_size) and
         bool(torch.isfinite(logits.float()).all()), "bad decode logits")
    need(bool((cache["pos"] == LM_PROMPT + LM_STEPS).all()),
         f"cache positions {cache['pos'].tolist()}")
    peak = torch.cuda.max_memory_allocated()
    cache_bytes = sum(t.numel() * t.element_size() for t in flat_leaves(cache))
    del cache, logits

    # decode_step on x after prefill(p) against the last logits of
    # prefill(p + [x]): 2049 positions
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
    tol, tol_reason = CONSISTENCY_TOL[phase]
    need(err <= tol * scale, f"{arch} decode-after-prefill logits differ "
         f"from a prefill of {LM_PROMPT + 1} tokens by {err} > {tol} * "
         f"{scale}")
    # the same check in fp32, on the bf16 weights cast exactly: the path's
    # own error without bf16 rounding; and how far the bf16 logits of the
    # longer prefill lie from the fp32 ones (the bf16 noise floor)
    twin = CausalLM(dataclasses.replace(cfg, dtype=torch.float32),
                    device="cuda", params=model.params)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    _, c = twin.prefill(prompts, max_len=LM_MAX_LEN)
    ld32, c = twin.decode_step(c, first)
    del c
    lf32, _ = twin.prefill(longer)
    del _, twin
    scale32 = float(lf32.abs().max())
    err32 = float((ld32 - lf32).abs().max())
    floor = float((lf.float() - lf32).abs().max()) / scale32
    need(err32 <= FP32_CONSISTENCY_TOL * scale32, f"{arch} fp32 decode-"
         f"after-prefill logits differ by {err32} > {FP32_CONSISTENCY_TOL} "
         f"* {scale32}")
    steps = LM_BATCH * LM_PROMPT
    emit(log, phase, arch=arch, family=cfg.family, dtype="bfloat16",
         **model_shape(cfg),
         params=n_params, param_count_config=cfg.param_count(),
         weights_bytes=weights_bytes, cache_bytes=cache_bytes,
         init_s=init_s, max_memory_allocated=peak, batch=LM_BATCH,
         prompt=LM_PROMPT, max_len=LM_MAX_LEN, decode_steps=LM_STEPS,
         prefill_ms=prefill_ms, prefill_tokens_per_s=steps / prefill_ms * 1e3,
         warm_prefill_ms=warm_prefill_ms,
         warm_prefill_tokens_per_s=steps / warm_prefill_ms * 1e3,
         decode_step_ms_median=statistics.median(dev),
         decode_step_wall_ms_median=statistics.median(wall),
         decode_step_ms=[round(x, 4) for x in dev],
         decode_tokens_per_s=LM_BATCH / statistics.median(dev) * 1e3,
         launches=launches, launches_after_prefill=after_prefill,
         launches_per_prefill=per_prefill, launches_per_step=per_step,
         first_tokens=first.tolist(),
         profile_prefill=prof_prefill, profile_decode_step=prof_step,
         consistency_max_abs_err=err, consistency_logit_max=scale,
         consistency_rel_err=err / scale, consistency_tol=tol,
         consistency_tol_reason=tol_reason,
         fp32_consistency_rel_err=err32 / scale32,
         fp32_consistency_tol=FP32_CONSISTENCY_TOL,
         fp32_consistency_tol_reason="fp32 with other summation orders in "
                                     "the [4, 1] and [4, 2049] products and "
                                     "kernels (and the one-step against the "
                                     "chunked SSD); relative to the max "
                                     "|logit|",
         bf16_vs_fp32_prefill_rel=floor)


def flat_leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in flat_leaves(v)]
    return [tree]


def run_phase(log, name: str, fn, *args) -> None:
    """Run one phase and print its wall seconds on a line of its own."""
    t0 = time.perf_counter()
    fn(*args)
    emit(log, "timing", of=name, wall_s=time.perf_counter() - t0)


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
    state = {"np": np, "cold": {}}
    with open(OUT_DIR / "chip_smoke.jsonl", "w") as log:
        run_phase(log, "device", phase_device, torch, log, state)
        run_phase(log, "kernels", phase_kernels, torch, log, state)
        run_phase(log, "invariance", phase_invariance, torch, log, state)
        run_phase(log, "slice", phase_slice, torch, log, state)
        run_phase(log, "write", phase_write, torch, log, state)
        run_phase(log, "store", phase_store, torch, log, state)
        run_phase(log, "stream", phase_stream, torch, log, state)
        run_phase(log, "quant", phase_quant, torch, log, state)
        run_phase(log, "crossdevice", phase_crossdevice, torch, log, state)
        for phase in SERVE:
            run_phase(log, phase, phase_serve, torch, log, state, phase)
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
             **({"stats_pass_ms": totals[k]["stats_pass_ms"]}
                if k in GN_KERNELS else {}),
             "library_ms": (None if k in NO_LIBRARY
                            else totals[k]["library_ms"]),
             "design": DESIGN[k], **state["cold"].get(k, {})}
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
