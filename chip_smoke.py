#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's read path, its write and regeneration
path, its persistent sharded store, its serving runtime, its launcher,
quickstart and decode cost model, its LM serving paths (dense, RWKV-6,
Mamba-2 hybrid, MoE, VLM, enc-dec, and kimi-k2's 384-expert MoE) and its
training loop on one NVIDIA GPU and hold every Hopper kernel against its
plain PyTorch version.

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
                shared-block attention shapes (head_dim 80), at
                mixtral-8x7b's, qwen2-vl-72b's and kimi-k2-1t-a32b's
                (bf16; kimi-k2's head_dim 112), at whisper-large-v3's (head_dim 64: the encoder's non-causal
                1500 x 1500, the decoder's causal 384 x 384 and its
                cross-attention of 384 queries over 1500 keys; the decode
                step's self-attention over 448 slots and cross-attention
                at length 1500; bf16, the cross shapes also fp32), and
                ``rwkv6_scan`` at the rwkv6-7b prefill's shape (with and
                without an initial state, and with decays from w = -10 to
                w = 4) and decode step's (t = 1, the state updated in
                place): max error and tolerance, median
                ms (CUDA events; for the LM shapes the kernels' device
                time under ``torch.profiler``; for the decode attention
                also with a cold L2, ``cold_ms``, beside SDPA's, and a
                ``decode_case`` line a case: kernel, cold, SDPA and bound
                ms, the bound's share, the grid, the cluster, the CTAs an
                SM holds, ``cudaOccupancyMaxActiveClusters`` and whether
                p v runs on the tensor cores), the
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
                ``downsample``'s ms per encode.  The upsampler's ``ms``
                is its launch from taps collapsed beforehand (what a
                decode runs: the serving tree holds them; also
                ``kernel_ms``), beside ``phase_collapse_ms`` (a per-call
                collapse alone) and ``per_call_collapse_ms`` (the wrapper
                that collapses on every call).  First, one ``wgmma`` TF32
                product through the conv tile's operand layouts, and one
                of each product of ``flash_attention``'s fp32 kernel above
                head dim 128 (P V with P from registers and V transposed;
                q k^T), of its bf16 TMA kernel at each head dim, and of
                the two product forms of its backward (``a b^T`` with both
                operands in shared memory, ``P c`` with P from registers)
                at head dims 128, 112, 80, 64 and 32, against the float64
                products (``wgmma_probe`` lines).  The
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
                weights, ``decoder_storage`` of the serving tree beside
                the stored one's and the bytes of every decoder tree the
                VAE holds (each tensor once); then a raw int8 engine on
                the unsnapped decoder, accepted or refused as its gate
                says;
9. autotune    the kernel autotuner at SD3.5-VAE width on a 64x64x16
                latent: ``KernelAutotuner`` from an empty cache over
                buckets 1 and 8 in fp32 (22 keys; for each, its candidate
                launches, each one's output equal to the default's under
                ``torch.equal``, ``default_us``, the winner's ``us`` and
                knob, the seconds it took); ``decode_u8`` with the tuned
                cache active against without it at buckets 1 and 8 (bit
                for bit, bucket 8 equal to eight batch-1 decodes under the
                cache, device ms per image of each arm as interleaved A/B
                medians by CUDA events); tune-on-first-miss on
                ``LatentBox.open(..., StoreConfig(autotune=True,
                decode_buckets=(1, 2)), device="cuda")`` from an empty
                cache over a seeded Zipf trace until nothing is pending
                (the ms each maintenance step spent tuning, max and sum),
                closed, reopened with the same entries active, every
                image served byte-equal to the first serving's, each
                kernel's launches (all > 0), the phase's wall seconds
                (budget 90);
10. launch      the launch layer: ``repro_torch.launch.serve.main`` at its
                defaults on the card (its ``[serve]`` lines, each
                kernel's launches, all > 0 for the six of the decode and
                the recipe put's encode); ``examples/quickstart_torch.py``
                in a child process on the card (exit 0: its cached and
                regenerated reads bit-identical to the first); the
                analytic decode model (``repro_torch.vae.serve``) beside
                the card at SD3.5-VAE width: 512x512 at buckets 1 and 8
                and 1024x1024 at bucket 1, the model's FLOPs and bytes
                (bf16 and fp32), the sum of ``work`` over
                ``decode_calls``, ``decode_ms_estimate``, the device ms
                per image (CUDA events around ``decode_u8``), the
                achieved TFLOP/s and its share of ``PEAK_FLOPS_TF32 /
                3``; the bucket-8 512x512 images' raw, ``png_like_size``,
                ``jpeg_like`` (quality 95) and fp16 latent blob bytes;
                the phase's wall seconds (budget 60);
11. crossdevice the same VAE at a 16x16 latent and a 128x128 image on the
                GPU and on the CPU (the plain path): uint8 within +-1 LSB,
                float trunk, float decode and encoder mean within a
                relative tolerance; and small fp32 qwen2-, RWKV-6-, zamba2-,
                mixtral- (at the published capacity factor 1.25, so its
                decode steps drop entries), qwen2-vl- (7 seeded embeds
                first), whisper-family (150 seeded frames) and kimi-k2
                (head_dim 112, 384 experts, top-8, capacity factor 1.25:
                the twin its serving phase cannot hold) LMs' prefill
                and decode steps, logits and every cache leaf within a
                relative tolerance, the positions equal;
12. lm          the LM serving paths: ``build_model`` of Qwen2-7B,
13. ssm         rwkv6-7b, zamba2-2.7b, mixtral-8x7b (4 of its 32 layers),
14. hybrid      qwen2-vl-72b (4 of its 80 layers) and whisper-large-v3,
15. moe         at full width in bf16 (seeded random weights; the depth
16. vlm         cuts in ``DEPTH_CUT``, printed under ``reduced``), each
17. encdec      freed before the next is built: a prefill of 4 seeded
                sequences (2048 tokens; the VLM 256 seeded vision embeds
                and 1792 tokens; the enc-dec 1500 seeded frames and 384
                tokens), 64 greedy ``decode_step``s: parameters, peak
                memory, prefill and decode-step ms and tokens/s, each
                kernel's launches (checked exactly per prefill and per
                step), decode-after-prefill logits against a prefill one
                token longer (bf16, and fp32 on the same weights cast
                exactly; the MoE's at capacity factor E / k, where nothing
                drops, its bf16 figure ungated, and its expert capacity at
                the timed prefill and step), and a ``torch.profiler``
                window of a prefill and four steps (device-busy share, top
                kernels);
18. kimi        kimi-k2-1t-a32b at full width, 1 of its 61 layers
                (``DEPTH_CUT``; 38.8 GB of bf16), served as above with
                the launches checked exactly, but with no fp32 twin
                (``NO_TWIN``: it would not fit): its first layer's MoE on
                4 x 16 seeded bf16 tokens against an fp32 per-token
                reference routed by the layer's own router, at capacity
                factor E / k and at the published 1.25 (the rule's
                entries dropped), within 2e-2 of the reference's max;
                decode after a 4 x 64 prefill at capacity factor E / k,
                reported and not gated;
19. dist        sharded layouts and RWKV-6 training on the card: (c)
                ``make_decode_step(SD35_VAE, make_local_mesh())`` at
                bucket 8, 512x512, its pixels bit-identical to the
                unsharded step's; (a) rwkv6-7b at full width, 2 of 32
                layers, bf16, 3 AdamW steps of 2 x 512 tokens (finite
                losses, ``rwkv6_scan`` launches per step = layers x 2
                with remat, ``rwkv6_scan_bwd`` launches = layers; each
                step's device ms and one step's profile: the backward
                kernels' device ms), and ``RWKV6Scan`` at the training
                shape, r, k, v [2, 64, 512, 64] bf16: its gradients
                (the backward kernel of ``csrc/rwkv6_scan_bwd.cu``)
                against fp32 autograd through the sequential plain scan,
                the kernel against ``ref.rwkv6_scan_bwd_ref`` on the same
                tensors, each 64-token block of dr, dk, dv and dw within
                the tolerance of its own max, two backward calls bit for
                bit; the forward kernel's, the backward kernel's and the
                plain backward's ms beside the bound; (b) Qwen2-7B at full
                width, 2 of 28 layers, 2 steps of 2 microbatches,
                unsharded and then on the (1, 1) NCCL mesh with ZeRO-1
                moments and the "local" gradient plan: losses and
                parameters bit for bit, the same ``flash_attention``
                launches, both steps' device ms; (d) ``prefill`` of 2 x
                1024 tokens on the trained weights, plain and on their
                DTensor copy over that mesh (the cache laid out by
                ``cache_pspecs``): logits and cache bit for bit, the
                same launches, both prefills' ms; (e)
                ``decode_attention_partial`` at Qwen2-7B's decode shape
                (fp32 and bf16) against its plain version, and its slots
                split into 16 ranges, each through the partial kernel,
                merged by ``ops.merge_partials`` against one
                ``decode_attention`` call (fp32 1e-5 of the output's max,
                bf16 one ulp of each output), the partial and default
                forms' device ms at the whole shape with the partial
                form's bound; (f) Qwen2-7B and rwkv6-7b at full width (4
                layers each), a prefill of 4 x 512 tokens and 8 greedy
                ``decode_step`` calls plain and then over the (1, 1)
                mesh on a DTensor copy of the weights: logits and cache
                bit for bit, one kernel launch a layer a step, each
                step's ms both ways;
20. train       training on one card: a CUDA wrapper with no backward
                (``conv3x3``) refuses an input that requires grad, and
                ``rwkv6_scan`` under grad launches once through
                ``RWKV6Scan`` (f); ``FlashAttention`` forward and backward
                (both kernels) at a training call's shapes, q [2, 28,
                2048, 128] and k, v [2, 4, 2048, 128] bf16 causal, against
                fp32 autograd through the plain version and the backward
                kernel against ``flash_attention_bwd_ref`` on the same
                tensors, two backward calls bit for bit (a), with the
                forward's, the backward's, the plain backward's and SDPA's
                forward plus backward ms beside the bounds; small fp32 dense, RWKV-6, MoE
                (capacity factor E / k), VLM, hybrid and enc-dec models'
                loss and every gradient leaf on the card against the CPU
                (b; RWKV-6's ill-conditioned gradients at their own
                tolerance, beside the CPU's spread over thread counts);
                Qwen2-7B at full width, cut to 4 of 28 layers
                (``DEPTH_CUT``), bf16, ``Trainer.run`` for 8 AdamW steps
                of 4 x 2048 Zipf tokens in 2 microbatches with remat and
                async checkpoints every 4, then a second trainer resumed
                from step 4 whose losses match the first run's (c),
                finite losses that fall (d), ``flash_attention`` launches
                per step = layers x microbatches x 2 (e); step wall and
                device ms, tokens/s, TFLOP/s and its share of the bf16
                peak, peak memory, checkpoint bytes and a profile of one
                step (the kernel's forward, the plain attention backward,
                other GEMMs, AdamW, the rest).

Then a ``{"kernels": [...]}`` summary line (times summed over one uint8
decode, one encode and one float decode of a 512x512 image, and one
prefill and one decode step of each LM; launches summed over the slice,
write, store, stream, quant, autotune, launch, the seven serving phases,
every run of the dist phase and the train phase's first run; the card's
peaks from ``repro_torch.launch.mesh.card_peaks``).  The partial form's
wrapper counts its launches as ``decode_attention``'s, but none reaches
the line: (e) launches it only to check and time it against its plain
version, and on one card (f)'s model axis has extent 1, so its decode
steps never split the slots and run the default form.  Then the
``nvidia-smi`` name and
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
MOE_ARCH = "mixtral-8x7b"
VLM_ARCH = "qwen2-vl-72b"
ENCDEC_ARCH = "whisper-large-v3"
KIMI_ARCH = "kimi-k2-1t-a32b"
LM_BATCH = 4
LM_PROMPT = 2048          # prompt tokens per sequence
LM_MAX_LEN = 2112         # KV-cache slots: prompt + 64 steps
LM_STEPS = 64             # greedy decode steps
LM_WINDOW = 512           # the sliding-window kernel case
DECODE_LENGTHS = (2049, 2080, 1500, 7)    # ragged cache lengths, one step
VLM_PREFIX = 256          # seeded vision embeds before each VLM prompt
ENCDEC_PROMPT = 384       # decoder prompt tokens of the enc-dec phase
ENCDEC_MAX_LEN = 448      # its self-attention slots: Whisper's published
                          # max_target_positions, prompt + 64 steps
ENCDEC_LENGTHS = (385, 448, 416, 400)     # ragged self-attention lengths
VAE_PASSES = ("decode", "encode", "float_decode")
#: each LM serving phase -> the model it serves
SERVE = {"lm": LM_ARCH, "ssm": SSM_ARCH, "hybrid": HYBRID_ARCH,
         "moe": MOE_ARCH, "vlm": VLM_ARCH, "encdec": ENCDEC_ARCH,
         "kimi": KIMI_ARCH}
#: serving phases whose fp32 twin does not fit beside the bf16 model: their
#: checks are ``no_twin_checks``'s
NO_TWIN = ("kimi",)
#: serving phases cut in depth (full width): phase -> (layers, why)
DEPTH_CUT = {
    "moe": (4, "mixtral-8x7b is 93.4 GB of bf16 weights at its 32 layers, "
               "more than one 80 GB card; 4 layers are 12.1 GB, and the "
               "fp32 twin of the consistency check adds 24.3 (at 8 layers "
               "the two would need about 72 GB)"),
    "vlm": (4, "qwen2-vl-72b is 145 GB of bf16 weights at its 80 layers; 4 "
               "layers and the embeddings are 12.0 GB, and the fp32 twin "
               "adds 24"),
    "kimi": (1, "kimi-k2-1t-a32b is about 2 TB of bf16 weights at its 61 "
                "layers; one layer and the embeddings are 38.8 GB (its 384 "
                "experts 33.8), two 72.8, which leaves too little of an "
                "80 GB card for the prefill and the checks; no fp32 twin "
                "fits beside either (NO_TWIN)"),
}
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
    "moe": (None, "not gated in bf16: under bf16 rounding a near-tie in the "
                  "router can send a token to another expert in the [4, 1] "
                  "step than in the [4, 2049] prefill (about 1 % a token "
                  "and layer), which moves its logits by O(1); the fp32 "
                  "twin is gated, both at capacity factor E / k, where "
                  "nothing drops"),
    "vlm": (2e-2, _BF16.replace("[4, 2049]", "[4, 2049] (256 embeds + 1793 "
                                "tokens)")),
    "encdec": (2e-2, _BF16.replace("[4, 2049]", "[4, 385]") + "; the "
               "encoder's 32 layers see the same frames in both"),
    "kimi": (None, "not gated in bf16, as the moe phase, for the same "
                   "router near-ties (384 experts, top-8), over a prompt of "
                   "KIMI_PROMPT tokens: at capacity factor E / k the "
                   "full prompt's expert slots would take 45 GB; no fp32 "
                   "twin fits, so the MoE layer is gated against an fp32 "
                   "per-token reference instead (KIMI_MOE_TOL)"),
}
FP32_CONSISTENCY_TOL = 1e-3
#: no_twin_checks: the prompt of its decode-after-prefill check, the
#: [batch, seq] of seeded bf16 activations its MoE check takes, their seed,
#: and that check's tolerance
KIMI_PROMPT = 64
KIMI_MOE_TOKENS = (4, 16)
KIMI_MOE_SEED = 43
KIMI_MOE_TOL = (2e-2, "bf16 expert products, SiLU and gate sums against "
                      "fp32 throughout, on the same bf16 inputs and weights "
                      "and the same routing; relative to the reference's "
                      "max |value|")

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
    # the gradient of that kernel: the JAX package has no Pallas backward
    # (jax.grad differentiates its XLA reference)
    "flash_attention_bwd": ("src/repro_torch/kernels/csrc/"
                            "flash_attention_bwd.cu",
                            "src/repro/kernels/flash_attention.py:78"),
    "group_norm_silu": ("src/repro_torch/kernels/csrc/gn_silu.cu",
                        "src/repro/kernels/gn_silu.py:63"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:62"),
    "rwkv6_scan": ("src/repro_torch/kernels/csrc/rwkv6_scan.cu",
                   "src/repro/kernels/rwkv6_scan.py:55"),
    # the gradient of that kernel: the JAX package has no Pallas backward
    # (jax.grad differentiates its chunked XLA form, models/ssm.py's
    # rwkv6_chunked)
    "rwkv6_scan_bwd": ("src/repro_torch/kernels/csrc/rwkv6_scan_bwd.cu",
                       "src/repro/kernels/rwkv6_scan.py:55"),
}
#: kernel -> what its CUDA source runs on
DESIGN = {
    "conv3x3": "3xTF32 mma.sync implicit GEMM (tc_conv_tile.cuh): Cout > 32 "
               "on the 128-wide tile, 4 < Cout <= 32 on the 32-wide tile with "
               "K split over a CTA cluster and a DSMEM merge; Cout <= 4 on the "
               "CUDA-core fp32 tile",
    "gn_silu_conv3x3": "3xTF32 wgmma m64n128k8 TF32 implicit GEMM, both "
                       "operands K-major in shared memory (wg_conv_tile.cuh): "
                       "a weights warpgroup (cp.async ring, split hi/lo "
                       "K-major) and a halo warpgroup (cp.async two chunks "
                       "ahead, GN + SiLU, split hi/lo) feed two consumer "
                       "warpgroups of 64 pixels x 128 channels through "
                       "mbarriers, registers moved by setmaxnreg; a chain of "
                       "one 16-channel chunk per fresh accumulator",
    "upsample_conv3x3": "3xTF32 wgmma m64n128k8 TF32 implicit GEMM "
                        "(wg_conv_tile.cuh, as gn_silu_conv3x3's with no "
                        "prologue), phase form: a block per phase, its 4 "
                        "collapsed 2x2 taps (collapsed once in the serving "
                        "tree)",
    "output_epilogue": "coalesced GN statistics pass (gn_stats.cu), then a "
                       "16x32 tile x 3 outputs a block of 512 threads: the "
                       "whole filter in shared memory once, the halo by "
                       "cp.async in 16-channel chunks through a three-stage "
                       "ring, one barrier a chunk, GN + SiLU once per halo "
                       "element, CUDA-core fp32 products, packed "
                       "uint8 stores",
    "flash_attention": "bf16 up to d 128, two routes by shape and alignment "
                       "(each kernel line's route): bf16_tma (d % 8 == 0, "
                       "16-byte-aligned operands: every model) a persistent "
                       "CTA an SM drawing 128-row blocks from a counter, a "
                       "TMA producer warp, 128 x 128 tiles in a 3-stage "
                       "128-byte-swizzled ring, two consumer warpgroups on "
                       "wgmma m64n128k16 (S, both operands in shared "
                       "memory) and m64ndk16 (P V, P from registers), S of "
                       "the next tile issued before P V, the consumers "
                       "taking the tensor cores in turns; bf16_cp_async "
                       "(the rest) wgmma m64n64k16 with Q and P from "
                       "registers, cp.async 64-key tiles; fp32 up to d 128: "
                       "3xTF32 mma.sync; fp32 "
                       "(and bf16) above d 128: 3xTF32 wgmma TF32, a CTA "
                       "cluster of d/128 per 64 query rows, one S per "
                       "(row block, 64-key tile) from parts over 128-column "
                       "slices of d summed by a DSMEM reduce-scatter and "
                       "all-gather in rank order, P V with P from registers, "
                       "a producer warpgroup splitting Q once and K/V per "
                       "tile",
    "flash_attention_bwd": "FlashAttention-2's backward in three launches "
                           "and a sum, fixed order, no atomics: the rows' "
                           "lse and rowsum(dO O) recomputed (a block per "
                           "128 query rows over 64-key tiles); dK and dV a "
                           "block per 128 keys (two consumer warpgroups of "
                           "64) over the kv head's q-head group and its "
                           "64-row query tiles, dealt to parts where the "
                           "grid is short, fp32 partials summed in order; "
                           "dQ a block per 128 rows; bf16 on wgmma "
                           "m64n64k16 (S, S^T, dP, dP^T with both operands "
                           "in shared memory) and m64ndk16 (dV, dK, dQ with "
                           "P or dS from registers, rounded to bf16), "
                           "tiles by TMA (64 x 64 boxes, 128-byte swizzle) "
                           "into mbarrier rings, masks only on the tiles "
                           "that cross an edge, the warpgroups issuing in "
                           "turns; fp32 in 3xTF32 on mma.sync",
    "group_norm_silu": "coalesced GN statistics pass (gn_stats.cu), then a "
                       "float4 apply with four loads in flight a thread "
                       "(CUDA-core fp32; streaming stores above 32 MB)",
    "decode_attention": "one launch: a CTA cluster per (sequence, kv head) "
                        "splitting its rows; in each CTA a producer thread "
                        "loads a stage's rows by TMA (a box a 128-byte "
                        "column box, 128-byte swizzle) into a ring sized "
                        "for two CTAs an SM (four at rep 1), and consumer "
                        "warps (4; 8 for the CUDA-core p v of grouped "
                        "heads) keep fp32 online softmaxes in base 2 over "
                        "their rows of each stage; bf16 on mma.sync (q k^T; "
                        "p v at rep > 1 and d % 16 == 0 up to 128, p split "
                        "exactly into 3 bf16 parts packed into two products "
                        "a tile), rows past the length -inf in the scores "
                        "and zero in the V fragments; the warps merged in "
                        "the CTA, each CTA's part sent by st.async onto the "
                        "owning CTAs' barriers and merged there in a fixed "
                        "order; a partial form (fp32 rows and their "
                        "log-sum-exp) for slots split over ranks",
    "rwkv6_scan": "prefill (t > DECODE_MAX_T): chunked and state-resident, "
                  "a block per (sequence, head, 64 value columns), 16-token "
                  "sub-chunks, the inter, intra and state products in 3xTF32 "
                  "on mma.sync, pairwise decay products on the CUDA cores, "
                  "cp.async staging; decode: the whole state in the "
                  "registers of 8 warps, 16-byte loads, fixed-order "
                  "shuffles (CUDA-core fp32)",
    "rwkv6_scan_bwd": "three launches, fixed order, no atomics: the "
                      "forward's own chunked walk writes the state at "
                      "every 16-token sub-chunk's start (n h (t/16 + 1) d^2 "
                      "fp32 scratch); a block per (sequence, head, value "
                      "columns: d up to 64 in one) walks the sub-chunks "
                      "from last to first with dS^T resident in fp32 "
                      "registers, the stored state staged by cp.async a "
                      "sub-chunk ahead, dv = dS^T (k E)^T + dO^T A, X = dO "
                      "S0^T, Y = v dS and the update dS^T D_16 + dO^T (r D) "
                      "in 3xTF32 on mma.sync (bf16 dO and v exact: two "
                      "products), the pairwise decays, B = dO v^T, the "
                      "intra sums, the u terms and the dw carry (restarted "
                      "from rowsum(S dS) at each sub-chunk's end) on the "
                      "CUDA cores; a pass sums du over the sequences (and "
                      "value-column tiles above d 64)",
}
#: kernels whose fp32 work runs in 3xTF32 on the tensor cores: their
#: bound counts three TF32 products per fp32 one at the TF32 peak (a conv
#: with Cout <= CUDA_CORE_COUT runs on the CUDA cores, at the fp32 peak)
TENSOR_CORE = ("conv3x3", "gn_silu_conv3x3", "upsample_conv3x3",
               "flash_attention", "flash_attention_bwd", "rwkv6_scan",
               "rwkv6_scan_bwd")
CUDA_CORE_COUT = 4
#: the conv kernels that take quantized weights, and the storage dtypes
QUANT_KERNELS = ("conv3x3", "gn_silu_conv3x3", "upsample_conv3x3",
                 "output_epilogue")
WEIGHT_DTYPES = ("float32", "bfloat16", "int8")
#: kernels that run the GroupNorm statistics pass (``gn_stats.cu``) first
GN_KERNELS = ("gn_silu_conv3x3", "output_epilogue", "group_norm_silu")
#: kernels no single PyTorch call computes (``library_ms`` null)
NO_LIBRARY = {"rwkv6_scan": "no single PyTorch call computes the RWKV-6 "
                            "recurrence",
              "rwkv6_scan_bwd": "no single PyTorch call computes RWKV-6's "
                                "backward"}


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
    from repro_torch.launch.mesh import card_peaks
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
    """The upsampler's costs apart: ms of a per-call phase collapse of a
    stored filter alone (tensor additions on the card), of the wrapper
    that collapses on every call (``upsample_conv3x3``,
    ``per_call_collapse_ms``), and of the kernel launch alone from taps
    collapsed beforehand (``upsample_conv3x3_taps``, ``kernel_ms``), which
    is what a decode runs since its serving tree holds the taps: the
    row's ``ms``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.upsample_conv import (upsample_conv3x3,
                                                   upsample_conv3x3_taps)
    wc = ref.storage_phase_weights(w).contiguous()
    kernel_ms = cuda_ms(
        torch, lambda: upsample_conv3x3_taps(x, wc, b, w_scale), REPS)
    return {"phase_collapse_ms": cuda_ms(
                torch, lambda: ref.storage_phase_weights(w), REPS),
            "per_call_collapse_ms": cuda_ms(
                torch, lambda: upsample_conv3x3(x, w, b, w_scale), REPS),
            "kernel_ms": kernel_ms}


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
            ms = extra["kernel_ms"]          # a decode launches from taps
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
        row["ms"] = extra["kernel_ms"]       # a decode launches from taps
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


def tf32_rna(torch, x):
    """fp32 -> tf32 as ``cvt.rna`` rounds (ties away from zero, 13 low bits
    cleared), on the CPU."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    out = (bits & 0x80000000) | (((bits & 0x7FFFFFFF) + 0x1000) & 0x7FFFE000)
    out = torch.where(out >= 2 ** 31, out - 2 ** 32, out)
    return out.to(torch.int32).view(torch.float32)


def wgmma_probe_check(torch, log):
    """One ``wgmma`` m64n128k8 TF32 product through the warpgroup conv
    tile's operand layouts (A as a halo plane, B as a weight slot) on
    TF32-exact inputs: each product is exact in fp32, so it is the float64
    product up to the fp32 sum of eight terms."""
    from repro_torch.kernels.gn_silu_conv import wgmma_tf32_probe
    g = torch.Generator().manual_seed(77)
    a = tf32_rna(torch, torch.randn(64, 8, generator=g))
    b = tf32_rna(torch, torch.randn(8, 128, generator=g))
    got = wgmma_tf32_probe(a.cuda(), b.cuda()).cpu().double()
    want = a.double() @ b.double()
    err = float((got - want).abs().max())
    tol = 8 * 2.0 ** -23 * float((a.double().abs() @ b.double().abs()).max())
    emit(log, "wgmma_probe", shape=[64, 128, 8], max_abs_err=err, tol=tol)
    need(err <= tol, f"wgmma TF32 probe: max error {err} > {tol}")


def flash_wide_probe_check(torch, log):
    """One ``wgmma`` of each product of ``flash_attention``'s fp32 kernel
    above head dim 128, through its operand layouts, on TF32-exact inputs:
    P V with P [64, 8] from registers in the accumulator layout of S and V
    [8, 128] transposed with its keys permuted (two m64n64k8), and q k^T
    with q and k [64, 8] K-major (m64n64k8).  Each is the float64 product
    up to the fp32 sum of eight terms."""
    from repro_torch.kernels.flash_attention import wide_probe
    g = torch.Generator().manual_seed(78)
    p, v, q, k = (tf32_rna(torch, torch.randn(*s, generator=g))
                  for s in ((64, 8), (8, 128), (64, 8), (64, 8)))
    o, s = wide_probe(p.cuda(), v.cuda(), q.cuda(), k.cuda())
    for name, got, a, b in (("p_v", o, p, v), ("q_kT", s, q, k.T)):
        want = a.double() @ b.double()
        err = float((got.cpu().double() - want).abs().max())
        tol = 8 * 2.0 ** -23 * float((a.double().abs() @ b.double().abs()).max())
        emit(log, "wgmma_probe", product=name, shape=list(got.shape) + [8],
             max_abs_err=err, tol=tol)
        need(err <= tol, f"flash_attention wgmma probe {name}: max error "
             f"{err} > {tol}")


#: head dims of the bf16 TMA probe: each of the kernel's instantiations
#: (64 also stands for d 8 and 32, 96 for 88)
BF16_PROBE_DIMS = (128, 112, 96, 80, 64, 32)


def flash_bf16_probe_check(torch, log):
    """One ``q k^T`` and one ``P V`` of ``flash_attention``'s ``bf16_tma``
    kernel through its TMA boxes, 128-byte swizzle and operand layouts, at
    each head dim of ``BF16_PROBE_DIMS``, on bf16-exact inputs (and so
    TF32-exact: multiples of 1/8 up to 1): every product is exact, so each
    sum is the float64 product up to its fp32 roundings."""
    from repro_torch.kernels.flash_attention import bf16_probe
    g = torch.Generator().manual_seed(79)
    for d in BF16_PROBE_DIMS:
        q, k, p, v = (torch.randint(-8, 9, s_, generator=g).float() / 8
                      for s_ in ((64, d), (128, d), (64, 128), (128, d)))
        s, o = bf16_probe(*(t.bfloat16().cuda() for t in (q, k, p, v)))
        for name, got, a, b in (("q_kT", s, q, k.T), ("p_v", o, p, v)):
            want = a.double() @ b.double()
            err = float((got.cpu().double() - want).abs().max())
            tol = a.shape[1] * 2.0 ** -24 * float(
                (a.double().abs() @ b.double().abs()).max())
            emit(log, "wgmma_probe", kernel="flash_attention bf16_tma",
                 product=name, d=d, shape=list(got.shape) + [a.shape[1]],
                 max_abs_err=err, tol=tol)
            need(err <= tol, f"flash_attention bf16 probe {name} at d {d}: "
                 f"max error {err} > {tol}")


#: head dims of the backward's probe: each of its instantiations (DP 128,
#: 80, 64) and the zero-padded lanes of d 112 and 32
BWD_PROBE_DIMS = (128, 112, 80, 64, 32)


def flash_bwd_probe_check(torch, log):
    """One product of each form of ``flash_attention``'s bf16 backward
    through its layouts and helpers, at each head dim of
    ``BWD_PROBE_DIMS``, on bf16-exact inputs (multiples of 1/8 up to 1):
    ``a [64, d] b [64, d]^T`` with both operands K-major in shared memory
    (the form of S = Q K^T, S^T = K Q^T, dP = dO V^T and dP^T = V dO^T),
    and ``p [64, 64] c [64, d]`` with p from registers in S's accumulator
    layout and c MN-major (the form of dV += P^T dO, dK += dS^T Q and
    dQ += dS K).  Every product and sum is exact in fp32."""
    from repro_torch.kernels.flash_attention_bwd import probe as bwd_probe
    g = torch.Generator().manual_seed(80)
    for d in BWD_PROBE_DIMS:
        a, b, p, c = (torch.randint(-8, 9, s_, generator=g).float() / 8
                      for s_ in ((64, d), (64, d), (64, 64), (64, d)))
        s, o = bwd_probe(*(t.bfloat16().cuda() for t in (a, b, p, c)))
        for name, got, x, y in (("a_bT", s, a, b.T), ("p_c", o, p, c)):
            want = x.double() @ y.double()
            err = float((got.cpu().double() - want).abs().max())
            emit(log, "wgmma_probe", kernel="flash_attention_bwd",
                 product=name, d=d, shape=list(got.shape) + [x.shape[1]],
                 max_abs_err=err, tol=0.0)
            need(err == 0.0, f"flash_attention_bwd probe {name} at d {d}: "
                 f"max error {err}, not exact")


def phase_kernels(torch, log, state):
    from repro_torch.vae.model import SD35_VAE
    image_hw = 8 * LATENT_HW
    byte_peak = state["peaks"][1]
    wgmma_probe_check(torch, log)
    flash_wide_probe_check(torch, log)
    flash_bf16_probe_check(torch, log)
    flash_bwd_probe_check(torch, log)
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
    decode step, 9 calls each per pass, bf16.  mixtral-8x7b (32 q over 8
    kv heads of 128, window 4096) and qwen2-vl-72b (64 over 8; 256 embeds
    and 1792 tokens) and kimi-k2-1t-a32b (64 over 8 of 112: the bf16
    flash tile's zero-padded lanes, and the decode's tensor-core p v at d
    112) at the depth of their phases: the causal prefill and the decode
    step, bf16.  whisper-large-v3 (20 heads of 64 over 20): the
    encoder's non-causal 1500 x 1500, the decoder's causal 384 x 384 and
    its cross-attention, non-causal 384 queries over 1500 keys (32 calls
    each per prefill); the decode step's self-attention against 448 slots
    and its cross-attention at length 1500 (32 each per step); bf16, and
    the two cross shapes also in fp32 (checked, in no pass)."""
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
    # a training step's attention forward (TRAIN_ATTENTION), in no pass
    cases.append((LM_ARCH, "flash_attention",
                  dict(prefill, n=TRAIN_ATTENTION[0][0], window=None),
                  "bfloat16", {}))
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
    for phase in ("moe", "vlm", "kimi"):
        c = serve_config(get_config, phase)
        n, hq, hkv, d = LM_BATCH, c.n_heads, c.n_kv_heads, c.head_dim
        cases.append((SERVE[phase], "flash_attention",
                      dict(n=n, hq=hq, hkv=hkv, sq=LM_PROMPT, skv=LM_PROMPT,
                           d=d, causal=True, window=c.sliding_window),
                      "bfloat16", {f"{phase}_prefill": c.n_layers}))
        cases.append((SERVE[phase], "decode_attention",
                      dict(n=n, hq=hq, hkv=hkv, s=LM_MAX_LEN, d=d,
                           lengths=list(DECODE_LENGTHS)), "bfloat16",
                      {f"{phase}_decode_step": c.n_layers}))
    wc = get_config(ENCDEC_ARCH)
    n, hq, hkv, d = LM_BATCH, wc.n_heads, wc.n_kv_heads, wc.head_dim
    se, L = wc.encoder_seq, wc.n_layers
    attn = dict(n=n, hq=hq, hkv=hkv, d=d, window=None)
    cross = dict(attn, sq=ENCDEC_PROMPT, skv=se, causal=False)
    cross_step = dict(n=n, hq=hq, hkv=hkv, s=se, d=d, lengths=[se] * n)
    cases += [
        (ENCDEC_ARCH, "flash_attention", dict(attn, sq=se, skv=se,
                                              causal=False),
         "bfloat16", {"encdec_prefill": wc.encoder_layers}),
        (ENCDEC_ARCH, "flash_attention",
         dict(attn, sq=ENCDEC_PROMPT, skv=ENCDEC_PROMPT, causal=True),
         "bfloat16", {"encdec_prefill": L}),
        (ENCDEC_ARCH, "flash_attention", cross, "bfloat16",
         {"encdec_prefill": L}),
        (ENCDEC_ARCH, "flash_attention", cross, "float32", {}),
        (ENCDEC_ARCH, "decode_attention",
         dict(n=n, hq=hq, hkv=hkv, s=ENCDEC_MAX_LEN, d=d,
              lengths=list(ENCDEC_LENGTHS)), "bfloat16",
         {"encdec_decode_step": L}),
        (ENCDEC_ARCH, "decode_attention", cross_step, "bfloat16",
         {"encdec_decode_step": L}),
        (ENCDEC_ARCH, "decode_attention", cross_step, "float32", {})]
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
    from repro_torch.kernels import flash_attention as fa
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
            w = shape["window"]
            if w is None or w >= shape["skv"]:
                # causal cases are square: SDPA's top-left alignment is
                # ours; a window over the whole sequence masks nothing more
                lib = lambda: F.scaled_dot_product_attention(       # noqa: E731
                    q, k, v, is_causal=shape["causal"], enable_gqa=True)
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
        else:
            per_seq = flash_block_errors(torch, F, label, got, want, rel)
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
        # the flash route that ran (a checkout older than the routes has
        # none), and the kernel's time over SDPA's
        route = getattr(fa, "route", None) if kernel == "flash_attention" \
            else None
        extra = {"route": route(q, k, v)} if route else {}
        if times["library_ms"]:
            extra["over_library"] = times["ms"] / times["library_ms"]
        cold = {}
        if kernel == "decode_attention":
            cold = cold_decode_times(torch, q, k, v, lens, mask)
            for key in ("cold_ms", "library_cold_ms"):
                t = state["cold"].setdefault(kernel, {})
                t[key] = t.get(key, 0.0) + sum(per_pass.values()) * (
                    cold[key] or 0.0)
            decode_case_line(log, arch, dt, shape, q, k, row, cold,
                             with_bound(dict(row), byte_peak))
        emit(log, "kernel", name=kernel, design=DESIGN[kernel], arch=arch,
             dtype=dt, shape=shape, **extra, **cold, **per_seq,
             calls=per_pass, max_abs_err=err, tol=tol,
             tol_reason=(f"{rel:g} relative to the output's max: fp32 "
                         "softmax and sums in another order"
                         + ("; bf16 output rounding" if rel > 1e-4 else "")
                         + ("; seq_tol: the same, each sequence against its "
                            "own max" if "seq_tol" in per_seq else "")
                         + ("; block_tol: the same, each (sequence, head, "
                            "128-row block) against its own max"
                            if "block_tol" in per_seq else "")),
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


def decode_case_line(log, arch, dt, shape, q, k, row, cold, bound):
    """One line a ``decode_attention`` case: the kernel's device ms, cold
    (L2) ms, SDPA's, the bound and the kernel's share of it, and the
    launch the call gets (``decode_attention.config``: grid, cluster,
    CTAs an SM holds, ``cudaOccupancyMaxActiveClusters``, tensor-core p
    v; a checkout whose wrapper has no ``config`` reports none)."""
    from repro_torch.kernels import decode_attention as da
    config = da.config(q, k) if hasattr(da, "config") else None
    emit(log, "decode_case", arch=arch, dtype=dt, hq=shape["hq"],
         hkv=shape["hkv"], d=shape["d"], lengths=shape["lengths"],
         ms=row["ms"], cold_ms=cold.get("cold_ms"),
         library_ms=row["library_ms"],
         library_cold_ms=cold.get("library_cold_ms"),
         over_library=(row["ms"] / row["library_ms"]
                       if row["library_ms"] else None),
         bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
         bound_share=bound["bound_ms"] / row["ms"], launch=config)


def flash_block_errors(torch, F, label, got, want, rel, rows=128):
    """Hold each (sequence, head, block of ``rows`` query rows) of a flash
    attention output to ``rel`` of that block's own largest output: a
    causal row's outputs shrink as its keys grow, so the first rows' max
    sets a tolerance about as large as a long row's typical output, under
    which a wrong key tile in a long row would hide.  A block with no key
    (max 0) must be exactly 0.  Returns the worst block for the log."""
    n, h, sq, _ = got.shape
    nb = -(-sq // rows)
    pad = (0, nb * rows - sq)
    err = F.pad((got.float() - want.float()).abs().amax(-1), pad)
    big = F.pad(want.float().abs().amax(-1), pad)
    err = err.view(n, h, nb, rows).amax(-1)
    tol = rel * big.view(n, h, nb, rows).amax(-1)
    bad = err > tol
    ratio = torch.where(tol > 0, err / tol.clamp_min(1e-30),
                        bad.float() * float("inf"))
    worst = int(ratio.argmax())
    i, hb, b = worst // (h * nb), worst // nb % h, worst % nb
    e, t = float(err[i, hb, b]), float(tol[i, hb, b])
    need(not bool(bad.any()), f"{label}: {int(bad.sum())} of {bad.numel()} "
         f"blocks of {rows} rows over {rel:g} of their max; the worst "
         f"(sequence {i}, head {hb}, rows from {b * rows}) {e} > {t}")
    return dict(block_rows=rows, blocks=bad.numel(),
                block_worst=dict(seq=i, head=hb, row=b * rows,
                                 max_abs_err=e, tol=t),
                block_tol=float(tol.min()))


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


def shared_vae(torch, state):
    """(the calibrated SD3.5 VAE on the card, its gain), built by the
    first phase that asks and kept in ``state`` for the others."""
    if "vae" not in state:
        state["vae"] = sd35_vae(torch, "cuda")
    return state["vae"]


def phase_invariance(torch, log, state):
    vae = shared_vae(torch, state)[0]
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
    vae, gain = shared_vae(torch, state)
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
    vae = shared_vae(torch, state)[0]
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
    vae = shared_vae(torch, state)[0]
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
    vae = shared_vae(torch, state)[0]
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


def resident_decoder_bytes(vae):
    """Bytes of the decoder weights ``vae`` holds: its fp32 tree and every
    serving tree it has derived, each tensor counted once."""
    from repro_torch.kernels import ops
    from repro_torch.vae.model import map_params
    seen = {}

    def add(p):
        parts = (p.q, p.scale) if isinstance(p, ops.QuantizedWeight) else (p,)
        for t in parts:
            seen[t.data_ptr()] = int(t.nbytes)
    for tree in [vae.decoder] + list(vae._qparams.values()):
        map_params(tree, add)
    return sum(seen.values())


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
    vae = shared_vae(torch, state)[0]
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
                   launches=launches,
                   decoder_storage=Q.decoder_storage(v._params_for(wd)),
                   stored_storage=Q.decoder_storage(
                       Q.quantize_decoder(v.decoder, wd)),
                   resident_decoder_bytes=resident_decoder_bytes(v))
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
         fp32_serving_storage=Q.decoder_storage(vae._params_for("float32")),
         fp32_resident_decoder_bytes=resident_decoder_bytes(vae),
         lsb_tol=1, lsb_tol_reason="the engine's open-time gate: quantized "
         "uint8 within +-1 LSB of the fp32-weight decode at every bucket; "
         "a configuration above it is refused")


AUTOTUNE_BUCKETS = (1, 8)          # the sweep's buckets: 22 keys in fp32
AUTOTUNE_REPS = 5                  # best-of reps of each candidate
AUTOTUNE_AB_REPS = 5               # interleaved decodes of each A/B arm
AUTOTUNE_OBJECTS = 12              # latent puts of the engine run
AUTOTUNE_REQUESTS = 256            # its Zipf trace, in windows of 8
AUTOTUNE_ENGINE_BUCKETS = (1, 2)   # 22 keys to tune on first miss
AUTOTUNE_SEED = 37
AUTOTUNE_BUDGET_S = 90


def phase_autotune(torch, log, state):
    """The kernel autotuner at SD3.5-VAE width on a 64x64x16 latent.
    (a) ``KernelAutotuner`` from an empty cache over buckets 1 and 8 in
    fp32: 22 keys, every candidate's output equal to the default's under
    ``torch.equal`` (``tune`` raises otherwise), each winner no slower
    than its default.  (b) ``decode_u8`` with the tuned cache active
    against without it at buckets 1 and 8: bit for bit, bucket 8 equal to
    eight batch-1 decodes under the cache, device ms per image of each
    arm as interleaved A/B medians by CUDA events.  (c) Tune-on-first-miss
    from an empty cache: a persistent box with ``autotune=True`` and
    buckets (1, 2) serves a seeded Zipf trace, tuning one key per
    dispatched batch until nothing is pending (the ms each maintenance
    step spent tuning), closes, reopens with the same entries active and
    serves the trace again, every image byte-equal to the first serving's.
    (d) Every kernel of the read path launched in the reopened serving."""
    np = state["np"]
    import tempfile
    from repro_torch.core.tuner import TunerConfig
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import ops
    from repro_torch.store import LatentBox, StoreConfig
    t_phase = time.perf_counter()
    vae = shared_vae(torch, state)[0]
    side = 8 * LATENT_HW
    hwc = (LATENT_HW, LATENT_HW, 16)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    need(at.get_active_cache() is None, "a tuning cache is already active")

    # -- (a) the sweep from an empty cache ---------------------------------
    specs = {at.cache_key(sp["kernel"], b, sp["h"], sp["w"], sp["cin"],
                          sp["cout"], "float32"): sp
             for b in AUTOTUNE_BUCKETS
             for sp in at.decode_shapes(vae.cfg, hwc, b)}
    cache = at.TuningCache(None)
    tuner = at.KernelAutotuner(cache, vae.cfg, device="cuda",
                               reps=AUTOTUNE_REPS)
    for b in AUTOTUNE_BUCKETS:
        tuner.note_bucket(b, hwc)
    need(tuner.pending == len(specs) == 22,
         f"{tuner.pending} keys queued for {len(specs)} shapes, not 22")
    swept = []
    t0 = time.perf_counter()
    while tuner.pending:
        (key,) = tuner.step(1)   # raises if a candidate changes a bit
        e, spec = cache.get(key), specs[key]
        knob = at.KNOBS[spec["kernel"]][0]
        cands = at.candidates(spec["kernel"], spec, sms, "float32")
        need(e["candidates"] == len(cands) == len(e["candidate_us"]),
             f"{key}: {e['candidates']} candidates timed of {len(cands)}")
        need(e["us"] <= e["default_us"], f"{key}: winner {e['us']} us "
             f"slower than its default {e['default_us']}")
        swept.append({"key": key, "candidates": [c[knob] for c in cands],
                      "candidate_us": e["candidate_us"],
                      "default_us": e["default_us"], "us": e["us"],
                      knob: e[knob], "s": tuner.step_ms[-1] / 1e3})
    sweep_s = time.perf_counter() - t0
    moved = [s["key"] for s in swept
             if s.get("layout", s.get("tile_h")) != s["candidates"][0]]

    # -- (b) decodes with and without the tuned cache ------------------------
    rng = np.random.default_rng(AUTOTUNE_SEED)
    z8 = rng.standard_normal((8,) + hwc).astype(np.float32)

    def event_ms(fn):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop)

    decode_ms = {}
    for b in (1, 8):
        zb = torch.from_numpy(z8[:b].copy()).cuda()
        untuned = vae.decode_u8(zb)
        with at.active_cache(cache):
            tuned = vae.decode_u8(zb)
        need(bool(torch.equal(tuned, untuned)),
             f"bucket {b}: the tuned decode differs from the untuned one")
        times = {"untuned": [], "tuned": []}
        for r in range(AUTOTUNE_AB_REPS):
            for arm in (("untuned", "tuned") if r % 2 == 0
                        else ("tuned", "untuned")):
                with at.active_cache(cache if arm == "tuned" else None):
                    times[arm].append(event_ms(lambda: vae.decode_u8(zb)))
        decode_ms[str(b)] = {f"{arm}_per_image_ms": statistics.median(v) / b
                             for arm, v in times.items()}
        decode_ms[str(b)]["bit_identical"] = True
        del zb, untuned, tuned
    with at.active_cache(cache):
        batch = vae.decode_u8(torch.from_numpy(z8).cuda()).cpu()
        same = [bool(torch.equal(batch[i:i + 1], vae.decode_u8(
            torch.from_numpy(z8[i:i + 1].copy()).cuda()).cpu()))
            for i in range(8)]
    need(all(same), f"tuned: bucket 8 differs from batch-1 decodes: {same}")

    # -- (c) tune-on-first-miss in the engine, close, reopen -----------------
    latents = [rng.standard_normal(hwc).astype(np.float16)
               for _ in range(AUTOTUNE_OBJECTS)]
    ranks = np.arange(1, AUTOTUNE_OBJECTS + 1, dtype=np.float64)
    p = ranks ** -1.1
    trace = [int(t) for t in rng.choice(AUTOTUNE_OBJECTS, AUTOTUNE_REQUESTS,
                                        p=p / p.sum())]
    windows = [trace[s:s + SLICE_WINDOW]
               for s in range(0, len(trace), SLICE_WINDOW)]
    cfg = StoreConfig(n_nodes=2, cache_bytes_per_node=6e6,
                      image_bytes=float(side * side * 3), latent_bytes=1.2e5,
                      promote_threshold=2, tuner=TunerConfig(window=10**9),
                      decode_buckets=AUTOTUNE_ENGINE_BUCKETS, autotune=True)
    tmp = tempfile.TemporaryDirectory(prefix="lbx-autotune-",
                                      dir=str(OUT_DIR))
    path = Path(tmp.name) / "box"
    first = {}

    def serve(box, what):
        """Serve the trace; every image byte-equal to the first serving's
        for its object.  Returns the window after which nothing was
        pending (None: never)."""
        done_at = None
        for i, win in enumerate(windows):
            for r in box.get_many(win):
                img = np.asarray(r.payload)
                need(img.shape == (side, side, 3) and img.dtype == np.uint8,
                     f"{what}: bad payload for {r.oid}")
                if r.oid in first:
                    need(bool(np.array_equal(first[r.oid], img)),
                         f"{what}: object {r.oid} served other bytes")
                else:
                    first[r.oid] = img.copy()
            s = box.summary()
            if done_at is None and s["tuning_pending"] == 0 and \
                    s["tuned_kernel_keys"] == 22:
                done_at = i + 1
        return done_at

    box = LatentBox.open(path, config=cfg, vae=vae, device="cuda")
    eng = box.backend.engine
    need(at.get_active_cache() is eng.tuning_cache
         and len(eng.tuning_cache) == 0, "the engine's empty cache is not "
         "the active one")
    for oid, z in enumerate(latents):
        box.put(oid, latent=z)
    eng.prewarm_decode(hwc)                 # notes both buckets' shapes
    t0 = time.perf_counter()
    converged = serve(box, "first serving")
    first_s = time.perf_counter() - t0
    need(converged is not None, f"tuning still pending after the trace: "
         f"{box.summary()['tuning_pending']}")
    step_ms = list(eng.autotuner.step_ms)
    entries = dict(eng.tuning_cache.entries)
    box.close()
    need(at.get_active_cache() is None, "close kept the tuning cache active")
    on_disk = at.TuningCache.load(str(path / at.CACHE_FILENAME))
    need(on_disk.entries == entries and on_disk.device ==
         torch.cuda.get_device_name(0), "the saved cache differs")
    t0 = time.perf_counter()
    box = LatentBox.open(path, config=cfg, vae=vae, device="cuda")
    reopen_ms = (time.perf_counter() - t0) * 1e3
    eng = box.backend.engine
    need(eng.tuning_cache.entries == entries, "entries did not survive")
    need(at.get_active_cache() is eng.tuning_cache,
         "the reopened cache is not the active one")
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve(box, "after the reopen")
    reopened_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    state["launches"]["autotune"] = launches
    summ = box.summary()
    need(summ["tuning_pending"] == 0 and summ["tuned_kernel_keys"] == 22
         and not eng.autotuner.step_ms, "the reopened engine tuned again")
    box.close()
    need(at.get_active_cache() is None, "close kept the tuning cache active")
    tmp.cleanup()
    # -- (d) the read path's kernels ran -------------------------------------
    path_kernels = {k for k, _ in decode_calls(vae.cfg, LATENT_HW)}
    need(all(launches[k] > 0 for k in path_kernels),
         f"a kernel of the tuned read path was never launched: {launches}")
    del batch, cache, tuner
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    emit(log, "autotune", latent=list(hwc), sms=sms,
         sweep={"buckets": list(AUTOTUNE_BUCKETS), "weight_dtype": "float32",
                "reps": AUTOTUNE_REPS, "keys": len(swept), "sweep_s": sweep_s,
                "bit_check": "every candidate's output torch.equal to the "
                             "default's (tune raises otherwise)",
                "non_default_winners": moved, "entries": swept},
         decode={"ab_reps": AUTOTUNE_AB_REPS, "device_ms": decode_ms,
                 "tuned_bucket8_bit_identical_to_batch1": same},
         engine={"buckets": list(AUTOTUNE_ENGINE_BUCKETS),
                 "objects": AUTOTUNE_OBJECTS, "requests": AUTOTUNE_REQUESTS,
                 "window": SLICE_WINDOW, "windows": len(windows),
                 "converged_after_windows": converged,
                 "tuned_keys": len(entries), "tuning_steps": len(step_ms),
                 "tuning_step_ms_max": max(step_ms),
                 "tuning_step_ms_sum": sum(step_ms),
                 "first_serving_s": first_s, "reopen_ms": reopen_ms,
                 "reopened_serving_s": reopened_s,
                 "objects_byte_equal": len(first)},
         launches=launches, wall_s=wall, wall_budget_s=AUTOTUNE_BUDGET_S)


LAUNCH_DECODES = ((LATENT_HW, 1), (LATENT_HW, 8), (2 * LATENT_HW, 1))
LAUNCH_REPS = 5                    # timed decodes of each cost-model row
LAUNCH_SEED = 41
LAUNCH_BUDGET_S = 60
#: the kernels of the launcher's path: the decode's and the recipe put's
#: encode (``group_norm_silu``)
LAUNCH_KERNELS = ("conv3x3", "gn_silu_conv3x3", "flash_attention",
                  "upsample_conv3x3", "output_epilogue", "group_norm_silu")


def plain_decode_u8(torch, params, z, cfg):
    """uint8 decode of ``z`` (fp32, on the card) through the kernels'
    plain versions (``kernels/ref.py``) and plain tensor code: the graph
    of ``vae/model.py``'s ``decode_u8`` spelled out without ``ops``, so
    no kernel runs."""
    from repro_torch.kernels import ref
    g = cfg.groups

    def dense(y, w, b):
        return torch.matmul(y, w) + b

    def resnet(x, p):
        h = ref.gn_silu_conv3x3_ref(x, p["norm1"]["scale"], p["norm1"]["bias"],
                                    p["conv1"]["w"], p["conv1"]["b"], g)
        h = ref.gn_silu_conv3x3_ref(h, p["norm2"]["scale"], p["norm2"]["bias"],
                                    p["conv2"]["w"], p["conv2"]["b"], g)
        if "shortcut" in p:
            x = dense(x, p["shortcut"]["w"][0, 0], p["shortcut"]["b"])
        return x + h

    def attention(x, p):
        n, h, w, c = x.shape
        mean, rstd = ref.gn_stats_ref(x, g)
        y = ((x.reshape(n, h * w, g, c // g) - mean[:, None, :, None])
             * rstd[:, None, :, None]).reshape(n, h * w, c)
        y = y * p["norm"]["scale"] + p["norm"]["bias"]
        q, k, v = (dense(y, p[t]["w"], p[t]["b"])[:, None] for t in "qkv")
        o = ref.flash_attention_ref(q, k, v)[:, 0]
        return x + dense(o, p["proj"]["w"], p["proj"]["b"]).reshape(n, h, w, c)

    x = ref.conv3x3_ref(z / cfg.scaling_factor + cfg.shift_factor,
                        params["conv_in"]["w"], params["conv_in"]["b"])
    x = resnet(x, params["mid"]["res1"])
    x = attention(x, params["mid"]["attn"])
    x = resnet(x, params["mid"]["res2"])
    for level in params["up"]:
        for blk in level["blocks"]:
            x = resnet(x, blk)
        if "upsample" in level:
            conv = level["upsample"]["conv"]
            x = ref.upsample_conv3x3_ref(x, conv["w"], conv["b"])
    return ref.output_epilogue_ref(
        x, params["norm_out"]["scale"], params["norm_out"]["bias"],
        params["conv_out"]["w"], params["conv_out"]["b"], g)


def max_lsb(np, a, b) -> int:
    """Largest difference of two uint8 arrays, in LSB."""
    return int(np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16)).max())


def phase_launch(torch, log, state):
    """The launch layer and the cost model.  (a) The serving launcher,
    ``repro_torch.launch.serve`` at its defaults on the card: its
    ``[serve]`` lines and each kernel's launches (all > 0), and every
    served payload within +-1 LSB of the same launcher's on the CPU
    (the plain path) at the same arguments.  (b)
    ``examples/quickstart_torch.py`` in a child process on the card: it
    exits 0, so its two bit-identity assertions held.  (c) The analytic
    decode model at SD3.5-VAE width against the card: uint8 decodes of
    512x512 at buckets 1 and 8 and of 1024x1024 at bucket 1 (CUDA events
    around ``decode_u8``), each held first within +-1 LSB of
    :func:`plain_decode_u8` on the same latents, beside ``decoder_flops_per_image``,
    ``decoder_bytes_per_image`` (bf16 and fp32), the sum of ``work`` over
    ``decode_calls``, ``decode_ms_estimate``, the achieved TFLOP/s and
    its share of the 3xTF32 peak.  (d) Storage sizes of the bucket-8
    512x512 images: raw uint8, ``png_like_size``, ``jpeg_like`` at
    quality 95 and the fp16 latent's compressed blob (printed only)."""
    np = state["np"]
    import contextlib
    import io
    import os
    from repro_torch.compression.latentcodec import compress_latent
    from repro_torch.compression.lossy import jpeg_like
    from repro_torch.compression.png_proxy import png_like_size
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import PEAK_FLOPS_TF32
    from repro_torch.vae import serve as vserve
    t_phase = time.perf_counter()

    # -- (a) the serving launcher at its defaults ---------------------------
    out = io.StringIO()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        _, served = serve.run(serve.parse_args([]))
    launcher_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    state["launches"]["launch"] = launches
    lines = out.getvalue().splitlines()
    for ln in lines:
        print(ln, flush=True)
    need(len(lines) == 5 and all(ln.startswith("[serve] ") for ln in lines),
         f"the launcher printed {lines}")
    need(f"on {torch.cuda.get_device_name(0)}," in lines[2],
         f"the launcher's timing line names no card: {lines[2]}")
    need(all(launches[k] > 0 for k in LAUNCH_KERNELS),
         f"a kernel of the launcher's path was never launched: {launches}")
    # the same launcher on the CPU: the same trace, and each payload
    # within +-1 LSB (recipe puts encode on each device, and fp32 sums
    # differ in order; the tuner may serve other classes after a window)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        _, plain = serve.run(serve.parse_args(["--device", "cpu"]))
    cpu_launcher_s = time.perf_counter() - t0
    need([r.oid for r in served] == [r.oid for r in plain],
         "the card's and the CPU's launchers served other traces")
    need(all(r.payload is not None and r.payload.shape == (32, 32, 3)
             and r.payload.dtype == np.uint8 for r in served),
         "the launcher served a bad payload")
    launcher_lsb = max(max_lsb(np, a.payload, b.payload)
                       for a, b in zip(served, plain))
    need(launcher_lsb <= 1,
         f"the launcher's pixels differ from the CPU's by {launcher_lsb} LSB")
    launcher_equal = sum(bool(np.array_equal(a.payload, b.payload))
                         for a, b in zip(served, plain))

    # -- (b) the quickstart in a child process on the card ------------------
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "quickstart_torch.py")],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    quickstart_s = time.perf_counter() - t0
    need(proc.returncode == 0,
         f"the quickstart exited {proc.returncode}: {proc.stderr[-2000:]}")
    need(proc.stdout.strip().endswith("latent-first roundtrip OK on cuda"),
         f"the quickstart printed {proc.stdout[-500:]}")

    # -- (c) the decode cost model against the card -------------------------
    vae = shared_vae(torch, state)[0]
    cfg = vae.cfg
    need(vae.weight_dtype == "float32", f"the VAE serves {vae.weight_dtype}")
    torch.backends.cuda.matmul.allow_tf32 = False       # the plain decode
    peak = PEAK_FLOPS_TF32 / 3
    rng = np.random.default_rng(LAUNCH_SEED)
    rows, images, latents = [], None, None
    for side, bucket in LAUNCH_DECODES:
        res = cfg.spatial_factor * side
        z = rng.standard_normal((bucket, side, side, cfg.latent_channels)
                                ).astype(np.float32)
        zc = torch.from_numpy(z).cuda()
        got = vae.decode_u8(zc).cpu().numpy()
        lsb = max_lsb(np, got,
                      plain_decode_u8(torch, vae.decoder, zc, cfg).cpu())
        need(got.shape == (bucket, res, res, 3), f"decode shape {got.shape}")
        need(lsb <= 1, f"the {res}x{res} bucket-{bucket} decode differs "
             f"from the plain one by {lsb} LSB")
        ms = cuda_ms(torch, lambda: vae.decode_u8(zc), LAUNCH_REPS) / bucket
        flops = vserve.decoder_flops_per_image(cfg, res)
        calls = decode_calls(cfg, side)
        work_flops = sum(work(k, a)[0] for k, a in calls)
        est = vserve.decode_ms_estimate(res)
        rows.append({
            "resolution": res, "bucket": bucket, "plain_max_lsb": lsb,
            "model_flops": flops, "work_flops": work_flops,
            "model_bytes_bf16": vserve.decoder_bytes_per_image(cfg, res, 2),
            "model_bytes_fp32": vserve.decoder_bytes_per_image(cfg, res, 4),
            "work_bytes": sum(work(k, a)[1] for k, a in calls),
            "estimate_ms": est["decode_ms"],
            "device_ms_per_image": ms,
            "measured_over_estimate": ms / est["decode_ms"],
            "tflops": flops / (ms * 1e-3) / 1e12,
            "share_of_3xtf32_peak": flops / (ms * 1e-3) / peak,
            "work_tflops": work_flops / (ms * 1e-3) / 1e12})
        if (side, bucket) == (LATENT_HW, 8):
            images, latents = got, z
        del zc, got
    torch.cuda.empty_cache()
    side = cfg.spatial_factor * LATENT_HW
    need(images is not None and images.shape == (8, side, side, 3)
         and images.dtype == np.uint8, "no bucket-8 images")

    # -- (d) storage sizes of the decoded 512x512 images --------------------
    sizes = [{"raw": int(img.nbytes), "png_like": png_like_size(img),
              "jpeg_q95": jpeg_like(img, 95)[0],
              "latent_blob": len(compress_latent(z.astype(np.float16)))}
             for img, z in zip(images, latents)]
    storage = {k: statistics.mean(s[k] for s in sizes) for k in sizes[0]}
    wall = time.perf_counter() - t_phase
    emit(log, "launch", launcher={"argv": [], "lines": lines,
                                  "wall_s": launcher_s,
                                  "cpu_wall_s": cpu_launcher_s,
                                  "requests": len(served),
                                  "cpu_max_lsb": launcher_lsb,
                                  "cpu_equal_payloads": launcher_equal},
         quickstart={"returncode": proc.returncode, "wall_s": quickstart_s,
                     "stdout": proc.stdout.splitlines()},
         cost_model={"peak_flops": peak,
                     "peak": "PEAK_FLOPS_TF32 / 3 (fp32 on 3xTF32)",
                     "plain_tol_lsb": 1,
                     "reps": LAUNCH_REPS, "rows": rows},
         storage={"images": len(sizes), "mean_bytes": storage,
                  "per_image": sizes},
         launches=launches, wall_s=wall, wall_budget_s=LAUNCH_BUDGET_S)


def phase_crossdevice(torch, log, state):
    from repro_torch.vae.model import VAE, map_params
    vae = shared_vae(torch, state)[0]
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


#: small fp32 models of each served family for the crossdevice phase (the
#: MoE at its published 8 experts, top-2 and capacity factor 1.25, so its
#: steps drop entries; the VLM at head_dim 128 for the published M-RoPE
#: sections; kimi-k2's geometry narrowed: its head_dim 112 with 8 q heads
#: over 1 kv head, its 384 experts, top-8 and capacity factor 1.25, the
#: fp32 twin its serving phase cannot hold, ``tests/test_torch_kimi.py``
#: holding this one to the JAX package)
CROSS_LMS = {
    LM_ARCH: dict(n_layers=4, d_model=512, n_heads=8, n_kv_heads=2,
                  d_ff=1024, vocab_size=4096),
    SSM_ARCH: dict(n_layers=4, d_model=512, ssm_head_dim=64, d_ff=1024,
                   vocab_size=4096),
    HYBRID_ARCH: dict(n_layers=4, attn_every=2, d_model=640, n_heads=8,
                      n_kv_heads=8, ssm_head_dim=64, ssm_state=64,
                      d_ff=1024, vocab_size=4096),
    MOE_ARCH: dict(n_layers=4, d_model=512, n_heads=8, n_kv_heads=2,
                   d_ff=1024, vocab_size=4096),
    VLM_ARCH: dict(n_layers=4, d_model=1024, n_heads=8, n_kv_heads=2,
                   d_ff=1024, vocab_size=4096),
    ENCDEC_ARCH: dict(n_layers=4, encoder_layers=4, encoder_seq=150,
                      d_model=512, n_heads=8, n_kv_heads=8, d_ff=1024,
                      vocab_size=4096),
    KIMI_ARCH: dict(n_layers=2, d_model=896, n_heads=8, n_kv_heads=1,
                    d_ff=64, vocab_size=4096),
}
CROSS_PREFIX = 7          # vision embeds before the small VLM's tokens


def cache_leaves(cache, prefix=""):
    """A cache tree as {"k": leaf, "ssm.s": leaf, ...}."""
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out.update(cache_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def crossdevice_lm(torch, state, arch):
    """A small fp32 model of ``arch``'s family (``CROSS_LMS``; the zamba2
    one at head_dim 80) on the card and on the CPU from the same weights:
    prefill of 2 x 45 tokens (after 7 seeded embeds for the VLM; with 150
    seeded frames for the enc-dec), then 4 decode steps; logits, and every
    cache leaf (KV, cross K/V, SSM state), within 1e-4 of their max, and
    the positions equal (TF32 off)."""
    import dataclasses
    from repro_torch.configs import build_model, get_config
    from repro_torch.models.blocks import moe_capacity
    from repro_torch.vae.model import map_params
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch), dtype=torch.float32,
                              **CROSS_LMS[arch])
    gpu = build_model(cfg, device="cuda", seed=7)
    cpu = type(gpu)(cfg, device="cpu",
                    params=map_params(gpu.params, lambda t: t.cpu()))
    toks = state["np"].random.default_rng(19).integers(0, cfg.vocab_size,
                                                       (2, 49))
    side = side_input(torch, cfg, 2, CROSS_PREFIX, 19)
    gl, gc = prefill_of(gpu, side)(toks[:, :45], max_len=56)
    cl, cc = prefill_of(cpu, None if side is None else side.cpu())(
        toks[:, :45], max_len=56)
    errs = []
    for t in range(45, 50):
        errs.append(float((gl.cpu() - cl).abs().max() / cl.abs().max()))
        need(errs[-1] <= 1e-4, f"small {arch} logits differ by {errs[-1]} "
             f"(relative) > 1e-4 at position {t}")
        if t < 49:
            gl, gc = gpu.decode_step(gc, toks[:, t])
            cl, cc = cpu.decode_step(cc, toks[:, t])
    got, want = cache_leaves(gc), cache_leaves(cc)
    need(sorted(got) == sorted(want), f"small {arch} cache leaves differ")
    need(torch.equal(got.pop("pos").cpu(), want.pop("pos")),
         f"small {arch} cache positions differ")
    cache_rel = {}
    for key, c in want.items():
        cache_rel[key] = float((got[key].cpu() - c).abs().max()
                               / max(float(c.abs().max()), 1e-30))
        need(cache_rel[key] <= 1e-4, f"small {arch} cache {key} differs by "
             f"{cache_rel[key]} > 1e-4")
    extra = {}
    if cfg.family == "moe":
        extra = dict(capacity_factor=cfg.capacity_factor,
                     cap_prefill=moe_capacity(2 * 45, cfg),
                     cap_decode_step=moe_capacity(2, cfg))
    return {"arch": arch, "config": dict(model_shape(cfg), dtype="float32"),
            "prompt": [2, 45], "decode_steps": 4,
            "prefix_embeds": CROSS_PREFIX if cfg.family == "vlm" else 0,
            **extra, "logits_rel_err": errs, "cache_rel_err": cache_rel,
            "tol": 1e-4}


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
    per shared-block application (Mamba-2 has no kernel); the enc-dec a
    ``flash_attention`` per encoder layer and two per decoder layer (self
    and cross) per prefill, and two ``decode_attention`` per decoder layer
    per step; dense, MoE and VLM one per layer."""
    if cfg.ssm_type == "rwkv6":
        return {"rwkv6_scan": cfg.n_layers}, {"rwkv6_scan": cfg.n_layers}
    if cfg.family == "encdec":
        return ({"flash_attention": cfg.encoder_layers + 2 * cfg.n_layers},
                {"decode_attention": 2 * cfg.n_layers})
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
    if cfg.family == "moe":
        out.update(experts=cfg.n_experts, top_k=cfg.experts_per_token,
                   capacity_factor=cfg.capacity_factor,
                   window=cfg.sliding_window)
    if cfg.family == "vlm":
        out.update(mrope_sections=list(cfg.mrope_sections))
    if cfg.family == "encdec":
        out.update(encoder_layers=cfg.encoder_layers,
                   encoder_seq=cfg.encoder_seq, act=cfg.act)
    return out


def serve_config(get_config, phase: str):
    """The config a serving phase runs: the published one, with the depth
    of ``DEPTH_CUT`` where the phase cuts it."""
    import dataclasses
    cfg = get_config(SERVE[phase])
    if phase in DEPTH_CUT:
        cfg = dataclasses.replace(cfg, n_layers=DEPTH_CUT[phase][0])
    return cfg


def serve_lengths(cfg):
    """(prompt tokens, prefix embeds, cache slots) per sequence of a
    serving phase: the enc-dec's decoder prompt, the VLM's vision prefix,
    the LM's prompt."""
    if cfg.family == "encdec":
        return ENCDEC_PROMPT, 0, ENCDEC_MAX_LEN
    if cfg.family == "vlm":
        return LM_PROMPT - VLM_PREFIX, VLM_PREFIX, LM_MAX_LEN
    return LM_PROMPT, 0, LM_MAX_LEN


def side_input(torch, cfg, batch: int, prefix: int, seed: int,
               device="cuda"):
    """The input a model takes beside its tokens, seeded on ``device``:
    an enc-dec's frames [B, encoder_seq, d] (N(0, 1), the stub frontend's
    output), a VLM's vision embeds [B, prefix, d] at the token
    embeddings' scale (N(0, 0.02^2)), else None."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if cfg.family == "encdec":
        return torch.randn((batch, cfg.encoder_seq, cfg.d_model),
                           generator=gen, device=device).to(cfg.dtype)
    if cfg.family == "vlm":
        return (torch.randn((batch, prefix, cfg.d_model), generator=gen,
                            device=device) * 0.02).to(cfg.dtype)
    return None


def prefill_of(model, side):
    """``model``'s prefill as ``fn(tokens, max_len=None)``, with its side
    input: an EncDecLM's frames, a VLM's embeds."""
    if model.cfg.family == "encdec":
        return lambda toks, max_len=None: model.prefill(toks, side, max_len)
    if side is not None:
        return lambda toks, max_len=None: model.prefill(toks, max_len, side)
    return model.prefill


def phase_serve(torch, log, state, phase: str):
    """One LM serving path (``SERVE[phase]``) at full width in bf16, at
    full depth but where ``DEPTH_CUT`` cuts it: one prefill of 4 seeded
    sequences (2048 tokens; the VLM 256 seeded embeds and 1792 tokens; the
    enc-dec 1500 seeded frames and 384 tokens), then 64 greedy decode
    steps, each kernel's launches checked exactly; then decode-after-
    prefill logits against a prefill one token longer, in bf16 and in
    fp32 (the same weights cast exactly; the MoE both at capacity factor
    E / k, where nothing drops), and a profiler window of a prefill and
    four steps.  The model is freed on return."""
    import dataclasses
    np = state["np"]
    from repro_torch.configs import build_model, get_config
    from repro_torch.kernels import ops
    from repro_torch.models.blocks import moe_capacity
    state.pop("vae", None)                      # free the VAE phases' memory
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    arch = SERVE[phase]
    cfg = serve_config(get_config, phase)
    prompt, prefix, max_len = serve_lengths(cfg)
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_bytes = torch.cuda.memory_allocated()
    n_params = model.n_params
    prompts = np.random.default_rng(23).integers(
        0, cfg.vocab_size, (LM_BATCH, prompt))
    side = side_input(torch, cfg, LM_BATCH, prefix, 29)
    run = prefill_of(model, side)
    per_prefill, per_step = expected_launches(cfg)

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = run(prompts, max_len=max_len)
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
    need(bool((cache["pos"] == prefix + prompt + LM_STEPS).all()),
         f"cache positions {cache['pos'].tolist()}")
    peak = torch.cuda.max_memory_allocated()
    cache_bytes = sum(t.numel() * t.element_size() for t in flat_leaves(cache))
    del cache, logits

    t0 = time.perf_counter()
    lp, c = run(prompts, max_len=max_len)
    torch.cuda.synchronize()
    warm_prefill_ms = (time.perf_counter() - t0) * 1e3
    # where the time goes: device kernel time against wall time, one
    # prefill and four decode steps under torch.profiler
    holder = {}

    def run_prefill():
        holder["l"], holder["c"] = run(prompts, max_len=max_len)

    def run_step():
        holder["l"], holder["c"] = model.decode_step(
            holder["c"], holder["l"].argmax(-1))

    prof_prefill = profile_share(torch, run_prefill, 1)
    prof_step = profile_share(torch, run_step, 4)
    del holder, lp
    if phase in NO_TWIN:
        checks = no_twin_checks(torch, state, phase, model, prompts, side)
    else:
        checks = twin_consistency(torch, state, phase, model, prompts, side,
                                  first, c, max_len)
    del model, run, c
    gc.collect()
    torch.cuda.empty_cache()
    steps = LM_BATCH * (prefix + prompt)
    cut = DEPTH_CUT.get(phase)
    emit(log, phase, arch=arch, family=cfg.family, dtype="bfloat16",
         **model_shape(cfg),
         reduced=None if cut is None else dict(
             layers=[cut[0], get_config(arch).n_layers], why=cut[1]),
         params=n_params, param_count_config=cfg.param_count(),
         param_count_published=get_config(arch).param_count(),
         weights_bytes=weights_bytes, cache_bytes=cache_bytes,
         init_s=init_s, max_memory_allocated=peak, batch=LM_BATCH,
         prompt=prompt, prefix_embeds=prefix,
         encoder_frames=cfg.encoder_seq if cfg.family == "encdec" else 0,
         max_len=max_len, decode_steps=LM_STEPS,
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
         **checks)


def twin_consistency(torch, state, phase, model, prompts, side, first, c,
                     max_len):
    """A serving phase's decode-after-prefill check: ``decode_step`` on
    ``first`` after the prefill of ``prompts`` (whose cache is ``c``)
    against the last logits of a prefill one token longer, in bf16 (gated
    by ``CONSISTENCY_TOL``) and on an fp32 twin of the same weights cast
    exactly (gated by ``FP32_CONSISTENCY_TOL``); a MoE both at capacity
    factor E / k (cap = T: no entry dropped).  Returns the phase line's
    fields."""
    import dataclasses
    from repro_torch.models.blocks import moe_capacity
    np = state["np"]
    cfg, arch = model.cfg, SERVE[phase]
    prompt, prefix, _ = serve_lengths(cfg)
    extra = {}
    cons_cfg, cons = cfg, model
    if cfg.family == "moe":
        cf = cfg.n_experts / cfg.experts_per_token
        cons_cfg = dataclasses.replace(cfg, capacity_factor=cf)
        cons = type(model)(cons_cfg, device="cuda", params=model.params)
        t_pre, t_step = LM_BATCH * prompt, LM_BATCH
        extra = dict(cap_prefill=moe_capacity(t_pre, cfg),
                     cap_decode_step=moe_capacity(t_step, cfg),
                     consistency_capacity_factor=cf,
                     consistency_cap_prefill=[
                         moe_capacity(t_pre, cons_cfg),
                         moe_capacity(t_pre + LM_BATCH, cons_cfg)],
                     consistency_cap_decode_step=moe_capacity(t_step,
                                                              cons_cfg),
                     timed_capacity_factor=cfg.capacity_factor)
        del c
        _, c = prefill_of(cons, side)(prompts, max_len=max_len)
    ld, c = cons.decode_step(c, first)
    del c
    longer = np.concatenate([prompts, first.cpu().numpy()[:, None]], axis=1)
    lf, _ = prefill_of(cons, side)(longer)
    del _
    err = float((ld.float() - lf.float()).abs().max())
    scale = float(lf.float().abs().max())
    tol, tol_reason = CONSISTENCY_TOL[phase]
    if tol is not None:
        need(err <= tol * scale, f"{arch} decode-after-prefill logits differ "
             f"from a prefill of {prefix + prompt + 1} positions by {err} > "
             f"{tol} * {scale}")
    # the same check in fp32, on the bf16 weights cast exactly: the path's
    # own error without bf16 rounding; and how far the bf16 logits of the
    # longer prefill lie from the fp32 ones (the bf16 noise floor)
    twin = type(model)(dataclasses.replace(cons_cfg, dtype=torch.float32),
                       device="cuda", params=model.params)
    gc.collect()
    torch.cuda.empty_cache()
    side32 = None if side is None else side.float()
    _, c = prefill_of(twin, side32)(prompts, max_len=max_len)
    ld32, c = twin.decode_step(c, first)
    del c
    lf32, _ = prefill_of(twin, side32)(longer)
    del _, twin, side32
    scale32 = float(lf32.abs().max())
    err32 = float((ld32 - lf32).abs().max())
    floor = float((lf.float() - lf32).abs().max()) / scale32
    need(err32 <= FP32_CONSISTENCY_TOL * scale32, f"{arch} fp32 decode-"
         f"after-prefill logits differ by {err32} > {FP32_CONSISTENCY_TOL} "
         f"* {scale32}")
    return dict(
        extra, consistency_max_abs_err=err, consistency_logit_max=scale,
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


def moe_token_reference(torch, params, x, cfg, cap=None):
    """The MoE layer ``params`` on ``x [B, S, d]`` one token at a time in
    fp32: each token's top-k experts from the layer's own fp32 router by
    the ops ``blocks.moe`` routes with, on the same input (the same bits,
    so no near-tie can part the two); their SwiGLU in fp32 on the bf16
    weights of those k experts upcast one token at a time; the outputs
    weighted by the renormalised gates.  With ``cap``, an entry ranked at
    or past ``cap`` in its expert, token by token and choice by choice
    (the capacity rule), adds nothing.  Returns (out [B, S, d] fp32, the
    experts [T, k], the entries kept [T, k] bool)."""
    import torch.nn.functional as F
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    logits = xt.float() @ params["router"]
    gates, idx = torch.topk(torch.softmax(logits, dim=-1),
                            cfg.experts_per_token)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    seen = Counter()
    kept = []
    for experts in idx.tolist():
        kept.append([cap is None or seen[e] < cap for e in experts])
        seen.update(experts)
    kept = torch.tensor(kept, dtype=torch.bool, device=x.device)
    out = torch.zeros((b * s, d), dtype=torch.float32, device=x.device)
    for i in range(b * s):
        sel = idx[i][kept[i]]
        if sel.numel() == 0:
            continue
        xi = xt[i].float()
        h = (F.silu(xi @ params["w_gate"][sel].float())
             * (xi @ params["w_up"][sel].float()))                 # [k, f]
        ho = torch.bmm(h[:, None], params["w_down"][sel].float())[:, 0]
        out[i] = (gates[i][kept[i]][:, None] * ho).sum(0)
    return out.reshape(b, s, d), idx, kept


def no_twin_checks(torch, state, phase, model, prompts, side):
    """The checks of a serving phase whose fp32 twin does not fit beside
    its bf16 model (``NO_TWIN``; the crossdevice phase holds a narrow fp32
    twin of the same geometry to the CPU).  (b) The first layer's MoE on
    ``KIMI_MOE_TOKENS`` seeded bf16 activations against
    ``moe_token_reference`` at capacity factor E / k, where nothing drops,
    and at the published capacity factor, where the reference drops the
    capacity rule's entries and their count is the rule's (``moe_capacity``
    slots an expert), each within ``KIMI_MOE_TOL`` (TF32 off).  (d) Decode
    after a prefill of ``KIMI_PROMPT`` tokens a sequence against a prefill
    one token longer, at capacity factor E / k, reported and not gated
    (``CONSISTENCY_TOL``).  Returns the phase line's fields."""
    import dataclasses
    from repro_torch.models.blocks import moe, moe_capacity
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = model.cfg
    e, k = cfg.n_experts, cfg.experts_per_token
    cf = e / k
    layer = model.params["layers"][0]["moe"]
    gen = torch.Generator(device="cuda").manual_seed(KIMI_MOE_SEED)
    x = torch.randn((*KIMI_MOE_TOKENS, cfg.d_model), generator=gen,
                    device="cuda").to(cfg.dtype)
    t = x.shape[0] * x.shape[1]
    rel, tol_reason = KIMI_MOE_TOL
    moe_ref = {"tokens": list(KIMI_MOE_TOKENS), "tol": rel,
               "tol_reason": tol_reason}
    for label, factor in (("no_drop", cf), ("published", cfg.capacity_factor)):
        cap = moe_capacity(t, cfg, factor)
        got = moe(layer, x, cfg, capacity_factor=factor)
        want, idx, kept = moe_token_reference(torch, layer, x, cfg, cap)
        counts = torch.bincount(idx.reshape(-1), minlength=e)
        rule = int((counts - cap).clamp(min=0).sum())
        dropped = int((~kept).sum())
        err = float((got.float() - want).abs().max())
        scale = float(want.abs().max())
        need(tuple(got.shape) == tuple(x.shape) and got.dtype == x.dtype and
             bool(torch.isfinite(got.float()).all()),
             f"MoE layer gives {tuple(got.shape)} {got.dtype}")
        need(dropped == rule, f"the reference dropped {dropped} entries at "
             f"capacity {cap}, the rule {rule}")
        need((dropped > 0) == (label == "published"),
             f"{dropped} entries dropped at capacity factor {factor}")
        need(err <= rel * scale, f"MoE layer at capacity factor {factor} "
             f"differs from the fp32 per-token reference by {err} > {rel} * "
             f"{scale}")
        moe_ref[label] = dict(capacity_factor=factor, cap=cap,
                              dropped=dropped, dropped_rule=rule,
                              max_abs_err=err, ref_max=scale,
                              rel_err=err / scale)
        del got, want
    del x
    cons_cfg = dataclasses.replace(cfg, capacity_factor=cf)
    cons = type(model)(cons_cfg, device="cuda", params=model.params)
    short = prompts[:, :KIMI_PROMPT]
    run = prefill_of(cons, side)
    lp, c = run(short, max_len=KIMI_PROMPT + 1)
    first = lp.argmax(-1)
    ld, c = cons.decode_step(c, first)
    longer = state["np"].concatenate([short, first.cpu().numpy()[:, None]],
                                     axis=1)
    lf, _ = run(longer)
    need(bool(torch.isfinite(ld.float()).all()), "non-finite decode logits")
    err = float((ld.float() - lf.float()).abs().max())
    scale = float(lf.float().abs().max())
    t_pre = LM_BATCH * KIMI_PROMPT
    tol, tol_reason = CONSISTENCY_TOL[phase]
    return dict(
        cap_prefill=moe_capacity(LM_BATCH * prompts.shape[1], cfg),
        cap_decode_step=moe_capacity(LM_BATCH, cfg),
        timed_capacity_factor=cfg.capacity_factor, moe_ref=moe_ref,
        consistency_prompt=KIMI_PROMPT, consistency_capacity_factor=cf,
        consistency_cap_prefill=[moe_capacity(t_pre, cons_cfg),
                                 moe_capacity(t_pre + LM_BATCH, cons_cfg)],
        consistency_cap_decode_step=moe_capacity(LM_BATCH, cons_cfg),
        consistency_max_abs_err=err, consistency_logit_max=scale,
        consistency_rel_err=err / scale, consistency_tol=tol,
        consistency_tol_reason=tol_reason)


# ---------------------------------------------------------------------------
# training on one card
# ---------------------------------------------------------------------------

TRAIN_ARCH = LM_ARCH
TRAIN_BATCH = 4           # sequences a step
TRAIN_SEQ = 2048          # tokens a sequence
TRAIN_MICROBATCHES = 2
TRAIN_STEPS = 8
TRAIN_CKPT_EVERY = 4
TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
#: (a)'s shapes: one attention call of a training microbatch of Qwen2-7B
TRAIN_ATTENTION = ((2, 28, 2048, 128), (2, 4, 2048, 128))
TRAIN_ATTENTION_TOL = (
    2e-2, "bf16 q, k, v and gradients (2^-9 relative each) against fp32 "
          "autograd through flash_attention_ref; the kernel's P is rounded "
          "to bf16 before P V, and the backward's row sums D read the bf16 "
          "output; relative to each gradient's max |value|")
#: (a)'s fp32 backward (3xTF32) against the plain one (TF32 off), of each
#: gradient's and each 128-row or 128-key block's max, as the card tests
TRAIN_FP32_TOL = 1e-4
#: (b)'s families: small fp32 models whose loss reaches attention or
#: RWKV-6's scan
TRAIN_CROSS = (LM_ARCH, SSM_ARCH, MOE_ARCH, VLM_ARCH, HYBRID_ARCH,
               ENCDEC_ARCH)
TRAIN_CROSS_TOL = (
    1e-4, "fp32 (TF32 off) with other summation orders on the two devices; "
          "relative to each gradient leaf's max |value|, or to a thousandth "
          "of the largest leaf's where a gradient is zero but for rounding "
          "(the enc-dec's key biases under the softmax's shift invariance)")
TRAIN_CROSS_SSM_TOL = (
    1e-3, "RWKV-6's fp32 gradients are ill-conditioned: the CPU alone "
          "moves them by cpu_order_spread (printed beside) when only its "
          "thread count, so its GEMMs' summation order, changes, and the "
          "card's 3xTF32 scan kernel and GEMMs sum in other orders again; "
          "an order above that spread, relative to each gradient leaf's "
          "max |value| or a thousandth of the largest leaf's")
TRAIN_RESUME_TOL = (
    2e-3, "the resumed run replays steps 4-7 from the step-4 checkpoint "
          "(bf16 parameters, fp32 moments, bit for bit); on CUDA the "
          "embedding's backward (an indexed add over repeated token ids) "
          "and the bf16 GEMMs' split-K reductions may add in another order "
          "from run to run, and AdamW turns a gradient's last bit into a "
          "whole update on an element whose gradient is near 0; relative "
          "to the loss")
DEPTH_CUT["train"] = (
    4, "Qwen2-7B's 7.62 B parameters train with bf16 weights and "
       "gradients, an fp32 gradient accumulator and fp32 AdamW moments: "
       "16 bytes a parameter, 122 GB, more than one 80 GB card; 4 of 28 "
       "layers (4 x 233.06 M) with the embedding and the untied head (2 x "
       "545.0 M) are 2.02 B parameters, 32.4 GB, plus about 6 GB of fp32 "
       "logits and their gradient per microbatch of 2 x 2048 tokens")


def train_config(get_config):
    import dataclasses
    return dataclasses.replace(get_config(TRAIN_ARCH),
                               n_layers=DEPTH_CUT["train"][0])


def grad_rel_errs(got, want):
    """Per leaf path: max |got - want| over max(max |want|, a thousandth
    of the largest |want|), got moved to want's device."""
    gmax = max(float(t.abs().max()) for t in want.values())
    return {k: float((g.to(want[k].device).float() - want[k].float())
                     .abs().max())
            / max(float(want[k].abs().max()), 1e-3 * gmax, 1e-30)
            for k, g in got.items()}


def grad_block_errors(torch, F, label, got, want, rel):
    """``flash_block_errors`` of each attention gradient: dq by (sequence,
    q head, 128 rows), dk and dv by (sequence, kv head, 128 keys), each
    block within ``rel`` of its own max (a block of no row or key exactly
    0).  A causal call's gradients shrink with position (dv of key j as
    about sqrt(e / j), dq of row i as 1 / sqrt(i)), so the first blocks'
    max sets a global tolerance above a later block's typical value."""
    return {name: flash_block_errors(torch, F, f"{label} {name}", g, w, rel)
            for name, g, w in zip(("dq", "dk", "dv"), got, want)}


def train_attention_check(torch, state):
    """(a): ``FlashAttention`` forward and backward at a training call's
    shapes in bf16, causal, against autograd through
    ``flash_attention_ref`` in fp32 on the card; the backward kernel
    against ``ref.flash_attention_bwd_ref`` on the same tensors and
    against itself (two calls bit for bit); each check on the whole
    gradient and on each 128-row (dq) or 128-key (dk, dv) block; the
    forward and backward kernels, the plain backward, SDPA's backward
    alone and its forward plus backward timed; the fp32 backward (3xTF32)
    checked against the plain one and both timed at the same shapes.
    Sets ``flash_attention_bwd``'s row of the ``kernels`` line (this one
    call: its ms, plain ms, bound of the gradient's five products, SDPA's
    backward as the library call; the forward plus backward of the port
    and of SDPA beside them)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(43)
    qs, kvs = TRAIN_ATTENTION
    q, k, v, do = (torch.randn(s, generator=gen, device="cuda")
                   .to(torch.bfloat16) for s in (qs, kvs, kvs, qs))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=True)
    before = ops.launch_counts()["flash_attention_bwd"]
    got = torch.autograd.grad(out, leaves, do)
    need(ops.launch_counts()["flash_attention_bwd"] == before + 1,
         "FlashAttention's backward did not launch its kernel once")
    torch.backends.cuda.matmul.allow_tf32 = False
    ref_in = [t.float().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(
        ref.flash_attention_ref(*ref_in, causal=True), ref_in, do.float())
    tol, why = TRAIN_ATTENTION_TOL
    errs = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        errs[name] = float((g.float() - w).abs().max() / w.abs().max())
        need(g.dtype == torch.bfloat16 and errs[name] <= tol,
             f"FlashAttention {name} differs by {errs[name]} > {tol}")
    blocks = grad_block_errors(torch, F, "FlashAttention", got, want, tol)
    del got, want, ref_in, leaves, out
    scale = qs[-1] ** -0.5
    o = fa.flash_attention(q, k, v, causal=True)
    kernel = lambda: fab.flash_attention_bwd(  # noqa: E731
        q, k, v, o, do, True, scale, None)
    plain = lambda: ref.flash_attention_bwd_ref(  # noqa: E731
        q, k, v, o, do, causal=True)
    first, again, want_plain = kernel(), kernel(), plain()
    need(all(torch.equal(a, b) for a, b in zip(first, again)),
         "two backward calls differ")
    plain_errs, max_abs = {}, 0.0
    for name, g, w in zip(("dq", "dk", "dv"), first, want_plain):
        diff = float((g.float() - w.float()).abs().max())
        max_abs = max(max_abs, diff)
        plain_errs[name] = diff / float(w.float().abs().max())
        need(plain_errs[name] <= tol, f"the backward kernel's {name} "
             f"differs from the plain backward's by {plain_errs[name]}")
    plain_blocks = grad_block_errors(torch, F, "backward kernel vs plain",
                                     first, want_plain, tol)
    del first, again, want_plain
    fwd_ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True),
                     REPS)
    bwd_ms = cuda_ms(torch, kernel, REPS)
    plain_ms = cuda_ms(torch, plain, REPS)
    sq = [t.clone().requires_grad_(True) for t in (q, k, v)]

    def sdpa():
        y = F.scaled_dot_product_attention(*sq, is_causal=True,
                                           enable_gqa=True)
        torch.autograd.grad(y, sq, do)

    sdpa_ms = cuda_ms(torch, sdpa, REPS)
    # SDPA's backward alone: its forward once, outside the timed calls
    y = F.scaled_dot_product_attention(*sq, is_causal=True, enable_gqa=True)
    sdpa_bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        y, sq, do, retain_graph=True), REPS)
    del y, sq
    sdpa_fwd_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), REPS)
    fp32 = train_attention_fp32(torch, F, q, k, v, do, scale)
    n, hq, s, d = qs
    causal_flops = 2.0 * n * hq * s * s * d       # Q K^T and P V, half
    # the backward reads q, k, v, o, dO and writes dq, dk, dv once
    bwd_bytes = 2.0 * (3 * q.numel() + 2 * k.numel()) \
        + 2.0 * (q.numel() + 2 * k.numel())
    row = with_bound({"ops_ms": ops_ms(state, "flash_attention_bwd",
                                       2.5 * causal_flops, "bfloat16"),
                      "bytes": bwd_bytes}, state["peaks"][1])
    row.update(max_abs_err=max_abs, ms=bwd_ms, plain_ms=plain_ms,
               library_ms=sdpa_bwd_ms, fwd_bwd_ms=fwd_ms + bwd_ms,
               library_fwd_bwd_ms=sdpa_ms, fp32_ms=fp32["backward_ms"],
               fp32_plain_ms=fp32["plain_backward_ms"],
               library_what="SDPA's backward alone (enable_gqa; "
                            "autograd.grad through a retained graph); "
                            "library_fwd_bwd_ms is its forward + backward, "
                            "against fwd_bwd_ms, the port's")
    state.setdefault("kernel_totals", {})["flash_attention_bwd"] = row
    return {"q": list(qs), "kv": list(kvs), "dtype": "bfloat16",
            "causal": True, "rel_err": errs, "tol": tol, "tol_reason": why,
            "blocks": blocks, "kernel_vs_plain_rel_err": plain_errs,
            "kernel_vs_plain_blocks": plain_blocks,
            "kernel_vs_plain_max_abs_err": max_abs, "bit_identical": True,
            "bwd_parts": fab.parts(
                n, kvs[1], s, torch.bfloat16,
                torch.cuda.get_device_properties(0).multi_processor_count),
            "forward_ms": fwd_ms, "forward_route": fa.route(q, k, v),
            "sdpa_forward_ms": sdpa_fwd_ms, "backward_ms": bwd_ms,
            "plain_backward_ms": plain_ms, "sdpa_backward_ms": sdpa_bwd_ms,
            "sdpa_fwd_bwd_ms": sdpa_ms, "fwd_bwd_ms": fwd_ms + bwd_ms,
            "forward_bound_ms": ops_ms(state, "flash_attention",
                                       causal_flops, "bfloat16"),
            "backward_bound_ms": row["bound_ms"],
            "fwd_bwd_bound_ms": ops_ms(state, "flash_attention",
                                       3.5 * causal_flops, "bfloat16"),
            "plain_bwd_block_rows": ref.BWD_BLOCK_ROWS, "fp32": fp32}


def train_attention_fp32(torch, F, q, k, v, do, scale):
    """(a)'s fp32 half: the 3xTF32 backward kernel against the plain
    backward (TF32 off) on fp32 copies of the same tensors, within 1e-4
    of each gradient's and each block's max, and both timed."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import ref
    q, k, v, do = (t.float() for t in (q, k, v, do))
    o = fa.flash_attention(q, k, v, causal=True)
    kernel = lambda: fab.flash_attention_bwd(  # noqa: E731
        q, k, v, o, do, True, scale, None)
    plain = lambda: ref.flash_attention_bwd_ref(  # noqa: E731
        q, k, v, o, do, causal=True)
    got, want = kernel(), plain()
    errs = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        errs[name] = float((g - w).abs().max() / w.abs().max())
        need(g.dtype == torch.float32 and errs[name] <= TRAIN_FP32_TOL,
             f"the fp32 backward kernel's {name} differs from the plain "
             f"backward's by {errs[name]} > {TRAIN_FP32_TOL}")
    blocks = grad_block_errors(torch, F, "fp32 backward kernel vs plain",
                               got, want, TRAIN_FP32_TOL)
    del got, want
    return {"rel_err": errs, "tol": TRAIN_FP32_TOL, "blocks": blocks,
            "backward_ms": cuda_ms(torch, kernel, REPS),
            "plain_backward_ms": cuda_ms(torch, plain, REPS)}


def train_cross_check(torch, state, arch):
    """(b): a small fp32 model of ``arch``'s family (``CROSS_LMS``; the
    MoE at capacity factor E / k) on the card and on the CPU from the
    same weights: the loss and every gradient leaf."""
    import dataclasses
    from repro_torch.configs import build_model, get_config
    from repro_torch.models.lm import batch_on_device
    from repro_torch.train.tree import flatten_with_paths, leaves
    from repro_torch.vae.model import map_params
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch), dtype=torch.float32,
                              **CROSS_LMS[arch])
    if cfg.family == "moe":
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)
    gpu = build_model(cfg, device="cuda", seed=11)
    cpu = type(gpu)(cfg, device="cpu",
                    params=map_params(gpu.params, lambda t: t.cpu()))
    toks = state["np"].random.default_rng(47).integers(0, cfg.vocab_size,
                                                       (2, 45))
    batch = {"tokens": toks, "labels": toks}
    side = side_input(torch, cfg, 2, CROSS_PREFIX, 47, device="cpu")
    if side is not None:
        batch["frames" if cfg.family == "encdec" else "vision_embeds"] = side
    out = {}
    runs = [("cuda", gpu, None), ("cpu", cpu, None)]
    if cfg.ssm_type == "rwkv6":
        runs.append(("cpu_1_thread", cpu, 1))
    threads = torch.get_num_threads()
    for name, model, n_threads in runs:
        torch.set_num_threads(n_threads or threads)
        flat = leaves(model.params)
        for p in flat:
            p.requires_grad_(True)
        loss = model.loss(batch_on_device(batch, model.device))
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        out[name] = (loss.item(), {k: (torch.zeros_like(p) if g is None
                                       else g)
                                   for (k, p), g in zip(
                                       flatten_with_paths(model.params),
                                       grads)})
    torch.set_num_threads(threads)
    spread = {}
    if "cpu_1_thread" in out:
        tol, why = TRAIN_CROSS_SSM_TOL
        spread = {"cpu_order_spread": max(grad_rel_errs(
            out["cpu_1_thread"][1], out["cpu"][1]).values())}
    else:
        tol, why = TRAIN_CROSS_TOL
    loss_rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    errs = grad_rel_errs(out["cuda"][1], out["cpu"][1])
    worst = max(errs, key=errs.get)
    need(loss_rel <= tol, f"small {arch} loss differs by {loss_rel}")
    need(errs[worst] <= tol, f"small {arch} gradient {worst} differs by "
         f"{errs[worst]} > {tol}")
    return {"arch": arch, "config": dict(model_shape(cfg), dtype="float32"),
            "tokens": [2, 45], "loss": out["cpu"][0], "loss_rel_err": loss_rel,
            "grad_leaves": len(errs), "grad_rel_err_max": errs[worst],
            "grad_rel_err_worst_leaf": worst, "tol": tol, "tol_reason": why,
            **spread}


def train_guard_check(torch):
    """(f): a CUDA wrapper with no backward (``conv3x3``, VAE) refuses an
    input that requires grad under grad mode; ``rwkv6_scan``, which has
    one (``RWKV6Scan``), launches once there and is in the graph."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(53)
    r, k, v, w = (torch.randn((1, 2, 8, 16), generator=gen, device="cuda")
                  for _ in range(4))
    u = torch.randn((2, 16), generator=gen, device="cuda")
    x = torch.randn((1, 8, 8, 16), generator=gen, device="cuda")
    cw = torch.randn((3, 3, 16, 16), generator=gen, device="cuda")
    seen = {}
    before = ops.launch_counts()
    try:
        ops.conv3x3(x.requires_grad_(True), cw)
        raise SmokeFailure("conv3x3 launched on an input that requires "
                           "grad")
    except NotImplementedError as err:
        seen["conv3x3"] = str(err)
    need(ops.launch_counts() == before, "a refused call launched")
    out, _ = ops.rwkv6_scan(r.requires_grad_(True), k, v, w, u)
    seen["rwkv6_scan"] = type(out.grad_fn).__name__
    need(seen["rwkv6_scan"] == "RWKV6ScanBackward",
         f"rwkv6_scan under grad: {seen['rwkv6_scan']}")
    need(ops.launch_counts()["rwkv6_scan"] == before["rwkv6_scan"] + 1,
         "rwkv6_scan under grad did not launch once")
    return seen


#: device kernels of ``flash_attention``'s forward (every route) and of
#: its backward, by a part of their names
FLASH_FORWARD_KERNELS = ("fa_bf16_kernel", "fa_bf16_tma_kernel",
                         "fa_f32_kernel", "fa_wide_kernel")
FLASH_BACKWARD_KERNELS = ("bwd_rows_kernel", "bwd_dkdv_kernel",
                          "sum_parts_kernel")


def train_profile(torch, step):
    """One train step under ``torch.profiler``: device ms of the
    ``flash_attention`` forward kernels and of its backward (each by its
    kernels' names: the profiler does not attribute a ``ctypes`` launch
    to the ``record_function`` range around it, so the backward's range
    adds only the PyTorch kernels it launches, ``do.contiguous()``'s
    copy), of the ``adamw`` range, of the other GEMMs, and the rest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    gemm = ("gemm", "xmma", "cutlass", "nvjet", "sm90_", "matmul")

    def is_gemm(name):
        return any(g in name.lower() for g in gemm)

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    flash = sum(e.self_device_time_total for e in kernels
                if any(n in e.name for n in FLASH_FORWARD_KERNELS)) / 1e3
    flash_bwd = sum(e.self_device_time_total for e in kernels
                    if any(n in e.name for n in FLASH_BACKWARD_KERNELS)
                    ) / 1e3
    gemm_all = sum(e.self_device_time_total for e in kernels
                   if is_gemm(e.name)) / 1e3

    def launched(ev):
        """Kernels launched from ``ev`` and its children (name, us)."""
        out = [(kk.name, kk.duration) for kk in getattr(ev, "kernels", [])]
        for ch in ev.cpu_children:
            out += launched(ch)
        return out

    ranges = {"flash_attention_bwd": [], "adamw": []}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in ranges:
            ranges[e.name] += launched(e)
    in_range = [(n, us) for n, us in ranges["flash_attention_bwd"]
                if not any(k in n for k in FLASH_BACKWARD_KERNELS)]
    bwd_torch = sum(us for _, us in in_range) / 1e3
    bwd_gemm = sum(us for n, us in in_range if is_gemm(n)) / 1e3
    opt = sum(us for _, us in ranges["adamw"]) / 1e3
    split = {"flash_attention_forward_ms": flash,
             "attention_backward_ms": flash_bwd + bwd_torch,
             "other_gemm_ms": gemm_all - bwd_gemm, "optimizer_ms": opt}
    split["rest_ms"] = total - sum(split.values())
    by_name = Counter()
    for e in kernels:
        by_name[e.name[:90]] += e.self_device_time_total / 1e3
    return {"device_ms": total, **split,
            "attention_backward_kernels_ms": flash_bwd,
            "attention_backward_torch_ms": bwd_torch,
            "device_kernels": len(kernels),
            "top": [{"kernel": k, "ms": ms, "gemm": is_gemm(k)}
                    for k, ms in by_name.most_common(12)]}


def phase_train(torch, log, state):
    """Training on one card: the grad guard (f), ``FlashAttention`` at a
    training call's shapes (a), small fp32 models of each attention
    family on the card against the CPU (b), then Qwen2-7B at full width
    (``DEPTH_CUT``) in bf16: ``Trainer.run`` for ``TRAIN_STEPS`` steps of
    4 x 2048 Zipf tokens in 2 microbatches, remat on, async checkpoints
    every ``TRAIN_CKPT_EVERY``; a second trainer resumed from the step-4
    checkpoint (c); finite losses that fall (d); ``flash_attention``
    launches per step = layers x microbatches x 2 (e); step times, peak
    memory, TFLOP/s and a profile of one step."""
    import shutil
    import tempfile
    np = state["np"]
    from repro_torch.configs import build_model, get_config
    from repro_torch.data.synthetic import DataConfig, SyntheticTokens
    from repro_torch.kernels import ops
    from repro_torch.train.optim import AdamW, AdamWConfig
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig
    state.pop("vae", None)
    gc.collect()
    torch.cuda.empty_cache()
    guard = train_guard_check(torch)
    attention = train_attention_check(torch, state)
    cross = [train_cross_check(torch, state, a) for a in TRAIN_CROSS]
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = train_config(get_config)
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device="cuda", seed=0)
    n_params = model.n_params
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH))
    per_step = {k: 0 for k in KERNELS}
    per_step["flash_attention"] = cfg.n_layers * TRAIN_MICROBATCHES * 2
    per_step["flash_attention_bwd"] = cfg.n_layers * TRAIN_MICROBATCHES
    # two 20 GB checkpoints: under the checkout's ignored build/, on the
    # disk that holds the kernels' build, not in OUT_DIR (copied back)
    (ROOT / "build").mkdir(exist_ok=True)
    ckpt_root = tempfile.mkdtemp(prefix="train-ckpt-", dir=ROOT / "build")
    try:
        def trainer():
            opt = AdamW(AdamWConfig(**TRAIN_OPT))
            step = make_train_step(model, opt, TRAIN_MICROBATCHES)
            dev_ms, launches = [], []

            def timed(*args):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                before = ops.launch_counts()
                start.record()
                out = step(*args)
                stop.record()
                stop.synchronize()
                dev_ms.append(start.elapsed_time(stop))
                after = ops.launch_counts()
                launches.append({k: after[k] - before[k] for k in KERNELS})
                out[3]["grad_norm"] = float(out[3]["grad_norm"])
                grad_norms.append(out[3]["grad_norm"])
                return out

            grad_norms = []
            tr = Trainer(model, opt, data, TrainerConfig(
                steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT_EVERY,
                ckpt_dir=ckpt_root, keep_last=2,
                microbatches=TRAIN_MICROBATCHES, log_every=1), step_fn=timed)
            return tr, dev_ms, launches, grad_norms

        first, dev_ms, step_launches, grad_norms = trainer()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        first.run(model.params)
        run_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        state["launches"]["train"] = launches
        peak = torch.cuda.max_memory_allocated()
        losses = [h["loss"] for h in first.history]
        need(len(losses) == TRAIN_STEPS and all(map(np.isfinite, losses)),
             f"train losses {losses}")
        need(losses[-1] < losses[0], f"the loss did not fall: {losses}")
        need(all(s == per_step for s in step_launches),
             f"launches per step {step_launches}, expected {per_step}")
        need(launches == {k: TRAIN_STEPS * n for k, n in per_step.items()},
             f"train run launched {launches}")
        need(first.ckpt.all_steps() == [4, 8],
             f"checkpoints {first.ckpt.all_steps()}")
        ckpt_bytes = sum(f.stat().st_size for f in
                         Path(ckpt_root, "step_000000004").iterdir())
        # preempted after step 4's checkpoint: a second trainer resumes
        shutil.rmtree(Path(ckpt_root, "step_000000008"))
        second, _, resume_launches, _ = trainer()
        t0 = time.perf_counter()
        second.run(model.params)
        resume_s = time.perf_counter() - t0
        resumed = [h["loss"] for h in second.history]
        tol, why = TRAIN_RESUME_TOL
        rel = [abs(a - b) / abs(b) for a, b in zip(resumed, losses[4:])]
        need([h["step"] for h in second.history] == list(range(4, 8)),
             f"resumed steps {[h['step'] for h in second.history]}")
        need(max(rel) <= tol, f"resumed losses {resumed} against "
             f"{losses[4:]}: {max(rel)} > {tol}")
        need(all(s == per_step for s in resume_launches),
             f"resumed launches per step {resume_launches}")
        # one more step under the profiler, outside both runs
        opt = AdamW(AdamWConfig(**TRAIN_OPT))
        step = make_train_step(model, opt, TRAIN_MICROBATCHES)
        opt_state = opt.init(model.params)
        batch = data.batch(TRAIN_STEPS)
        prof = train_profile(torch, lambda: step(model.params, opt_state,
                                                 None, batch))
        need(prof["flash_attention_forward_ms"] > 0
             and prof["attention_backward_kernels_ms"] > 0,
             f"the profiled step shows no flash attention kernel: {prof}")
        del opt_state
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)

    tokens = TRAIN_BATCH * TRAIN_SEQ
    wall_ms = statistics.median(first.step_times) * 1e3
    dev_med = statistics.median(dev_ms)
    # matmul weights: the layers' (2 N a token forward, 4 N backward, 2 N
    # for remat's forward) and the head's (no remat); the embedding is a
    # gather
    head = cfg.vocab_size * cfg.d_model
    layer_params = n_params - 2 * head
    attn_fwd = 2.0 * TRAIN_BATCH * cfg.n_heads * TRAIN_SEQ ** 2 \
        * cfg.head_dim * cfg.n_layers            # causal Q K^T + P V
    flops = (8.0 * layer_params + 6.0 * head) * tokens + 4.0 * attn_fwd
    bf16_peak = state["peaks"][3]
    emit(log, "train", arch=TRAIN_ARCH, dtype="bfloat16", **model_shape(cfg),
         reduced=dict(layers=[cfg.n_layers,
                              get_config(TRAIN_ARCH).n_layers],
                      why=DEPTH_CUT["train"][1]),
         params=n_params, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         microbatches=TRAIN_MICROBATCHES, remat=cfg.remat,
         steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT_EVERY, optimizer=TRAIN_OPT,
         moment_dtype="float32", grad_dtype="float32",
         losses=losses, grad_norms=grad_norms,
         step_wall_ms=[x * 1e3 for x in first.step_times],
         step_device_ms=dev_ms, step_wall_ms_median=wall_ms,
         step_device_ms_median=dev_med,
         tokens_per_s=tokens / wall_ms * 1e3,
         tokens_per_s_device=tokens / dev_med * 1e3,
         model_flops_per_step=flops,
         flops_formula="(8 N_layers + 6 N_head) tokens (forward, "
                       "backward and, for the layers, remat's forward) + "
                       "4 x the causal attention's forward (twice forward, "
                       "its backward twice that)",
         tflops_per_s=flops / dev_med / 1e9,
         bf16_peak_share=flops / dev_med * 1e3 / bf16_peak,
         max_memory_allocated=peak, checkpoint_bytes=ckpt_bytes,
         run_s=run_s, resume_s=resume_s, resumed_losses=resumed,
         resume_rel_err=rel, resume_tol=tol, resume_tol_reason=why,
         stragglers=first.stragglers, launches=launches,
         launches_per_step=per_step, profile_step=prof,
         attention=attention, crossdevice=cross, guard=guard)
    del model, first, second
    gc.collect()
    torch.cuda.empty_cache()

DIST_RWKV = dict(batch=2, seq=512, steps=3)      # (a): 2 x 512 tokens a step
DIST_LM = dict(batch=2, seq=1024, microbatches=2, steps=2)      # (b)
DIST_DECODE_BUCKET = 8                            # (c): 8 latents of 64x64
DEPTH_CUT["dist_rwkv6"] = (
    2, "enough to show the RWKV-6 gradient through RWKV6Scan in every "
       "layer of a stack (the first layer's input gradient comes from the "
       "second's backward); the kernel's shapes do not depend on depth")
DEPTH_CUT["dist_mesh"] = (
    2, "two copies of the model (the unsharded step's and the mesh "
       "step's) and their fp32 moments on one card: 2 of 28 layers with "
       "the embedding and the untied head are 1.56 B parameters, 25 GB of "
       "moments for both runs")
DIST_RWKV_TOL = (
    2e-2, "bf16 r, k, v, dO and the gradients dr, dk, dv (2^-9 relative "
          "each) against fp32 autograd through the sequential "
          "rwkv6_scan_ref on the same inputs, and against "
          "ref.rwkv6_scan_bwd_ref on the same tensors (fp32 sums each "
          "rounded to bf16 once); dw and du are fp32 from the same bf16 "
          "inputs, the kernel's products in 3xTF32 and its sums in another "
          "order; relative to each gradient's max |value|, and each 64-token "
          "block of dr, dk, dv and dw to its own max")
#: tokens a block of (a)'s per-block check holds to its own max
RWKV_BLOCK = 64


def rwkv6_bwd_work(shape, elt):
    """(FLOPs, bytes) of one ``rwkv6_scan_bwd`` call at r [n, h, t, d] in
    ``elt`` bytes with no state and no state cotangent: its d^2 products,
    10 d^2 per (sequence, head, token) -- the states' recompute (2 d^2),
    X = dO S0^T, Y = v dS, dv's inter term and the cotangent's update (2
    d^2 each) -- at the TF32 rate, three products each (``ops_ms``); r, k,
    v and dO (``elt``), w and u (fp32) read once, dr, dk, dv (``elt``),
    dw and du (fp32) written once.  The state scratch is the kernel's own
    choice and not counted."""
    n, h, t, d = shape
    elems = n * h * t * d
    nbytes = (4 * elt + 4) * elems + (3 * elt + 4) * elems + 2 * 4 * h * d
    return float(10 * elems * d), float(nbytes)


def dist_rwkv6_scan_check(torch, state):
    """(a)'s kernel check at the training shape, r, k, v [2, 64, 512, 64]
    bf16: ``RWKV6Scan``'s backward launches ``rwkv6_scan_bwd`` once and
    nothing else; its gradients against autograd through the sequential
    plain scan in fp32, and the kernel against ``ref.rwkv6_scan_bwd_ref``
    on the same tensors, each also per 64-token block of dr, dk, dv and
    dw against that block's max; two kernel calls bit for bit; the
    forward kernel's, the backward kernel's (its wrapper, and the whole
    autograd backward) and the plain backward's ms.  Sets
    ``rwkv6_scan_bwd``'s row of the ``kernels`` line."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rwkv6_scan_bwd as krb
    cfg = state["dist_rwkv_cfg"]
    h, d = cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim
    shape = (DIST_RWKV["batch"], h, DIST_RWKV["seq"], d)
    gen = torch.Generator(device="cuda").manual_seed(59)
    r, k, v, do = (torch.randn(shape, generator=gen, device="cuda") * 0.5
                   for _ in range(4))
    r, k, v, do = (t.to(torch.bfloat16) for t in (r, k, v, do))
    w = torch.randn(shape, generator=gen, device="cuda") * 0.6 - 1.0
    u = torch.randn((h, d), generator=gen, device="cuda") * 0.1
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, w, u)]
    out, _ = ops.rwkv6_scan(*leaves)
    before = ops.launch_counts()
    got = torch.autograd.grad(out, leaves, do, retain_graph=True)
    after = ops.launch_counts()
    launched = {k_: after[k_] - before[k_] for k_ in after
                if after[k_] != before[k_]}
    need(launched == {"rwkv6_scan_bwd": 1},
         f"RWKV6Scan's backward launched {launched}")
    ref_in = [t.detach().float().requires_grad_(True)
              for t in (r, k, v, w, u)]
    want = torch.autograd.grad(ref.rwkv6_scan_ref(*ref_in)[0], ref_in,
                               do.float())
    tol, why = DIST_RWKV_TOL
    names = ("dr", "dk", "dv", "dw", "du")
    errs = {}
    for name, g, wt in zip(names, got, want):
        errs[name] = float((g.float() - wt).abs().max() / wt.abs().max())
        need(bool(torch.isfinite(g.float()).all()) and errs[name] <= tol,
             f"RWKV6Scan {name} differs by {errs[name]} > {tol}")

    def blocks(label, ours, theirs):
        out_ = {}
        for name, g, wt in zip(names[:4], ours, theirs):
            b = flash_block_errors(torch, F, f"{label} {name}", g, wt, tol,
                                   rows=RWKV_BLOCK)
            w_ = b["block_worst"]
            b["worst_share"] = w_["max_abs_err"] / w_["tol"]
            out_[name] = b
        return out_

    grad_blocks = blocks("RWKV6Scan", got, want)
    del got, want, ref_in
    kernel = lambda: krb.rwkv6_scan_bwd(  # noqa: E731
        r, k, v, w, u, None, do, None)
    plain = lambda: ref.rwkv6_scan_bwd_ref(  # noqa: E731
        r, k, v, w, u, None, do, None)
    first, again, want_plain = kernel(), kernel(), plain()
    need(all(torch.equal(a, b) for a, b in zip(first[:5], again[:5])),
         "two rwkv6_scan_bwd calls differ")
    plain_errs, max_abs = {}, 0.0
    for name, g, wt in zip(names, first, want_plain):
        diff = float((g.float() - wt.float()).abs().max())
        max_abs = max(max_abs, diff)
        plain_errs[name] = diff / float(wt.float().abs().max())
        need(g.dtype == (r.dtype if name in ("dr", "dk", "dv")
                         else torch.float32) and plain_errs[name] <= tol,
             f"the backward kernel's {name} differs from the plain "
             f"backward's by {plain_errs[name]}")
    plain_blocks = blocks("rwkv6_scan_bwd vs plain", first, want_plain)
    del first, again, want_plain
    with torch.no_grad():
        fwd_ms = cuda_ms(torch, lambda: ops.rwkv6_scan(r, k, v, w, u), REPS)
    bwd_ms = cuda_ms(torch, kernel, REPS)
    autograd_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True), REPS)
    plain_ms = cuda_ms(torch, plain, 3)
    flops, nbytes = rwkv6_bwd_work(shape, 2)
    row = with_bound({"ops_ms": ops_ms(state, "rwkv6_scan_bwd", flops),
                      "bytes": nbytes}, state["peaks"][1])
    row.update(max_abs_err=max_abs, ms=bwd_ms, plain_ms=plain_ms,
               library_ms=None)
    state.setdefault("kernel_totals", {})["rwkv6_scan_bwd"] = row
    nc = -(-shape[2] // ref.RWKV_CHUNK)
    return {"r": list(shape), "dtype": "bfloat16", "rel_err": errs,
            "tol": tol, "tol_reason": why, "blocks": grad_blocks,
            "kernel_vs_plain_rel_err": plain_errs,
            "kernel_vs_plain_blocks": plain_blocks,
            "kernel_vs_plain_max_abs_err": max_abs, "bit_identical": True,
            "forward_ms": fwd_ms, "backward_ms": bwd_ms,
            "autograd_backward_ms": autograd_ms,
            "plain_backward_ms": plain_ms, "backward_bound_ms":
            row["bound_ms"], "backward_bound_by": row["bound_by"],
            "backward_flops": flops, "backward_bytes": nbytes,
            "state_scratch_bytes": 4 * shape[0] * h * (nc + 1) * d * d,
            "backward": "rwkv6_scan_bwd: the kernel of "
                        "csrc/rwkv6_scan_bwd.cu (states recomputed by the "
                        "forward's walk, a reverse walk of 16-token "
                        "sub-chunks, du summed in order)"}


#: device kernels of ``rwkv6_scan_bwd`` by a part of their names; its
#: states' recompute is the forward's ``rwkv6_chunk_kernel`` instantiated
#: with SAVE = true (a name that also holds "true")
RWKV_BACKWARD_KERNELS = ("rwkv6_bwd_kernel", "rwkv6_bwd_du",
                         "rwkv6_bwd_sum_tiles")


def rwkv6_profile(torch, step):
    """One rwkv6-7b train step under ``torch.profiler``: its device ms,
    the ``rwkv6_scan_bwd`` kernels' (by their names: the profiler does not
    attribute a ``ctypes`` launch to the ``record_function`` range around
    it, so the range adds only the PyTorch kernels it launches itself),
    the forward scan kernels', and the rest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]

    def is_bwd(name):
        return any(n in name for n in RWKV_BACKWARD_KERNELS) or (
            "rwkv6_chunk_kernel" in name and "true" in name)

    def is_fwd(name):
        return not is_bwd(name) and ("rwkv6_chunk_kernel" in name
                                     or "rwkv6_decode_kernel" in name)

    def launched(ev):
        out = [(kk.name, kk.duration) for kk in getattr(ev, "kernels", [])]
        for ch in ev.cpu_children:
            out += launched(ch)
        return out

    total = sum(e.self_device_time_total for e in kernels) / 1e3
    bwd = sum(e.self_device_time_total for e in kernels
              if is_bwd(e.name)) / 1e3
    fwd = sum(e.self_device_time_total for e in kernels
              if is_fwd(e.name)) / 1e3
    in_range = [us for e in prof.events()
                if e.device_type == DeviceType.CPU
                and e.name == "rwkv6_scan_bwd"
                for n, us in launched(e) if not is_bwd(n)]
    by_name = Counter()
    for e in kernels:
        by_name[e.name[:90]] += e.self_device_time_total / 1e3
    return {"device_ms": total, "rwkv6_scan_bwd_kernels_ms": bwd,
            "rwkv6_scan_bwd_torch_ms": sum(in_range) / 1e3,
            "rwkv6_scan_forward_ms": fwd,
            "rest_ms": total - bwd - fwd - sum(in_range) / 1e3,
            "device_kernels": len(kernels),
            "top": [{"kernel": k, "ms": ms}
                    for k, ms in by_name.most_common(8)]}


def dist_rwkv6_train(torch, state):
    """(a): rwkv6-7b at full width, 2 of 32 layers, bf16, 3 AdamW steps
    of 2 x 512 Zipf tokens: finite losses, ``rwkv6_scan`` launches per
    step = layers x (2 with remat, its forward again in the backward),
    ``rwkv6_scan_bwd`` launches = layers; each step's device ms; then a
    fourth step under ``torch.profiler`` (``rwkv6_profile``)."""
    import dataclasses
    np = state["np"]
    from repro_torch.configs import build_model, get_config
    from repro_torch.data.synthetic import DataConfig, SyntheticTokens
    from repro_torch.kernels import ops
    from repro_torch.train.optim import AdamW, AdamWConfig
    from repro_torch.train.train_step import make_train_step
    cfg = dataclasses.replace(get_config(SSM_ARCH),
                              n_layers=DEPTH_CUT["dist_rwkv6"][0])
    state["dist_rwkv_cfg"] = cfg
    model = build_model(cfg, device="cuda", seed=0)
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=DIST_RWKV["seq"],
                                      global_batch=DIST_RWKV["batch"]))
    opt = AdamW(AdamWConfig(**TRAIN_OPT))
    step = make_train_step(model, opt)
    opt_state = opt.init(model.params)
    per_step = {k: 0 for k in KERNELS}
    per_step["rwkv6_scan"] = cfg.n_layers * (2 if cfg.remat else 1)
    per_step["rwkv6_scan_bwd"] = cfg.n_layers
    losses, dev_ms, step_launches = [], [], []
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    for i in range(DIST_RWKV["steps"]):
        before = ops.launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        _, opt_state, _, met = step(model.params, opt_state, None,
                                    data.batch(i))
        stop.record()
        stop.synchronize()
        dev_ms.append(start.elapsed_time(stop))
        after = ops.launch_counts()
        step_launches.append({k: after[k] - before[k] for k in KERNELS})
        losses.append(float(met["loss"]))
    holder = {"opt_state": opt_state}

    def profiled_step():
        holder["opt_state"] = step(model.params, holder["opt_state"], None,
                                   data.batch(DIST_RWKV["steps"]))[1]

    prof = rwkv6_profile(torch, profiled_step)
    opt_state = holder["opt_state"]
    launches = ops.launch_counts()
    state["launches"]["dist_rwkv6"] = launches
    need(all(map(np.isfinite, losses)), f"rwkv6 train losses {losses}")
    need(all(s == per_step for s in step_launches),
         f"rwkv6 launches per step {step_launches}, expected {per_step}")
    out = {"arch": SSM_ARCH, **model_shape(cfg), "dtype": "bfloat16",
           "reduced": dict(layers=[cfg.n_layers,
                                   get_config(SSM_ARCH).n_layers],
                           why=DEPTH_CUT["dist_rwkv6"][1]),
           "params": model.n_params, "tokens": [DIST_RWKV["batch"],
                                                DIST_RWKV["seq"]],
           "remat": cfg.remat, "losses": losses, "step_device_ms": dev_ms,
           "launches": launches, "launches_per_step": per_step,
           "rwkv6_scan_bwd_launches_per_step": per_step["rwkv6_scan_bwd"],
           "profile_step": prof,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    del model, opt_state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dist_mesh_step(torch, state):
    """(b): Qwen2-7B at full width (2 of 28 layers), bf16, 2 steps of 2
    microbatches of 1 x 1024 tokens, unsharded, then from the same
    weights on ``make_local_mesh()`` (NCCL, world size 1) with ZeRO-1
    moments and the "local" gradient plan: losses and parameters equal
    bit for bit, the same ``flash_attention`` launches.  Both under
    ``torch.use_deterministic_algorithms`` (the embedding's backward, an
    indexed add over repeated ids, otherwise adds in another order from
    run to run)."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs import build_model, get_config
    from repro_torch.data.synthetic import DataConfig, SyntheticTokens
    from repro_torch.dist import sharding as D
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train.optim import AdamW, AdamWConfig
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.tree import flatten_with_paths, leaves
    cfg = dataclasses.replace(get_config(LM_ARCH),
                              n_layers=DEPTH_CUT["dist_mesh"][0])
    model = build_model(cfg, device="cuda", seed=0)
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=DIST_LM["seq"],
                                      global_batch=DIST_LM["batch"]))
    batches = [data.batch(i) for i in range(DIST_LM["steps"])]
    mesh = make_local_mesh()
    specs = model.param_pspecs(D.axis_size(mesh, "model"))
    ospecs = D.opt_state_pspecs(specs, zero1=True)
    local = D.map_specs(lambda sp: D.P(*[None if e == "data" else e
                                         for e in sp]), specs)
    sharded = D.distribute_tree(model.params, specs, mesh)
    runs = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name in ("unsharded", "mesh"):
            opt = AdamW(AdamWConfig(**TRAIN_OPT))
            if name == "mesh":
                params = sharded
                opt_state = opt.init(params, ospecs)
                step = make_train_step(model, opt, DIST_LM["microbatches"],
                                       grad_shardings=local)
                D.set_constraint_mesh(mesh)
            else:
                params = model.params
                opt_state = opt.init(params)
                step = make_train_step(model, opt, DIST_LM["microbatches"])
            losses, dev_ms = [], []
            ops.reset_launch_counts()
            for batch in batches:
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                params, opt_state, _, met = step(params, opt_state, None,
                                                 batch)
                stop.record()
                stop.synchronize()
                dev_ms.append(start.elapsed_time(stop))
                losses.append(float(met["loss"]))
            runs[name] = {"losses": losses, "step_device_ms": dev_ms,
                          "launches": ops.launch_counts()}
            if name == "mesh":
                state["launches"]["dist_mesh"] = runs[name]["launches"]
                runs[name]["moments"] = sorted(
                    {str(m.placements) for m in leaves(opt_state.m)})
                D.set_constraint_mesh(None)
            del opt_state
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
        D.set_constraint_mesh(None)
    a, b = runs["unsharded"], runs["mesh"]
    need(a["losses"] == b["losses"],
         f"mesh losses {b['losses']} against {a['losses']}")
    differ = [path for (path, p), q in zip(flatten_with_paths(model.params),
                                           leaves(sharded))
              if not torch.equal(p, q.full_tensor())]
    need(not differ, f"mesh parameters differ from the unsharded step's "
         f"at {differ[:4]} ({len(differ)} leaves)")
    for name in ("flash_attention", "flash_attention_bwd"):
        need(a["launches"][name] == b["launches"][name] > 0,
             f"{name} launches {b['launches']} against {a['launches']}")
    out = {"arch": LM_ARCH, **model_shape(cfg), "dtype": "bfloat16",
           "reduced": dict(layers=[cfg.n_layers,
                                   get_config(LM_ARCH).n_layers],
                           why=DEPTH_CUT["dist_mesh"][1]),
           "mesh": {"shape": list(mesh.shape),
                    "axes": list(mesh.mesh_dim_names),
                    "backend": dist.get_backend()},
           "zero1": True, "grad_plan": "local", **DIST_LM,
           "unsharded": a, "sharded": b, "params_equal": True,
           "prefill": dist_mesh_prefill(torch, state, model, sharded, mesh,
                                        batches[0]["tokens"])}
    del model, sharded
    gc.collect()
    torch.cuda.empty_cache()
    return out, mesh


def dist_mesh_prefill(torch, state, model, sharded, mesh, tokens):
    """(d): ``prefill`` of the same 2 x 1024 tokens on the trained
    weights, plain and then on their DTensor copy over the (1, 1) mesh
    (the cache laid out by ``cache_pspecs``): logits and every cache
    leaf bit-identical, the same ``flash_attention`` launches, both
    prefills' device ms."""
    from repro_torch.dist import sharding as D
    from repro_torch.kernels import ops
    plain_params = model.params
    runs = {}
    try:
        for name in ("plain", "mesh"):
            if name == "mesh":
                model.params = sharded
                D.set_constraint_mesh(mesh)
            ops.reset_launch_counts()
            logits, cache = model.prefill(tokens)
            torch.cuda.synchronize()
            runs[name] = (logits, cache, ops.launch_counts(), cuda_ms(
                torch, lambda: model.prefill(tokens), 3))
            if name == "mesh":
                state["launches"]["dist_prefill"] = runs[name][2]
    finally:
        model.params = plain_params
        D.set_constraint_mesh(None)
    (pl, pc, pn, pms), (ml, mc, mn, mms) = runs["plain"], runs["mesh"]
    need(torch.equal(ml.full_tensor(), pl),
         "the mesh prefill's logits differ from the plain prefill's")
    differ = [k for k in pc if not torch.equal(mc[k].full_tensor(), pc[k])]
    need(not differ, f"the mesh prefill's cache differs at {differ}")
    need(mn == pn and pn["flash_attention"] == model.cfg.n_layers,
         f"mesh prefill launched {mn}, the plain prefill {pn}")
    return {"tokens": list(tokens.shape),
            "cache": {k: [list(v.shape), str(mc[k].placements)]
                      for k, v in pc.items()},
            "logits_placements": str(ml.placements), "launches": mn,
            "mesh_ms": mms, "plain_ms": pms, "bit_identical": True}


def dist_decode_step(torch, state, mesh):
    """(c): ``make_decode_step(SD35_VAE, mesh)`` on the (1, 1) mesh at
    bucket 8, 512x512, against ``mesh=None``: pixels bit-identical, the
    decode kernels launched, both steps' device ms."""
    from repro_torch.kernels import ops
    from repro_torch.vae.model import SD35_VAE, with_phase_taps
    from repro_torch.vae.serve import make_decode_step
    vae, _ = shared_vae(torch, state)
    gen = torch.Generator(device="cuda").manual_seed(61)
    z = torch.randn((DIST_DECODE_BUCKET, LATENT_HW, LATENT_HW,
                     SD35_VAE.latent_channels), generator=gen,
                    device="cuda")
    plain = make_decode_step(SD35_VAE)
    on_mesh = make_decode_step(SD35_VAE, mesh)
    params = with_phase_taps(vae.decoder)       # the taps collapsed once
    ops.reset_launch_counts()
    got = on_mesh(params, z)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    state["launches"]["dist_decode"] = launches
    want = plain(params, z)
    need(torch.equal(got.full_tensor(), want),
         "the mesh decode's pixels differ from the unsharded decode's")
    need(all(p.is_shard(0) for p in got.placements),
         f"decode placements {got.placements}")
    need(all(launches[k] > 0 for k in ("conv3x3", "gn_silu_conv3x3",
                                       "upsample_conv3x3",
                                       "flash_attention")),
         f"mesh decode launched {launches}")
    return {"bucket": DIST_DECODE_BUCKET,
            "latent": list(z.shape), "pixels": list(got.shape),
            "placements": [str(p) for p in got.placements],
            "launches": launches,
            "mesh_ms": cuda_ms(torch, lambda: on_mesh(params, z), 3),
            "plain_ms": cuda_ms(torch, lambda: plain(params, z), 3)}


#: (e): the partial form at Qwen2-7B's decode shape, its slots split
DIST_PARTIAL = dict(n=LM_BATCH, hq=28, hkv=4, s=LM_MAX_LEN, d=128,
                    lengths=DECODE_LENGTHS, parts=16)
#: (f): decode steps over the (1, 1) mesh after a prefill of this many
#: tokens a sequence
DIST_DECODE = dict(batch=LM_BATCH, prompt=512, steps=8)
DEPTH_CUT["dist_decode"] = (
    4, "the plain and the mesh run share one set of weights (the mesh's a "
       "DTensor copy): 4 of Qwen2-7B's 28 layers with the embedding and "
       "the untied head are 2.0 B parameters, 4 GB of bf16 a copy; the "
       "step's layers are alike, so depth adds nothing to what the bit "
       "check sees; rwkv6-7b is cut the same way")


def dist_partial_check(torch, state):
    """(e): ``decode_attention_partial`` at Qwen2-7B's decode shape, fp32
    and bf16: o and lse against the plain version (o within 1e-5 (fp32)
    or 1e-4 (bf16 inputs) of its max, lse within 1e-5 of max(1, |lse|));
    the slots split into 16 ranges, each through the partial kernel,
    merged by ``ops.merge_partials``, against one ``decode_attention``
    call (fp32 within 1e-5 of the output's max, bf16 within one ulp of
    each output); device ms of the partial and the default form at the
    whole shape, the plain partial's, the 16 ranges' and the merge's
    (``torch.profiler``; CUDA events where three profiler windows see no
    device work, as ``timers`` says);
    the bound of the partial form's work (its o and lse written in
    fp32)."""
    from repro_torch.kernels import ops, ref
    sh = DIST_PARTIAL
    n, hq, hkv, s, d, parts = (sh[k] for k in ("n", "hq", "hkv", "s", "d",
                                               "parts"))
    byte_peak = state["peaks"][1]
    gen = torch.Generator(device="cuda").manual_seed(67)
    lens = torch.tensor(sh["lengths"], device="cuda", dtype=torch.int32)
    s_l = s // parts
    out = {}

    def dev_ms(timers, name, fn):
        # a profiler window can come back empty (0 device ms: fp32's first
        # window in two whole runs, its retry in one): three windows, then
        # CUDA events around single calls (launch gaps included)
        for _ in range(3):
            ms = device_ms(torch, fn, REPS)
            if ms:
                timers[name] = "torch.profiler"
                return ms
        timers[name] = "CUDA events (the profiler saw no device work)"
        return cuda_ms(torch, fn, REPS)

    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(shp, generator=gen, device="cuda").to(dtype)
                   for shp in ((n, hq, d), (n, hkv, s, d), (n, hkv, s, d)))
        o, lse = ops.decode_attention_partial(q, k, v, lens)
        po, plse = ref.decode_attention_partial_ref(q, k, v, lens)
        torch.cuda.synchronize()
        o_err = float((o - po).abs().max())
        o_tol = (1e-5 if dtype == torch.float32 else 1e-4) * float(
            po.abs().max())
        lse_err = float((lse - plse).abs().max())
        lse_tol = 1e-5 * max(1.0, float(plse.abs().max()))
        need(o.dtype == lse.dtype == torch.float32 and o_err <= o_tol and
             lse_err <= lse_tol, f"decode_attention_partial[{dt}]: o error "
             f"{o_err} (tol {o_tol}), lse error {lse_err} (tol {lse_tol})")
        ks = [k[:, :, r * s_l:(r + 1) * s_l].contiguous()
              for r in range(parts)]
        vs = [v[:, :, r * s_l:(r + 1) * s_l].contiguous()
              for r in range(parts)]
        ls = [torch.clamp(lens - r * s_l, 0, s_l) for r in range(parts)]

        def ranges():
            return [ops.decode_attention_partial(q, ks[r], vs[r], ls[r])
                    for r in range(parts)]

        pieces = ranges()
        po_all = torch.stack([p[0] for p in pieces])
        pl_all = torch.stack([p[1] for p in pieces])
        merged = ops.merge_partials(po_all, pl_all, dtype)
        whole = ops.decode_attention(q, k, v, lens)
        torch.cuda.synchronize()
        w = whole.float()
        if dtype == torch.float32:
            m_tol = 1e-5 * float(w.abs().max())
            m_ok = float((merged - whole).abs().max()) <= m_tol
            m_why = "1e-5 of the output's max"
        else:
            ulp = torch.exp2(torch.floor(torch.log2(
                w.abs().clamp(min=2.0 ** -126))) - 7)
            m_ok = bool(torch.all((merged.float() - w).abs() <= ulp))
            m_why = "one bf16 ulp of each output"
        m_err = float((merged.float() - w).abs().max())
        need(m_ok, f"{parts} merged ranges [{dt}] differ from one "
             f"decode_attention call by {m_err} ({m_why})")
        rows = sum(sh["lengths"])
        flops = 4.0 * d * hq * rows
        nbytes = (q.element_size() * (n * hq * d + 2 * hkv * rows * d)
                  + 4 * n + 4 * n * hq * (d + 1))
        row = {"flops": flops, "bytes": nbytes,
               "ops_ms": ops_ms(state, "decode_attention", flops, dt)}
        with_bound(row, byte_peak)
        timers = {}
        out[dt] = dict(
            o_max_abs_err=o_err, o_tol=o_tol, lse_max_abs_err=lse_err,
            lse_tol=lse_tol, merged_max_abs_err=m_err, merged_tol=m_why,
            rounded_equals_default=bool(torch.equal(o.to(dtype), whole)),
            ms=dev_ms(timers, "ms", lambda: ops.decode_attention_partial(
                q, k, v, lens)),
            default_ms=dev_ms(timers, "default_ms",
                              lambda: ops.decode_attention(q, k, v, lens)),
            plain_ms=dev_ms(timers, "plain_ms",
                            lambda: ref.decode_attention_partial_ref(
                                q, k, v, lens)),
            ranges_ms=dev_ms(timers, "ranges_ms", ranges),
            merge_ms=dev_ms(timers, "merge_ms", lambda: ops.merge_partials(
                po_all, pl_all, dtype)),
            timers=timers, **row)
        del q, k, v, ks, vs, pieces
        torch.cuda.empty_cache()
    return {"shape": {k: v for k, v in sh.items()}, "parts": parts,
            "timing": "device ms per call, by the timer each dtype's "
                      "\"timers\" names", **out}


def dist_mesh_lm_decode(torch, state, mesh):
    """(f): Qwen2-7B and rwkv6-7b at full width (``DEPTH_CUT``), bf16: a
    prefill of 4 x 512 seeded tokens and 8 greedy ``decode_step`` calls,
    plain, then on a DTensor copy of the same weights over the (1, 1)
    mesh fed the plain run's tokens: every step's logits and the final
    cache bit-identical; the mesh steps' launches (counted from 0 just
    before the first step: one ``decode_attention`` or ``rwkv6_scan`` a
    layer a step); each step's device ms (CUDA events) both ways."""
    import dataclasses
    from repro_torch.configs import build_model, get_config
    from repro_torch.dist import sharding as D
    from repro_torch.kernels import ops
    out = {}
    for arch in (LM_ARCH, SSM_ARCH):
        cfg = dataclasses.replace(get_config(arch),
                                  n_layers=DEPTH_CUT["dist_decode"][0])
        model = build_model(cfg, device="cuda", seed=0)
        gen = torch.Generator(device="cuda").manual_seed(71)
        tokens = torch.randint(0, cfg.vocab_size, (DIST_DECODE["batch"],
                                                   DIST_DECODE["prompt"]),
                               generator=gen, device="cuda")
        max_len = DIST_DECODE["prompt"] + DIST_DECODE["steps"]
        plain_params = model.params
        sharded = D.distribute_tree(plain_params, model.param_pspecs(1),
                                    mesh)
        runs, fed = {}, None
        try:
            for name in ("plain", "mesh"):
                if name == "mesh":
                    model.params = sharded
                    D.set_constraint_mesh(mesh)
                lg, cache = model.prefill(tokens, max_len)
                steps, step_ms, toks = [], [], []
                ops.reset_launch_counts()
                for i in range(DIST_DECODE["steps"]):
                    full = lg.full_tensor() if name == "mesh" else lg
                    tok = fed[i] if fed else full.argmax(-1)
                    toks.append(tok)
                    start = torch.cuda.Event(enable_timing=True)
                    stop = torch.cuda.Event(enable_timing=True)
                    start.record()
                    lg, cache = model.decode_step(cache, tok)
                    stop.record()
                    stop.synchronize()
                    step_ms.append(start.elapsed_time(stop))
                    steps.append(lg.full_tensor() if name == "mesh" else lg)
                launches = ops.launch_counts()
                leaves = {k: (v.full_tensor() if name == "mesh" else v)
                          for k, v in cache_leaves(cache).items()}
                runs[name] = (steps, leaves, launches, step_ms)
                fed = toks
                if name == "mesh":
                    state["launches"][f"dist_decode_{arch}"] = launches
        finally:
            model.params = plain_params
            D.set_constraint_mesh(None)
        (ps, pc, pn, pms), (ms_, mc, mn, mms) = runs["plain"], runs["mesh"]
        differ = [i for i, (a, b) in enumerate(zip(ps, ms_))
                  if not torch.equal(a, b)]
        need(not differ, f"{arch}: mesh decode logits differ from the plain "
             f"step's at steps {differ}")
        differ = [k for k in pc if not torch.equal(pc[k], mc[k])]
        need(not differ, f"{arch}: the mesh decode's cache differs at "
             f"{differ}")
        kernel = "rwkv6_scan" if cfg.ssm_type == "rwkv6" else \
            "decode_attention"
        want = cfg.n_layers * DIST_DECODE["steps"]
        need(mn == pn and mn[kernel] == want and
             sum(mn.values()) == want, f"{arch}: mesh decode launched {mn}, "
             f"the plain steps {pn}, expected {want} {kernel}")
        out[arch] = {**model_shape(cfg), "dtype": "bfloat16",
                     "reduced": dict(layers=[cfg.n_layers,
                                             get_config(arch).n_layers],
                                     why=DEPTH_CUT["dist_decode"][1]),
                     **DIST_DECODE, "launches": mn, "bit_identical": True,
                     "plain_step_ms": pms, "mesh_step_ms": mms,
                     "timing": "CUDA events around each step"}
        del model, sharded, plain_params, runs
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_dist(torch, log, state):
    """Sharded layouts and RWKV-6 training on the card: (c) the decode
    step on the (1, 1) mesh (first, while the shared VAE is loaded), (a)
    ``rwkv6_scan`` under autograd at the training shape and rwkv6-7b
    training, (b) the 1x1-mesh ZeRO-1 train step of Qwen2-7B against
    the unsharded step and (d) its prefill on the mesh against the
    plain prefill, (e) the partial decode attention and the merge of 16
    slot ranges, (f) LM decode steps over the (1, 1) mesh against the
    plain steps; the world-size-1 process group is destroyed at the
    end."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    try:
        decode = dist_decode_step(torch, state, make_local_mesh())
        state.pop("vae", None)
        gc.collect()
        torch.cuda.empty_cache()
        rwkv_train = dist_rwkv6_train(torch, state)
        rwkv_scan = dist_rwkv6_scan_check(torch, state)
        mesh_step, mesh = dist_mesh_step(torch, state)
        partial = dist_partial_check(torch, state)
        lm_decode = dist_mesh_lm_decode(torch, state, mesh)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    emit(log, "dist", rwkv6_train=rwkv_train, rwkv6_scan=rwkv_scan,
         mesh_step=mesh_step, decode=decode, partial=partial,
         lm_decode=lm_decode)



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
        run_phase(log, "autotune", phase_autotune, torch, log, state)
        run_phase(log, "launch", phase_launch, torch, log, state)
        run_phase(log, "crossdevice", phase_crossdevice, torch, log, state)
        for phase in SERVE:
            run_phase(log, phase, phase_serve, torch, log, state, phase)
        run_phase(log, "dist", phase_dist, torch, log, state)
        run_phase(log, "train", phase_train, torch, log, state)
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
             "design": DESIGN[k], **state["cold"].get(k, {}),
             **{f: totals[k][f] for f in (
                 "fwd_bwd_ms", "library_fwd_bwd_ms", "fp32_ms",
                 "fp32_plain_ms", "library_what") if f in totals[k]}}
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
