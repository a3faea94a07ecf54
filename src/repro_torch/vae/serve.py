"""The VAE decode step and the analytic decode cost model (counterpart
of the JAX package's ``vae/serve.py``).

``make_decode_step`` returns the batched float decode (latents -> images)
on one device, or with the batch split over every axis of a device mesh
(the reference's data parallelism); the serving engine (:mod:`repro_torch.serve.engine`)
microbatches requests into ``VAE.decode_u8`` instead.  ``vae_cell_cost``
gives the analytic FLOPs and bytes the roofline reads
(:mod:`repro_torch.launch.roofline`), and ``decode_ms_estimate`` a
roofline decode time on one H100.

The arithmetic and its defaults are the reference's, kept as they are so
the two packages' counts agree, with two known departures from what the
port runs (ROADMAP C):

* the mid-block attention is counted as ``8 * N^2 * C`` FLOPs over
  ``N = h * w`` tokens; QK^T and P V take ``4 * N^2 * C``;
* the byte model's default ``dtype_size=2`` assumes bf16 activations and
  weights, and ``decode_ms_estimate`` uses it; the port's decode runs in
  fp32 (pass ``dtype_size=4`` for its traffic).

Only ``decode_ms_estimate``'s hardware defaults change: its peak is
``PEAK_FLOPS_TF32 / 3``, the rate of the fp32 decode the engine serves by
default (each fp32 product three TF32 ones on the tensor cores), and its
memory rate ``HBM_BW`` (:mod:`repro_torch.launch.mesh`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_TF32
from repro_torch.vae.model import SD35_VAE, VAEConfig, decode, with_phase_taps


def make_decode_step(cfg: VAEConfig, mesh=None, device=None):
    """``(params, z) -> decode(params, z, cfg)`` under
    ``torch.inference_mode`` on ``device`` (``"cuda"`` unless the caller
    asks for the CPU; raises where CUDA is absent).  ``params`` is a
    decoder tree on that device: its serving form
    (``model.with_phase_taps``), whose upsampler taps were collapsed once,
    or ``VAE.decoder``, whose taps the step collapses on every call.
    ``z`` (numpy or a tensor, ``[N, h, w, C_lat]``) is moved there as
    float32.  Returns float pixels ``[N, 8h, 8w, 3]`` on the device
    (asynchronous on CUDA).

    With a ``mesh`` (a ``DeviceMesh`` on ``device``'s type) the latent
    batch shards over every mesh axis (``Shard(0)`` on each mesh dim, N
    divisible by the mesh's size), the decoder weights stay replicated
    (each rank's plain tree), each rank decodes its own rows through the
    kernels, and the pixels come back as a DTensor with the batch's
    placements.  ``z`` is the global batch, on every rank alike."""
    dev = resolve_device(device)
    if mesh is not None and mesh.device_type != dev.type:
        raise ValueError(f"mesh on {mesh.device_type!r}, decode on "
                         f"{dev.type!r}")

    def step(params, z):
        with torch.inference_mode():
            params = with_phase_taps(params)
            z = torch.as_tensor(z, dtype=torch.float32, device=dev)
            if mesh is None:
                return decode(params, z, cfg)
            from torch.distributed.tensor import distribute_tensor
            from repro_torch.dist import sharding as D
            pl = D.placements(D.P(D.axis_names(mesh)), mesh, z.shape)
            zl = distribute_tensor(z, mesh, pl, src_data_rank=None)
            out = decode(params, zl.to_local(), cfg)
            return D.from_local(out, mesh, pl,
                                (z.shape[0],) + tuple(out.shape[1:]))
    return step


# ---------------------------------------------------------------------------
# analytic decode cost (conv-dominated; per image at resolution R)
# ---------------------------------------------------------------------------

def decoder_flops_per_image(cfg: VAEConfig = SD35_VAE,
                            resolution: int = 1024,
                            fused_upsampler: bool = True) -> float:
    """Sum conv/attention FLOPs through the decoder stages.

    The phase-decomposed upsampler kernel computes 4 phases x 4 collapsed
    2x2 taps on the *pre-upsample* grid — 16 tap-matmul units vs 36 for a
    3x3 conv over the 4x upsampled tensor (2.25x fewer MACs), which
    ``fused_upsampler=True`` (the shipped decode path) accounts for.
    The mid-block attention term is the reference's ``8 * N^2 * C``,
    twice the ``4 * N^2 * C`` of QK^T and P V (ROADMAP C)."""
    lat = resolution // cfg.spatial_factor
    chs = list(reversed(cfg.block_out_channels))     # top -> bottom
    top = chs[0]
    flops = 0.0
    h = lat

    def conv(cin, cout, hh, k=3):
        return 2.0 * hh * hh * cin * cout * k * k

    def resblock(cin, cout, hh):
        f = conv(cin, cout, hh) + conv(cout, cout, hh)
        if cin != cout:
            f += conv(cin, cout, hh, k=1)
        return f

    flops += conv(cfg.latent_channels, top, h)               # conv_in
    flops += 2 * resblock(top, top, h)                       # mid res
    flops += 4 * (2.0 * (h * h) * (h * h) * top) \
        + 4 * 2.0 * h * h * top * top                        # mid attn
    cin = top
    for i, cout in enumerate(chs):
        for _ in range(cfg.layers_per_block + 1):
            flops += resblock(cin, cout, h)
            cin = cout
        if i < len(chs) - 1:
            if fused_upsampler:
                # 16 collapsed 2x2 taps at the pre-upsample resolution
                flops += 2.0 * h * h * cout * cout * 16
                h *= 2
            else:
                h *= 2
                flops += conv(cout, cout, h)                 # upsampler
    flops += conv(chs[-1], cfg.image_channels, h)            # conv_out
    return flops


def decoder_bytes_per_image(cfg: VAEConfig = SD35_VAE,
                            resolution: int = 1024,
                            dtype_size: int = 2,
                            fused_upsampler: bool = True,
                            uint8_output: bool = True) -> float:
    """Activation + weight traffic (fused GN+SiLU+conv, flash attention).

    ``fused_upsampler=True`` models the phase-decomposed upsample+conv
    kernel, which reads the pre-upsample activation and writes the conv
    output directly — the 4x nearest-upsampled intermediate never makes
    an HBM round-trip (the old accounting charged a write + read of that
    4x tensor per upsampler, over-predicting decode bytes).
    ``uint8_output=True`` models the fused output epilogue: the final
    image leaves as 1-byte pixels instead of ``dtype_size`` floats.
    ``dtype_size=2`` is bf16; the port's fp32 decode moves ``4``.
    """
    lat = resolution // cfg.spatial_factor
    chs = list(reversed(cfg.block_out_channels))
    params = 49.55e6
    traffic = params * dtype_size
    h = lat
    cin = chs[0]
    # each res block: ~4 r/w of the [h, h, c] activation
    traffic += 3 * 4 * h * h * cin * dtype_size              # mid
    for i, cout in enumerate(chs):
        traffic += (cfg.layers_per_block + 1) * 4 * h * h * cout * dtype_size
        if i < len(chs) - 1:
            if fused_upsampler:
                # read pre-upsample [h, h, c] + write conv out [2h, 2h, c]
                traffic += 5 * h * h * cout * dtype_size
                h *= 2
            else:
                # unfused: the 4x intermediate is written by the repeat
                # and re-read by the conv
                h *= 2
                traffic += 2 * h * h * cout * dtype_size
    traffic += h * h * 3 * (1 if uint8_output else dtype_size)  # output image
    return traffic


@dataclasses.dataclass
class VaeCellCost:
    flops: float
    hbm_bytes: float
    hbm_bytes_flash: float
    model_flops: float
    params: int
    active_params: int


def vae_cell_cost(shape: ShapeSpec) -> VaeCellCost:
    res = shape.seq_len
    b = shape.global_batch
    f = decoder_flops_per_image(SD35_VAE, res) * b
    by = decoder_bytes_per_image(SD35_VAE, res) * b
    return VaeCellCost(flops=f, hbm_bytes=by, hbm_bytes_flash=by,
                       model_flops=f, params=49_550_000,
                       active_params=49_550_000)


def decode_ms_estimate(resolution: int = 1024,
                       peak_flops: float = PEAK_FLOPS_TF32 / 3,
                       hbm_bw: float = HBM_BW,
                       mfu: float = 0.55,
                       fused_upsampler: bool = True,
                       uint8_output: bool = True) -> Dict[str, float]:
    """Roofline T_decode estimate for one image on one H100: FLOPs at
    ``mfu`` of ``peak_flops`` (default the 3xTF32 rate of the fp32
    decode), bytes (bf16, see the module docstring) at ``hbm_bw``, the
    larger of the two.  Defaults model the fused regeneration fast path
    (phase-decomposed upsampler, uint8 epilogue); pass
    ``fused_upsampler=False, uint8_output=False`` for the pre-fusion
    traffic model."""
    fl = decoder_flops_per_image(SD35_VAE, resolution,
                                 fused_upsampler=fused_upsampler)
    by = decoder_bytes_per_image(SD35_VAE, resolution,
                                 fused_upsampler=fused_upsampler,
                                 uint8_output=uint8_output)
    t_comp = fl / (peak_flops * mfu)
    t_mem = by / hbm_bw
    return {"flops": fl, "bytes": by, "compute_ms": t_comp * 1e3,
            "memory_ms": t_mem * 1e3,
            "decode_ms": max(t_comp, t_mem) * 1e3}
