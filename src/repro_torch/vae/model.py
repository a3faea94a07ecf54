"""Config-driven VAE (SD/FLUX family) in PyTorch: the reconstruction
engine of the latent-first store (counterpart of the JAX package's
``vae/model.py``).

The decoder has the SD 3.5 / FLUX.1 shape: 16 latent channels at 1/8
spatial resolution, block_out_channels (128, 256, 512, 512), 3 res
blocks per decoder level and one single-head attention mid-block, ~49.5 M
parameters.  The encoder mirrors it with 2 res blocks per level and
strided downsamplers, and returns the latent (mean, logvar) moments.
Three forward passes: ``decode_u8`` (the uint8 read path, with the fused
output epilogue), ``decode`` (float pixels in [-1, 1]) and ``encode``
(the write and regeneration path).  ``decode_u8`` may serve decoder
weights stored in bf16 or int8 (``VAE(weight_dtype=)``, see
:mod:`repro_torch.vae.quantize`); the fp32 tree stays as the oracle.
:func:`decode`, :func:`decode_u8` and :class:`VAE` decode serving trees
(:func:`with_phase_taps`), whose upsamplers hold their taps collapsed
once, so no decode collapses them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.vae import layers as L


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    name: str = "sd35_vae"
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2            # decoder uses layers_per_block + 1
    groups: int = 32
    scaling_factor: float = 1.5305       # SD3 latent scaling
    shift_factor: float = 0.0609
    image_channels: int = 3
    dtype: Any = torch.float32

    @property
    def spatial_factor(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)

    def latent_shape(self, image_hw: int) -> Tuple[int, int, int]:
        s = image_hw // self.spatial_factor
        return (s, s, self.latent_channels)


SD35_VAE = VAEConfig(name="sd35_vae", latent_channels=16)
FLUX_VAE = VAEConfig(name="flux_vae", latent_channels=16,
                     scaling_factor=0.3611, shift_factor=0.1159)
SD15_VAE = VAEConfig(name="sd15_vae", latent_channels=4,
                     scaling_factor=0.18215, shift_factor=0.0)
#: The facade/bench demo stack: tiny but architecturally complete.
DEMO_VAE = VAEConfig(name="demo", latent_channels=4,
                     block_out_channels=(16, 32), layers_per_block=1,
                     groups=4)


# ---------------------------------------------------------------------------
# parameter construction
# ---------------------------------------------------------------------------

def init_decoder(gen: torch.Generator, cfg: VAEConfig) -> Dict[str, Any]:
    """Random decoder parameters (on the CPU, from ``gen``), with the JAX
    package's tree structure and ``normal / sqrt(fan_in)`` scale."""
    dtype = cfg.dtype
    chs = cfg.block_out_channels
    top = chs[-1]
    params: Dict[str, Any] = {
        "conv_in": L.conv_init(gen, 3, 3, cfg.latent_channels, top, dtype),
        "mid": {
            "res1": L.resnet_block_init(gen, top, top, dtype),
            "attn": L.attn_block_init(gen, top, dtype),
            "res2": L.resnet_block_init(gen, top, top, dtype),
        },
        "up": [],
        "norm_out": L.gn_init(chs[0], dtype),
        "conv_out": L.conv_init(gen, 3, 3, chs[0], cfg.image_channels, dtype),
    }
    cin = top
    for i, cout in enumerate(reversed(chs)):        # top -> bottom
        blocks = []
        for _ in range(cfg.layers_per_block + 1):
            blocks.append(L.resnet_block_init(gen, cin, cout, dtype))
            cin = cout
        level: Dict[str, Any] = {"blocks": blocks}
        if i < len(chs) - 1:
            level["upsample"] = L.upsample_init(gen, cout, dtype)
        params["up"].append(level)
    return params


def init_encoder(gen: torch.Generator, cfg: VAEConfig) -> Dict[str, Any]:
    """Random encoder parameters (on the CPU, from ``gen``), with the JAX
    package's tree structure and ``normal / sqrt(fan_in)`` scale."""
    dtype = cfg.dtype
    chs = cfg.block_out_channels
    params: Dict[str, Any] = {
        "conv_in": L.conv_init(gen, 3, 3, cfg.image_channels, chs[0], dtype),
        "down": [],
    }
    cin = chs[0]
    for i, cout in enumerate(chs):
        blocks = []
        for _ in range(cfg.layers_per_block):
            blocks.append(L.resnet_block_init(gen, cin, cout, dtype))
            cin = cout
        level: Dict[str, Any] = {"blocks": blocks}
        if i < len(chs) - 1:
            level["downsample"] = L.downsample_init(gen, cout, dtype)
        params["down"].append(level)
    top = chs[-1]
    params["mid"] = {
        "res1": L.resnet_block_init(gen, top, top, dtype),
        "attn": L.attn_block_init(gen, top, dtype),
        "res2": L.resnet_block_init(gen, top, top, dtype),
    }
    params["norm_out"] = L.gn_init(top, dtype)
    params["conv_out"] = L.conv_init(gen, 3, 3, top,
                                     2 * cfg.latent_channels, dtype)
    return params


def map_params(tree, fn):
    """Apply ``fn`` to every leaf of a nested dict/list parameter tree."""
    if isinstance(tree, dict):
        return {k: map_params(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_params(v, fn) for v in tree]
    return fn(tree)


def with_phase_taps(params: Dict[str, Any]) -> Dict[str, Any]:
    """The serving form of a decoder tree: a copy with new dicts along the
    path to each upsampler and every other node shared, whose upsamplers'
    convs hold ``taps`` in place of their 3x3 filter ``w``: the filter
    collapsed per phase once (``ref.storage_phase_weights`` of the stored
    filter, with its rounding: fp32 and bf16 taps in their dtype, int8
    codes in int16 with the filter's scale).  ``layers.upsample`` launches
    from them, so a decode collapses nothing per call and gives the bits
    of the per-call collapse.  A tree already in serving form keeps its
    taps."""
    from repro_torch.kernels import ref
    levels = []
    for level in params["up"]:
        conv = level.get("upsample", {}).get("conv", {})
        if "w" in conv:
            w = conv["w"]
            if isinstance(w, ops.QuantizedWeight):
                taps = ops.QuantizedWeight(
                    ref.storage_phase_weights(w.q).contiguous(), w.scale)
            else:
                taps = ref.storage_phase_weights(w).contiguous()
            conv = {k: v for k, v in conv.items() if k != "w"}
            level = {**level, "upsample": {**level["upsample"],
                                           "conv": {**conv, "taps": taps}}}
        levels.append(level)
    return {**params, "up": levels}


def param_count(params) -> int:
    leaves = []
    map_params(params, leaves.append)
    return sum(int(p.numel()) for p in leaves)


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _decode_trunk(params: Dict[str, Any], z: torch.Tensor,
                  cfg: VAEConfig) -> torch.Tensor:
    """Shared decode trunk: latent -> pre-epilogue activation [N, 8h, 8w,
    C0] (everything up to, excluding, norm_out + conv_out).  ``params`` is
    a decoder tree in serving form (:func:`with_phase_taps`), as for
    :func:`decode_u8` and :func:`decode`."""
    z = z / cfg.scaling_factor + cfg.shift_factor
    x = L.conv2d(z, params["conv_in"])
    x = L.resnet_block(x, params["mid"]["res1"], cfg.groups)
    x = L.attn_block(x, params["mid"]["attn"], cfg.groups)
    x = L.resnet_block(x, params["mid"]["res2"], cfg.groups)
    for level in params["up"]:
        for blk in level["blocks"]:
            x = L.resnet_block(x, blk, cfg.groups)
        if "upsample" in level:
            x = L.upsample(x, level["upsample"])
    return x


def decode_u8(params: Dict[str, Any], z: torch.Tensor,
              cfg: VAEConfig) -> torch.Tensor:
    """The uint8 read path: latent [N, h, w, C_lat] -> displayable uint8
    image [N, 8h, 8w, 3]; the final GN + SiLU + conv_out + clamp +
    quantize is one fused epilogue."""
    x = _decode_trunk(params, z, cfg)
    return ops.output_epilogue(
        x, params["norm_out"]["scale"], params["norm_out"]["bias"],
        params["conv_out"]["w"], params["conv_out"]["b"], groups=cfg.groups)


def decode(params: Dict[str, Any], z: torch.Tensor,
           cfg: VAEConfig) -> torch.Tensor:
    """latent [N, h, w, C_lat] -> image [N, 8h, 8w, 3] in [-1, 1]: the
    trunk, the standalone GroupNorm + SiLU, then ``conv_out``."""
    x = _decode_trunk(params, z, cfg)
    x = L.gn_silu(x, params["norm_out"], groups=cfg.groups)
    return L.conv2d(x, params["conv_out"])


def encode(params: Dict[str, Any], x: torch.Tensor, cfg: VAEConfig
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """image [N, H, W, 3] -> (mean, logvar) latents [N, H/8, W/8, C_lat];
    the mean is shifted and scaled into the latent space the decoder
    reads."""
    h = L.conv2d(x, params["conv_in"])
    for level in params["down"]:
        for blk in level["blocks"]:
            h = L.resnet_block(h, blk, cfg.groups)
        if "downsample" in level:
            h = L.downsample(h, level["downsample"])
    h = L.resnet_block(h, params["mid"]["res1"], cfg.groups)
    h = L.attn_block(h, params["mid"]["attn"], cfg.groups)
    h = L.resnet_block(h, params["mid"]["res2"], cfg.groups)
    h = L.gn_silu(h, params["norm_out"], groups=cfg.groups)
    moments = L.conv2d(h, params["conv_out"])
    mean, logvar = torch.chunk(moments, 2, dim=-1)
    mean = (mean - cfg.shift_factor) * cfg.scaling_factor
    return mean, logvar


#: offset of the encoder's generator seed from the decoder's, so the two
#: trees draw from separate streams
ENCODER_SEED_OFFSET = 1 << 32


class VAE:
    """Config + decoder (and encoder) parameters on one device.

    ``params`` and ``encoder_params`` (nested dict/list trees of tensors,
    e.g. from :func:`repro_torch.vae.bridge.params_from_numpy`) replace
    the seeded random initialisation of the decoder and the encoder;
    ``with_encoder=False`` builds no encoder.  ``device`` defaults to
    ``"cuda"`` and raises where CUDA is absent; pass ``device="cpu"`` for
    the plain path.

    ``weight_dtype`` ('float32' | 'bfloat16' | 'int8') is the storage
    precision of the decoder weights that ``decode_u8`` serves from (see
    :mod:`repro_torch.vae.quantize`).  The fp32 tree is always kept as
    the oracle: :meth:`decode` and ``decode_u8(z, precision="float32")``
    run it, which is what the engine's +-1-LSB open-time gate compares
    against.
    """

    def __init__(self, cfg: VAEConfig = SD35_VAE, seed: int = 0,
                 device=None, params: Optional[Dict[str, Any]] = None,
                 with_encoder: bool = True,
                 encoder_params: Optional[Dict[str, Any]] = None,
                 weight_dtype: str = "float32"):
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device="cpu").manual_seed(int(seed))
            params = init_decoder(gen, cfg)
        self.decoder = map_params(params, self._leaf)
        if encoder_params is None and with_encoder:
            gen = torch.Generator(device="cpu").manual_seed(
                int(seed) + ENCODER_SEED_OFFSET)
            encoder_params = init_encoder(gen, cfg)
        self.encoder = (map_params(encoder_params, self._leaf)
                        if encoder_params is not None else None)
        self.set_weight_dtype(weight_dtype)

    def set_weight_dtype(self, weight_dtype: str) -> None:
        """(Re-)derive the serving trees (:func:`with_phase_taps`) of the
        fp32 oracle and of ``weight_dtype`` from the current fp32
        decoder.  Unconditional: a caller that changed ``self.decoder``
        (calibration, tests) gets fresh quantized weights and taps."""
        self._qparams: Dict[str, Any] = {}
        self._params_for("float32")
        self._params_for(weight_dtype)
        self.weight_dtype = weight_dtype

    def _params_for(self, precision: Optional[str]) -> Dict[str, Any]:
        precision = precision or self.weight_dtype
        if precision not in self._qparams:
            from repro_torch.vae import quantize as Q   # late: no cycle
            self._qparams[precision] = with_phase_taps(
                Q.quantize_decoder(self.decoder, precision))
        return self._qparams[precision]

    def _leaf(self, p: torch.Tensor) -> torch.Tensor:
        return p.to(device=self.device, dtype=self.cfg.dtype).contiguous()

    def _input(self, z) -> torch.Tensor:
        return torch.as_tensor(z, dtype=torch.float32, device=self.device)

    def encode_mean(self, x) -> torch.Tensor:
        """images [N, H, W, 3] in [-1, 1] -> latent means [N, H/8, W/8,
        C_lat] on this device (asynchronous on CUDA: the caller
        synchronises, e.g. by copying to the host)."""
        if self.encoder is None:
            raise ValueError("this VAE was built with_encoder=False")
        with torch.no_grad():
            return encode(self.encoder, self._input(x), self.cfg)[0]

    def decode(self, z) -> torch.Tensor:
        """latents [N, h, w, C] -> float pixels [N, 8h, 8w, 3] on this
        device (asynchronous on CUDA)."""
        with torch.no_grad():
            return decode(self._params_for("float32"), self._input(z),
                          self.cfg)

    def decode_u8(self, z, precision: Optional[str] = None) -> torch.Tensor:
        """latents [N, h, w, C] -> uint8 [N, 8h, 8w, 3] on this device
        (asynchronous on CUDA: the caller synchronises), from the weights
        at ``precision`` (default: the configured ``weight_dtype``;
        'float32' forces the oracle weights, the gate's reference)."""
        with torch.no_grad():
            return decode_u8(self._params_for(precision), self._input(z),
                             self.cfg)

    def decode_trunk(self, z) -> torch.Tensor:
        with torch.no_grad():
            return _decode_trunk(self._params_for("float32"),
                                 self._input(z), self.cfg)

    @property
    def decoder_params(self) -> int:
        return param_count(self.decoder)


def probe_latents(latent_hwc: Tuple[int, int, int], bucket: int,
                  seed: int = 0) -> np.ndarray:
    """Deterministic unit-normal probe latents (copy of the JAX package's
    ``vae/quantize.py:probe_latents``)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((bucket,) + tuple(latent_hwc)
                               ).astype(np.float32)


def calibrate_output_range(vae: VAE, target_std: float = 0.35,
                           probe_hw: int = 8, seed: int = 0) -> float:
    """Rescale ``conv_out`` in place so probe decodes land inside the
    display range (std ``target_std`` on [-1, 1]); returns the gain.

    Random-init decoders emit images that saturate the uint8 clamp, which
    no trained decoder does.  Port of the JAX package's
    ``vae/quantize.py:calibrate_output_range``; like it, re-derives the
    quantized serving tree from the rescaled decoder."""
    cfg = vae.cfg
    z = probe_latents((probe_hw, probe_hw, cfg.latent_channels), 2, seed)
    y = vae.decode(z).cpu().numpy()
    gain = float(target_std / max(float(y.std()), 1e-6))
    co = vae.decoder["conv_out"]
    co["w"] = (co["w"] * gain).contiguous()
    co["b"] = (co["b"] * gain).contiguous()
    vae.set_weight_dtype(vae.weight_dtype)
    return gain


def demo_vae(seed: int = 0, device=None,
             weight_dtype: str = "float32") -> VAE:
    """The demo :class:`VAE` (decoder and encoder) with its output range
    calibrated into the display domain, serving ``weight_dtype``
    weights; deterministic per seed."""
    vae = VAE(DEMO_VAE, seed=seed, device=device)
    calibrate_output_range(vae)
    if weight_dtype != "float32":
        vae.set_weight_dtype(weight_dtype)
    return vae
