"""VAE building blocks in PyTorch (NHWC activations, HWIO conv weights,
as in the JAX package's ``vae/layers.py``).  Every hot spot goes through
:mod:`repro_torch.kernels.ops`, whose device dispatch picks the Hopper
kernel for a CUDA tensor and the plain version for a CPU one.

The few operations outside any kernel (the 1x1 shortcut, the encoder's
strided downsample, the attention block's GroupNorm and dense
projections) are plain tensor code, as the JAX package leaves them to
XLA.  They run image by image, so each sees the same shapes whatever the
batch size: a bucket-8 decode then gives each image the same bits as a
batch-1 decode, since the kernels are batch-invariant too.  They are
fp32 matmuls, which PyTorch runs without TF32 unless a caller turns
``torch.backends.cuda.matmul.allow_tf32`` on.

Quantized decoder weights (:mod:`repro_torch.vae.quantize`) pass through
in their storage form: a 3x3 conv weight in bf16 or as a
``QuantizedWeight`` goes to its kernel as it is stored; the 1x1 shortcut
dequantizes (a small weight; the JAX package leaves it to XLA) and the
attention's bf16 dense weights are cast to the activations' fp32 for the
plain matmuls.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# initializers (same structure and normal/sqrt(fan_in) scale as the JAX
# package; the numbers differ, since the generators differ)
# ---------------------------------------------------------------------------

def conv_init(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int,
              dtype=torch.float32) -> Params:
    fan_in = kh * kw * cin
    w = torch.randn((kh, kw, cin, cout), generator=gen, dtype=dtype)
    return {"w": w / math.sqrt(fan_in), "b": torch.zeros((cout,), dtype=dtype)}


def gn_init(channels: int, dtype=torch.float32) -> Params:
    return {"scale": torch.ones((channels,), dtype=dtype),
            "bias": torch.zeros((channels,), dtype=dtype)}


def dense_init(gen: torch.Generator, cin: int, cout: int,
               dtype=torch.float32) -> Params:
    w = torch.randn((cin, cout), generator=gen, dtype=dtype)
    return {"w": w / math.sqrt(cin), "b": torch.zeros((cout,), dtype=dtype)}


def resnet_block_init(gen, cin: int, cout: int, dtype=torch.float32) -> Params:
    p = {
        "norm1": gn_init(cin, dtype),
        "conv1": conv_init(gen, 3, 3, cin, cout, dtype),
        "norm2": gn_init(cout, dtype),
        "conv2": conv_init(gen, 3, 3, cout, cout, dtype),
    }
    if cin != cout:
        p["shortcut"] = conv_init(gen, 1, 1, cin, cout, dtype)
    return p


def attn_block_init(gen, c: int, dtype=torch.float32) -> Params:
    return {
        "norm": gn_init(c, dtype),
        "q": dense_init(gen, c, c, dtype),
        "k": dense_init(gen, c, c, dtype),
        "v": dense_init(gen, c, c, dtype),
        "proj": dense_init(gen, c, c, dtype),
    }


def upsample_init(gen, c: int, dtype=torch.float32) -> Params:
    return {"conv": conv_init(gen, 3, 3, c, c, dtype)}


def downsample_init(gen, c: int, dtype=torch.float32) -> Params:
    return {"conv": conv_init(gen, 3, 3, c, c, dtype)}


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def per_image(fn, x: torch.Tensor) -> torch.Tensor:
    """Apply ``fn`` to each image of the batch on its own (batch-invariant
    plain tensor code: every call sees a batch of one)."""
    return torch.cat([fn(x[i:i + 1]) for i in range(x.shape[0])])


def conv2d(x: torch.Tensor, p: Params) -> torch.Tensor:
    """Unstrided SAME conv, NHWC x HWIO.  3x3 goes to the ``conv3x3``
    kernel; the 1x1 shortcut is a plain channel matmul, as the JAX package
    leaves it to XLA."""
    w = p["w"]
    if tuple(w.shape[:2]) == (3, 3):
        return ops.conv3x3(x, w, p["b"])
    if tuple(w.shape[:2]) != (1, 1):
        raise NotImplementedError(
            f"conv2d: the VAE's unstrided convs are 3x3 and 1x1, got "
            f"{tuple(w.shape[:2])}")
    if isinstance(w, ops.QuantizedWeight):
        w = w.dequant(x.dtype)
    w = w[0, 0].to(x.dtype)
    return per_image(lambda xi: torch.matmul(xi, w) + p["b"], x)


def group_norm(x: torch.Tensor, p: Params, groups: int = 32,
               eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over (H, W, C/g) with fp32 statistics (plain)."""
    n, h, w, c = x.shape
    xf = x.float().reshape(n, h * w, groups, c // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = xf.var(dim=(1, 3), keepdim=True, correction=0)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(n, h, w, c)
    return (xf * p["scale"].float() + p["bias"].float()).to(x.dtype)


def gn_silu(x: torch.Tensor, p: Params, groups: int = 32) -> torch.Tensor:
    """GroupNorm + SiLU, the standalone kernel (``norm_out``)."""
    return ops.group_norm_silu(x, p["scale"], p["bias"], groups=groups)


def resnet_block(x: torch.Tensor, p: Params, groups: int = 32) -> torch.Tensor:
    """GN+SiLU+conv3x3 twice (the fused kernel) plus the shortcut."""
    h = ops.gn_silu_conv3x3(x, p["norm1"]["scale"], p["norm1"]["bias"],
                            p["conv1"]["w"], p["conv1"]["b"], groups=groups)
    h = ops.gn_silu_conv3x3(h, p["norm2"]["scale"], p["norm2"]["bias"],
                            p["conv2"]["w"], p["conv2"]["b"], groups=groups)
    if "shortcut" in p:
        x = conv2d(x, p["shortcut"])
    return x + h


def attn_block(x: torch.Tensor, p: Params, groups: int = 32) -> torch.Tensor:
    """Single-head self-attention over the H*W token grid (mid-block)."""
    n, h, w, c = x.shape

    def dense(y, d):
        return torch.matmul(y, d["w"].to(y.dtype)) + d["b"].to(y.dtype)

    def qkv(xi):
        y = group_norm(xi, p["norm"], groups=groups).reshape(1, h * w, c)
        return torch.stack([dense(y, p["q"]), dense(y, p["k"]),
                            dense(y, p["v"])])

    q, k, v = per_image(lambda xi: qkv(xi).transpose(0, 1), x).unbind(1)
    # [n, hw, c] -> [n, 1 head, hw, c]
    o = ops.flash_attention(q[:, None].contiguous(), k[:, None].contiguous(),
                            v[:, None].contiguous(), causal=False)[:, 0]
    o = per_image(lambda oi: dense(oi, p["proj"]), o)
    return x + o.reshape(n, h, w, c)


def upsample(x: torch.Tensor, p: Params) -> torch.Tensor:
    """Nearest-neighbour 2x + 3x3 conv via the fused kernel, from the
    conv's taps, collapsed once when the serving tree was derived
    (``vae.model.with_phase_taps``)."""
    return ops.upsample_conv3x3_taps(x, p["conv"]["taps"], p["conv"]["b"])


def downsample(x: torch.Tensor, p: Params) -> torch.Tensor:
    """Strided 3x3 conv with SD's asymmetric (0, 1) padding: pad one row
    below and one column right, then a VALID stride-2 conv, written as
    nine strided channel matmuls (plain tensor code, image by image)."""
    w, b = p["conv"]["w"], p["conv"]["b"]

    def one(xi):
        _, h, wd, _ = xi.shape
        xp = F.pad(xi, (0, 0, 0, 1, 0, 1))
        ho, wo = (h - 2) // 2 + 1, (wd - 2) // 2 + 1
        acc = None
        for dy in range(3):
            for dx in range(3):
                tap = torch.matmul(xp[:, dy:dy + 2 * ho - 1:2,
                                      dx:dx + 2 * wo - 1:2, :], w[dy, dx])
                acc = tap if acc is None else acc + tap
        return acc + b

    return per_image(one, x)
