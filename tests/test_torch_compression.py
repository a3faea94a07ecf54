"""The port's fidelity metrics and image-size proxies against the JAX
package's on seeded images: ``psnr``, ``ssim``, ``jpeg_like`` (size and
reconstruction) and ``png_like_size`` / ``png_like_bytes`` give the same
numbers and bytes; ``repro_torch.compression`` exports what the
reference's package does."""

import numpy as np
import pytest

import repro.compression as jcomp
from repro.compression import lossy as jlossy
from repro.compression import metrics as jmetrics
from repro.compression import png_proxy as jpng
import repro_torch.compression as tcomp
from repro_torch.compression import lossy, metrics, png_proxy

#: (height, width): square, ragged (not multiples of 8), a 1-pixel edge
SHAPES = [(32, 32), (37, 21), (64, 48), (9, 1)]


def image(h, w, seed):
    """A smooth gradient plus seeded noise, uint8 HWC."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([yy * 3, xx * 2, (yy + xx)], -1).astype(np.float64)
    noisy = base + rng.normal(0, 12, (h, w, 3))
    return np.clip(noisy, 0, 255).astype(np.uint8)


def pair(h, w, seed):
    a = image(h, w, seed)
    rng = np.random.default_rng(seed + 100)
    b = np.clip(a.astype(np.int16) + rng.integers(-6, 7, a.shape), 0,
                255).astype(np.uint8)
    return a, b


@pytest.mark.parametrize("h,w", SHAPES)
def test_psnr_equals_the_reference(h, w):
    a, b = pair(h, w, h * w)
    assert metrics.psnr(a, b) == jmetrics.psnr(a, b)
    assert metrics.psnr(a, a) == jmetrics.psnr(a, a) == float("inf")
    assert metrics.psnr(a / 255.0, b / 255.0, data_range=1.0) == \
        jmetrics.psnr(a / 255.0, b / 255.0, data_range=1.0)


@pytest.mark.parametrize("h,w", [s for s in SHAPES if min(s) >= 11])
def test_ssim_equals_the_reference(h, w):
    a, b = pair(h, w, h + w)
    got = metrics.ssim(a, b)
    assert got == jmetrics.ssim(a, b)
    assert 0.0 < got < 1.0
    assert metrics.ssim(a[..., 0], b[..., 0]) == \
        jmetrics.ssim(a[..., 0], b[..., 0])


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("quality", [95, 50, 10])
def test_jpeg_like_equals_the_reference(h, w, quality):
    img = image(h, w, 7 * h + w)
    size, rec = lossy.jpeg_like(img, quality)
    want_size, want_rec = jlossy.jpeg_like(img, quality)
    assert size == want_size
    assert rec.dtype == np.uint8 and rec.shape == img.shape
    assert np.array_equal(rec, want_rec)


@pytest.mark.parametrize("h,w", SHAPES)
def test_png_like_equals_the_reference(h, w):
    img = image(h, w, 3 * h + w)
    assert png_proxy.png_like_bytes(img) == jpng.png_like_bytes(img)
    assert png_proxy.png_like_size(img) == jpng.png_like_size(img)
    assert png_proxy.png_like_size(img[..., 0], level=9) == \
        jpng.png_like_size(img[..., 0], level=9)
    with pytest.raises(TypeError):
        png_proxy.png_like_bytes(img.astype(np.float32))


def test_package_exports():
    assert tcomp.__all__ == jcomp.__all__ == [
        "compress_latent", "decompress_latent", "psnr", "ssim"]
    from repro_torch.compression import (compress_latent,
                                         decompress_latent, psnr, ssim)
    assert psnr is metrics.psnr and ssim is metrics.ssim
    z = np.random.default_rng(0).standard_normal((4, 4, 16)).astype(
        np.float16)
    blob = compress_latent(z)
    assert blob == jcomp.compress_latent(z)
    assert np.array_equal(decompress_latent(blob), z)
