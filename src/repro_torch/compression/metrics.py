"""Image fidelity metrics (paper §6.6): PSNR and SSIM, pure numpy."""

from __future__ import annotations

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size) - size // 2
    g = np.exp(-(ax ** 2) / (2 * sigma ** 2))
    k = np.outer(g, g)
    return k / k.sum()


def _filter2(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Valid-mode 2D correlation via FFT (fast for 1024^2 images)."""
    from numpy.fft import irfft2, rfft2
    ih, iw = img.shape
    kh, kw = k.shape
    fh, fw = ih + kh - 1, iw + kw - 1
    F = rfft2(img, s=(fh, fw)) * rfft2(k, s=(fh, fw))
    full = irfft2(F, s=(fh, fw))
    return full[kh - 1:ih, kw - 1:iw]


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 255.0,
         k1: float = 0.01, k2: float = 0.03) -> float:
    """Mean SSIM (Wang et al.), 11x11 gaussian window, per-channel mean."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a = a[..., None]
        b = b[..., None]
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    k = _gaussian_kernel()
    vals = []
    for c in range(a.shape[-1]):
        x, y = a[..., c], b[..., c]
        mx = _filter2(x, k)
        my = _filter2(y, k)
        mxx = _filter2(x * x, k)
        myy = _filter2(y * y, k)
        mxy = _filter2(x * y, k)
        vx = mxx - mx * mx
        vy = myy - my * my
        cxy = mxy - mx * my
        s = ((2 * mx * my + c1) * (2 * cxy + c2)) / (
            (mx * mx + my * my + c1) * (vx + vy + c2))
        vals.append(s.mean())
    return float(np.mean(vals))
