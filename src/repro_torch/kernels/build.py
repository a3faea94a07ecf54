"""Build and load the Hopper kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with :mod:`ctypes`.
Libraries are cached under ``build/repro_torch/`` at the repository root
(listed in ``.gitignore``), named by a hash of the source files and the
flags, so an unchanged source is compiled once per checkout.

Nothing is built at import time: :func:`lib` builds on first use, and
:func:`build_all` compiles every source at once, one ``nvcc`` process per
source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("gn_stats", "conv3x3", "gn_silu_conv", "upsample_conv",
           "flash_attention", "flash_attention_bwd", "gn_silu",
           "decode_attention", "rwkv6_scan", "rwkv6_scan_bwd",
           "output_epilogue")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
#: seconds each library took to build in this process (0.0: cached)
build_seconds: Dict[str, float] = {}

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
#: source -> (its launch function, the C argument types); every launch
#: function returns cudaGetLastError().  The four decode conv launches take
#: their tile knob (``layout``, ``tile_h``; 0 the shape's default) last
#: before the stream.
SIGNATURES = {
    "gn_stats": ("gn_stats_launch", [P, P, P, I, I, I, I, I, F, P]),
    "conv3x3": ("conv3x3_launch", [P, P, P, P, P, I, I, I, I, I, I, I, I,
                                    P]),
    "gn_silu_conv": ("gn_silu_conv3x3_launch", [P, P, P, P, P, P, P, P,
                                                 I, I, I, I, I, I, I, I, P]),
    "upsample_conv": ("upsample_conv3x3_launch", [P, P, P, P, P,
                                                   I, I, I, I, I, I, I, P]),
    "flash_attention": ("flash_attention_launch", [P, P, P, P, P, I, I, I,
                                                    I, I, I, F, I, I, I, P]),
    "flash_attention_bwd": ("flash_attention_bwd_launch",
                            [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, F,
                             I, I, I, I, P]),
    "gn_silu": ("gn_silu_launch", [P, P, P, P, P, I, I, I, I, P]),
    "decode_attention": ("decode_attention_launch", [P, P, P, P, P,
                                                     I, I, I, I, I, F, I,
                                                     P]),
    "rwkv6_scan": ("rwkv6_scan_launch", [P, P, P, P, P, P, P, P,
                                         I, I, I, I, I, I, P]),
    "rwkv6_scan_bwd": ("rwkv6_scan_bwd_launch", [P] * 17 + [I] * 5 + [P]),
    "output_epilogue": ("output_epilogue_launch", [P, P, P, P, P, P, P, P,
                                                   I, I, I, I, I, I, I, I,
                                                   P]),
}
#: a source's further entry points, bound as its first one is
MORE_SIGNATURES = {
    "decode_attention": [("decode_attention_partial_launch",
                          [P, P, P, P, P, P, I, I, I, I, I, F, I, P]),
                         ("decode_attention_config", [I, I, I, I, I, I, P])],
    "gn_silu_conv": [("wgmma_tf32_probe_launch", [P, P, P, P])],
    "flash_attention": [("flash_wide_probe_launch", [P, P, P, P, P, P, P]),
                        ("flash_attention_route", [P, P, P, P, I, I]),
                        ("flash_bf16_probe_launch", [P, P, P, P, P, P, I, P])],
    "flash_attention_bwd": [("flash_bwd_probe_launch",
                             [P, P, P, P, P, P, I, P])],
}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):       # headers are shared
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(name.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp, out


def _finish(name: str, job, t0: float) -> None:
    if job is None:
        build_seconds.setdefault(name, 0.0)
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    build_seconds[name] = time.perf_counter() - t0


def build_all(names=SOURCES) -> Dict[str, float]:
    """Compile every listed source in parallel; returns build seconds."""
    t0 = time.perf_counter()
    jobs = {n: _start(n) for n in names if n not in _libs}
    for n, job in jobs.items():
        _finish(n, job, t0)
    for n in names:
        lib(n)
    return {n: build_seconds.get(n, 0.0) for n in names}


def ptxas_report(name: str) -> List[str]:
    """The ``ptxas -v`` lines (each kernel's mangled name, then its
    registers, shared memory and spills) of the last build of ``name`` in
    this checkout."""
    log = BUILD_DIR / f"{name}.log"
    if not log.exists():
        return []
    return [ln.strip() for ln in log.read_text().splitlines()
            if "registers" in ln or "spill" in ln
            or "Compiling entry function" in ln]


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _libs:
        _finish(name, _start(name), time.perf_counter())
        so = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in [SIGNATURES[name],
                             *MORE_SIGNATURES.get(name, [])]:
            getattr(so, fn).argtypes = argtypes
            getattr(so, fn).restype = ctypes.c_int
        _libs[name] = so
    return _libs[name]


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


# ---------------------------------------------------------------------------
# launch helpers shared by the wrappers
# ---------------------------------------------------------------------------

#: why a kernel's launch may not see a tensor that requires grad, where
#: the reason is not that the JAX package never differentiates it: the
#: kernels with a backward are differentiated by an autograd Function,
#: which launches the forward with grad off and the backward kernel itself
NO_BACKWARD = {
    "flash_attention": "its gradient goes through "
                       "kernels.flash_attention.FlashAttention (backward: "
                       "kernels.flash_attention_bwd)",
    "rwkv6_scan": "its gradient goes through "
                  "kernels.rwkv6_scan.RWKV6Scan (backward: "
                  "kernels.rwkv6_scan_bwd)",
}


def forward_only(what: str, **tensors) -> None:
    """Raise before a launch whose output autograd would not see: with
    grad mode on, an input that requires grad would get no gradient
    through the ``ctypes`` launch (its output is a fresh tensor with no
    ``grad_fn``).  Serving under ``torch.inference_mode()`` or
    ``torch.no_grad()`` passes."""
    import torch
    if not torch.is_grad_enabled():
        return
    for name, t in tensors.items():
        if t is not None and t.requires_grad:
            why = NO_BACKWARD.get(what, "the JAX package never "
                                        "differentiates it")
            raise NotImplementedError(
                f"{what}: {name} requires grad, and the launch's output "
                f"has no backward: {why}; call it under torch.no_grad() or "
                "torch.inference_mode()")


def require(what: str, dtypes=None, **tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of one of
    ``dtypes`` (default: float32 only), and (:func:`forward_only`) unless
    autograd can do without a gradient through the launch.  Every
    wrapper calls it on each tensor input before it launches."""
    import torch
    forward_only(what, **tensors)
    dtypes = (torch.float32,) if dtypes is None else dtypes
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} must be a CUDA tensor (a CPU "
                             f"tensor runs the plain version), got "
                             f"{t.device}")
        if t.dtype not in dtypes:
            raise TypeError(f"{what}: {name} must be one of {dtypes}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


#: storage dtype of a conv weight -> its code in the C interfaces
#: (``conv_tile.cuh``'s ``WeightType``)
WEIGHT_CODES = {"float32": 0, "bfloat16": 1, "int8": 2, "int16": 3}


def conv_weight(what: str, w, w_scale, int_dtype=None):
    """Check a conv weight in its storage dtype (fp32, bf16 or
    ``int_dtype``, default int8) and its per-Cout fp32 scale, which an
    integer weight needs and no other takes; returns (the weight's code,
    the scale's pointer or 0)."""
    import torch
    int_dtype = int_dtype or torch.int8
    require(what, dtypes=(torch.float32, torch.bfloat16, int_dtype), w=w)
    scaled = w.dtype == int_dtype
    if scaled != (w_scale is not None):
        raise ValueError(f"{what}: an {int_dtype} weight needs its per-Cout "
                         f"w_scale, and no other weight takes one "
                         f"(w is {w.dtype})")
    code = WEIGHT_CODES[str(w.dtype).replace("torch.", "")]
    if not scaled:
        return code, 0
    require(what, w_scale=w_scale)
    if tuple(w_scale.shape) != (w.shape[-1],):
        raise ValueError(f"{what}: w_scale must be [{w.shape[-1]}], got "
                         f"{tuple(w_scale.shape)}")
    return code, w_scale.data_ptr()


def stream_of(t) -> int:
    """PyTorch's current stream on ``t``'s device, as a C pointer."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
