"""Hardware constants of one NVIDIA H100 for the roofline and the cost
model, and the mesh constructors (not ported yet).

The three names the roofline reads keep the JAX package's, with the
H100 SXM's dense figures from NVIDIA's data sheet: ``PEAK_FLOPS_BF16``
(bf16 on the tensor cores), ``HBM_BW`` and ``ICI_BW``.  ``ICI_BW`` is an
NVLink figure, not an ICI link's: 450 GB/s per direction per GPU (the
data sheet's 900 GB/s counts both directions together).
``PEAK_FLOPS_TF32`` is the dense TF32 tensor-core rate: an fp32 product
in 3xTF32 (how the port's conv tile and fp32 attention run) costs three
of them, so fp32 work on the tensor cores peaks at a third of it.
``PEAK_FLOPS_FP32`` is the CUDA cores' fp32 rate.

:func:`card_peaks` reads the same figures, and those of the PCIe and NVL
parts, off a device name (``torch.cuda.get_device_name``).
"""

from __future__ import annotations

from typing import Tuple

PEAK_FLOPS_BF16 = 989e12          # dense bf16 tensor-core FLOP/s
PEAK_FLOPS_TF32 = 495e12          # dense TF32 tensor-core FLOP/s
PEAK_FLOPS_FP32 = 67e12           # fp32 FLOP/s on the CUDA cores
HBM_BW = 3.35e12                  # bytes/s
ICI_BW = 450e9                    # NVLink bytes/s per direction per GPU


def card_peaks(name: str) -> Tuple[float, float, str, float, float]:
    """(fp32 FLOP/s outside the tensor cores, HBM bytes/s, description,
    dense bf16 tensor-core FLOP/s, dense TF32 tensor-core FLOP/s) of the
    part, from NVIDIA's data sheets, read off the device name."""
    if "PCIe" in name:
        return (51e12, 2.0e12, "H100 PCIe: 51 TFLOP/s fp32, 756 TFLOP/s "
                "bf16 and 378 TF32 dense tensor, 2.0 TB/s", 756e12, 378e12)
    if "NVL" in name:
        return (60e12, 3.9e12, "H100 NVL: 60 TFLOP/s fp32, 835 TFLOP/s bf16 "
                "and 417 TF32 dense tensor, 3.9 TB/s", 835e12, 417e12)
    return (PEAK_FLOPS_FP32, HBM_BW, "H100 SXM: 67 TFLOP/s fp32, 989 "
            "TFLOP/s bf16 and 495 TF32 dense tensor, 3.35 TB/s",
            PEAK_FLOPS_BF16, PEAK_FLOPS_TF32)


def make_production_mesh(*, multi_pod: bool = False):
    raise NotImplementedError(
        "device meshes are not ported yet (ROADMAP A 16, dist)")


def make_local_mesh():
    raise NotImplementedError(
        "device meshes are not ported yet (ROADMAP A 16, dist)")
