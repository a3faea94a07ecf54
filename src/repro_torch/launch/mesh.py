"""Hardware constants of one NVIDIA H100 for the roofline and the cost
model, and the device-mesh constructors (counterpart of the JAX package's
``launch/mesh.py``).

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

The meshes are functions, not module constants: importing this module
touches no process group.  :func:`make_production_mesh` is the
reference's ``(16, 16)`` ("data", "model") mesh, or ``(2, 16, 16)``
("pod", "data", "model"), over an already-launched world of that many
ranks; :func:`make_local_mesh` the ``(1, 1)`` mesh with the production
axis names on one device, making a world-size-1 group over a
``HashStore`` where none exists (no port, no network).
"""

from __future__ import annotations

import os
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


def _world_size() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production mesh through ``init_device_mesh``: one rank per
    card, the world already launched (``torchrun`` or an initialised
    process group).  Raises, naming both numbers, where the world size
    is not the mesh's.  ``device_type`` ``"cpu"`` is the dry run's mesh
    over a fake world (:mod:`repro_torch.launch.dryrun`)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    size = 1
    for n in shape:
        size *= n
    world = _world_size()
    if world != size:
        raise ValueError(f"the production mesh {shape} {axes} needs "
                         f"{size} ranks, and the world has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_local_mesh(device=None):
    """A ``(1, 1)`` ("data", "model") mesh on one device (``"cuda"``
    unless the caller asks for the CPU; raises where CUDA is absent).
    Without a process group it makes one of world size 1 over a
    ``HashStore``: NCCL on the card, gloo on the CPU."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            import torch
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    world = dist.get_world_size()
    if world != 1:
        raise ValueError(f"the local mesh (1, 1) needs 1 rank, and the "
                         f"world has {world}")
    return init_device_mesh(dev.type, (1, 1),
                            mesh_dim_names=("data", "model"))
