"""The backward of ``rwkv6_scan``: ``csrc/rwkv6_scan_bwd.cu``.

It replaces no TPU kernel (the JAX package differentiates its chunked
XLA form, ``models/ssm.py``'s ``rwkv6_chunked``, and its Pallas
``rwkv6_scan`` has no backward).  Three launches in a fixed order with no
atomic sum: the forward's own state walk writes the state at the start
of every 16-token sub-chunk into a scratch (n h (ceil(t / 16) + 1) d^2
fp32); a block per (sequence, head) pair and tile of value columns walks
the sub-chunks from the last to the first with the state's cotangent
resident in registers, its d^2 products in 3xTF32 on ``mma.sync``; a pass
sums du over the sequences (and dr, dk, dw over the value-column tiles
above d 64).  r, k, v and the output's cotangent in fp32 or bf16, any t,
1 <= d <= 128; it raises outside them.  On the CPU: the plain version,
``ref.rwkv6_scan_bwd_ref``.  ``rwkv6_scan.RWKV6Scan``'s backward calls
:func:`rwkv6_scan_bwd`.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_attention import DTYPES

#: kernel launches of :func:`rwkv6_scan_bwd` in this process
launches = 0

#: largest head dim the kernel takes (the cotangent lives in registers)
MAX_HEAD_DIM = 128


def tiles(d: int) -> int:
    """Value-column tiles a pair's backward takes: one up to d 64, else
    tiles of 32 (``BTile`` in ``csrc/rwkv6_scan_bwd.cu``)."""
    return 1 if d <= 64 else -(-d // 32)


def rwkv6_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor,
                   state: Optional[torch.Tensor],
                   dout: Optional[torch.Tensor],
                   dstate: Optional[torch.Tensor]):
    """(dr, dk, dv, dw, du, dstate0) of ``rwkv6_scan(r, k, v, w, u,
    state)`` against the cotangents ``dout`` of its output and ``dstate``
    of its final state (either None: zero): dr, dk, dv in r's dtype, dw,
    du and dstate0 fp32, dstate0 None where ``state`` is None.  The
    kernels on CUDA tensors, the plain ``ref.rwkv6_scan_bwd_ref`` on CPU
    ones."""
    global launches
    if r.device.type == "cpu":
        grads = ref.rwkv6_scan_bwd_ref(r, k, v, w, u, state, dout, dstate)
        return grads[:5] + (None if state is None else grads[5],)
    n, h, t, d = r.shape
    dout = torch.zeros_like(r) if dout is None else \
        dout.to(r.dtype).contiguous()
    build.require("rwkv6_scan_bwd", dtypes=tuple(DTYPES), r=r, k=k, v=v,
                  dout=dout)
    states = {} if state is None else {"state": state}
    if dstate is not None:
        dstate = dstate.float().contiguous()
        states["dstate"] = dstate
    build.require("rwkv6_scan_bwd", w=w, u=u, **states)
    if k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"rwkv6_scan_bwd: r, k, v must share a dtype, got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    if any(tuple(a.shape) != (n, h, t, d) for a in (k, v, w, dout)) or \
            tuple(u.shape) != (h, d) or any(
                tuple(s.shape) != (n, h, d, d) for s in states.values()):
        raise ValueError("rwkv6_scan_bwd: r/k/v/w/dout must be [n, h, t, d], "
                         "u [h, d], state and dstate [n, h, d, d]")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"rwkv6_scan_bwd: head dim {d} must be in 1.."
                         f"{MAX_HEAD_DIM} (the cotangent lives in registers)")
    dev, f32 = r.device, torch.float32
    nt, nc = tiles(d), -(-t // ref.RWKV_CHUNK)
    scratch = torch.empty(n * h * (nc + 1) * d * d, dtype=f32, device=dev)
    parts = (torch.empty(3 * nt * n * h * t * d, dtype=f32, device=dev)
             if nt > 1 else None)
    du_part = torch.empty(n * h * nt * d, dtype=f32, device=dev)
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dw = torch.empty((n, h, t, d), dtype=f32, device=dev)
    du = torch.empty((h, d), dtype=f32, device=dev)
    ds0 = None if state is None else torch.empty((n, h, d, d), dtype=f32,
                                                 device=dev)

    def ptr(x):
        return None if x is None else x.data_ptr()

    build.check(build.lib("rwkv6_scan_bwd").rwkv6_scan_bwd_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        ptr(state), dout.data_ptr(), ptr(dstate), dr.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(), ptr(ds0),
        scratch.data_ptr(), ptr(parts), du_part.data_ptr(), n, h, t, d,
        DTYPES[r.dtype], build.stream_of(r)), "rwkv6_scan_bwd")
    launches += 1
    return dr, dk, dv, dw, du, ds0
