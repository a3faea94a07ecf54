"""RWKV-6 (Finch) linear-attention recurrence (counterpart of the JAX
package's ``kernels/rwkv6_scan.py``): the time mix of every RWKV-6 layer,
in the prefill and in each decode step::

    out_t = r_t . (S + u (x) (k_t (x) v_t));   S <- diag(exp(-exp(w_t))) S + k_t (x) v_t

On CUDA: ``csrc/rwkv6_scan.cu``, r/k/v in fp32 or bf16, w, u and the
state in fp32, the output in r's dtype, through one of two kernels picked
by the token count alone.  Above :data:`DECODE_MAX_T` tokens (the
prefill) the chunked kernel: a block per (sequence, head) and tile of
value columns keeps its slice of the state in registers and walks the
tokens in sub-chunks of 16, the inter-chunk term, the intra-chunk term
and the state update as 3xTF32 products on the tensor cores.  At most
:data:`DECODE_MAX_T` tokens (a decode step) the decode kernel: eight
warps hold one pair's whole state, read and written once in 16-byte
pieces.  The final state may be written over the initial one
(``out_state=state``), which is how ``decode_step`` updates its cache in
place.  On the CPU: the plain version, ``ref.rwkv6_scan_ref``, one token
at a time.

Under autograd (grad mode on and an input that requires grad) the call
goes through :class:`RWKV6Scan`: the forward is the kernel (or the plain
version on the CPU), the backward the kernel of ``csrc/rwkv6_scan_bwd.cu``
(:mod:`repro_torch.kernels.rwkv6_scan_bwd`; on the CPU its plain version,
``ref.rwkv6_scan_bwd_ref``), from the saved inputs.  No TPU kernel had a
backward: the JAX package's RWKV-6 block differentiates its chunked form,
``rwkv6_chunked``, which ``tests/test_torch_rwkv_bwd.py`` holds the
plain backward to.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.profiler import record_function

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_attention import DTYPES
from repro_torch.kernels.rwkv6_scan_bwd import rwkv6_scan_bwd

#: kernel launches of :func:`rwkv6_scan` in this process
launches = 0

#: largest head dim the kernels take (the state lives in registers)
MAX_HEAD_DIM = 128

#: calls of at most this many tokens run the decode kernel, longer ones the
#: chunked kernel: the decode kernel's cost is the state's bytes plus one
#: block-wide reduction per token, the chunked kernel's a sub-chunk of 16
#: tokens whatever t is
DECODE_MAX_T = 4


class RWKV6Scan(torch.autograd.Function):
    """The recurrence with the kernel's forward and the backward kernel:
    saves the inputs and, in the backward pass, calls
    :func:`~repro_torch.kernels.rwkv6_scan_bwd.rwkv6_scan_bwd` on them
    (one launch of ``rwkv6_scan_bwd`` on the card, which recomputes the
    forward's states itself; ``ref.rwkv6_scan_bwd_ref`` on the CPU).
    Returns (out, final state); either may go unused, and its cotangent
    is then None (zero)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        out, final = _forward(r, k, v, w, u, state, None)
        ctx.save_for_backward(r, k, v, w, u, state)
        ctx.set_materialize_grads(False)
        return out, final

    @staticmethod
    def backward(ctx, dout, dstate):
        saved = [None if t is None else t.detach()
                 for t in ctx.saved_tensors]
        with record_function("rwkv6_scan_bwd"):
            grads = rwkv6_scan_bwd(*saved, dout, dstate)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               state: Optional[torch.Tensor] = None,
               out_state: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w [n, h, t, d]; u [h, d]; state [n, h, d, d] fp32 (zeros
    if None) -> (out [n, h, t, d] in r's dtype, final state [n, h, d, d]
    fp32).  The final state goes into ``out_state`` when given (it may be
    ``state`` itself), else into a new tensor.  With grad mode on and an
    input that requires grad the call is differentiable
    (:class:`RWKV6Scan`), and takes no ``out_state``."""
    n, h, t, d = r.shape
    sshape = (n, h, d, d)
    if any(tuple(a.shape) != (n, h, t, d) for a in (k, v, w)) or \
            tuple(u.shape) != (h, d) or \
            any(s is not None and tuple(s.shape) != sshape
                for s in (state, out_state)):
        raise ValueError(
            f"rwkv6_scan: r {tuple(r.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, w {tuple(w.shape)}, u {tuple(u.shape)}, "
            f"state {None if state is None else tuple(state.shape)} "
            "disagree (r/k/v/w [n, h, t, d], u [h, d], state [n, h, d, d])")
    if torch.is_grad_enabled() and any(
            a is not None and a.requires_grad for a in (r, k, v, w, u, state)):
        if out_state is not None:
            raise ValueError("rwkv6_scan: out_state is written in place, "
                             "which autograd cannot follow; leave it None "
                             "under grad")
        return RWKV6Scan.apply(r, k, v, w, u, state)
    return _forward(r, k, v, w, u, state, out_state)


def _forward(r, k, v, w, u, state, out_state):
    """The forward alone: the kernel on a CUDA tensor, the plain version
    on a CPU one."""
    global launches
    n, h, t, d = r.shape
    sshape = (n, h, d, d)
    if r.device.type == "cpu":
        out, final = ref.rwkv6_scan_ref(r, k, v, w, u, state)
        if out_state is None:
            return out, final
        out_state.copy_(final)
        return out, out_state
    build.require("rwkv6_scan", dtypes=tuple(DTYPES), r=r, k=k, v=v)
    states = {} if state is None else {"state": state}
    if out_state is not None:
        states["out_state"] = out_state
    build.require("rwkv6_scan", w=w, u=u, **states)
    if k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"rwkv6_scan: r, k, v must share a dtype, got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"rwkv6_scan: head dim {d} must be in 1.."
                         f"{MAX_HEAD_DIM} (the state lives in registers)")
    out = torch.empty_like(r)
    if out_state is None:
        out_state = torch.empty(sshape, dtype=torch.float32, device=r.device)
    build.check(build.lib("rwkv6_scan").rwkv6_scan_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        None if state is None else state.data_ptr(), out.data_ptr(),
        out_state.data_ptr(), n * h, h, t, d, DTYPES[r.dtype],
        int(t <= DECODE_MAX_T), build.stream_of(r)), "rwkv6_scan")
    launches += 1
    return out, out_state
