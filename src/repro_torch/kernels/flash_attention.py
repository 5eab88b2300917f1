"""Flash attention forward (the ``attn_state`` fold): CUDA kernel + plain version.

Replaces the TPU kernel ``repro/kernels/flash_attention.py:flash_attention``
(body ``_flash_kernel``).  The kernel is ``csrc/flash_attention.cu``, CUDA
C++ for ``sm_90a``, built with ``nvcc`` at first use into
``build/repro_torch/`` and loaded with ``ctypes`` (``kernels/_build.py``).

What bounds it: at the serving path's prefill shape (4 prompts x 64 tokens,
16 / 8 heads of 128, bf16) it moves 3 MB of q, k, v and o against ~68 MFLOP,
so bytes bound it (and in practice the launch); at long sequences (4096) it
is ~69 GFLOP against 50 MB, so the tensor cores' rate bounds it.  The design
keeps what the TPU kernel keeps out of device memory: one block per (batch,
head, query tile) loops over the KV tiles with the running (m, l, o) in
registers, so no score matrix reaches device memory, and reads the shared KV
head by index (no repeated KV).  Its products run on the tensor cores
(``mma.sync``), with the softmax weights split into two 16-bit halves and
float32 inputs into three bf16 products, so the float32 contract below
holds (see the source's header).

:func:`flash_attention` is the counted wrapper the model's full-sequence
attention calls: on a CUDA tensor it launches the kernel (or raises), on a
CPU tensor it runs :func:`flash_attention_plain`.
``flash_attention.launches`` counts kernel launches.

Contract (the Pallas kernel's): q ``(B, H, Sq, d)``, k and v ``(B, KV, Sk,
d)`` with ``H % KV == 0``, all float32, all bfloat16 or all float16, any
``d`` in 1..256 (the reference's attention takes any head dim and float
type).  Inputs are cast up to float32, scores and softmax weights stay
float32, the output ``o / max(l, 1e-30)`` comes back in q's dtype.
``causal`` masks top-left, ``k_pos <= q_pos``.  ``q_offset``, a ``(B,)``
integer tensor (causal only), places query ``i`` of batch ``b`` at
position ``q_offset[b] + i``, so it keeps the keys ``k_pos <= q_offset[b] +
i``: the warm prefill of the radix prefix cache, whose queries are each
row's uncached suffix and whose keys are the per-layer cache (offsets all
zero give the top-left result bit for bit).  ``window`` (an int >= 1,
causal only, composes with ``q_offset``) is the sliding window of the
reference's ``_causal_mask``: query ``i`` of row ``b`` at ``qp = q_offset[b]
+ i`` keeps the keys ``qp - window < k_pos <= qp``; the kernel starts each
block at the tile of its first live key, so KV tiles wholly below the
window are never read.  Unlike the Pallas kernel,
any ``Sq`` and ``Sk`` are taken (no block-multiple assert), and the kernel
reads any batch / head / row strides with a unit-stride last axis: the model
hands it its ``(B, S, H, d)`` projections transposed as views, and the
output has q's memory layout.

Training differentiates through the same wrapper: with grad mode on and an
input that requires grad, :func:`flash_attention` runs a
``torch.autograd.Function`` whose forward launch also writes each row's
log-sum-exp (``lse``, (B, H, Sq) float32; null on the serve path, which
writes nothing more than before) and whose backward is
:func:`flash_attention_bwd`: the hand-written ``csrc/flash_attention_bwd.cu``
on CUDA tensors (no TPU kernel to replace: the Pallas kernel has no
backward, the JAX package differentiates its XLA attention), and
:func:`flash_attention_backward_plain` on CPU tensors.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..core.monoids import attn_state
from ._build import CudaLibrary

_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
LIBRARY = CudaLibrary("flash_attention", {"flash_attention_launch": [
    _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
    _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
    ctypes.c_float, _I, _P, _I, _P, _P]})
BWD_LIBRARY = CudaLibrary("flash_attention_bwd", {
    "flash_attention_bwd_launch": [_P] * 10 + [_I] * 7 + [_L] * 24 +
    [ctypes.c_float, _I, _I, _P]})

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_HEAD_DIM = 256      # the largest attention head of any config (gemma3)
PLAIN_BLOCK_K = 128     # the Pallas kernel's default KV block
_INT32_MAX = 2 ** 31 - 1


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_offset: Optional[torch.Tensor] = None,
           causal: bool = True, window: Optional[int] = None) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be 4-d (B, heads, S, d); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != d:
        raise ValueError(f"k and v must be (B={B}, KV, Sk, d={d}) alike; "
                         f"got {tuple(k.shape)}, {tuple(v.shape)}")
    KV = k.shape[1]
    if KV < 1 or H % KV:
        raise ValueError(f"query heads ({H}) must be a multiple of the KV "
                         f"heads ({KV})")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"q, k, v must be all float32, all bfloat16 or all "
                        f"float16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be in [1, {MAX_HEAD_DIM}]; got {d}")
    if q_offset is not None:
        if not causal:
            raise ValueError("q_offset places the queries on the causal "
                             "mask; it needs causal=True")
        if tuple(q_offset.shape) != (B,) or q_offset.is_floating_point() \
                or q_offset.is_complex() or q_offset.dtype == torch.bool:
            raise ValueError(f"q_offset must be a ({B},) integer tensor; got "
                             f"{tuple(q_offset.shape)} {q_offset.dtype}")
        if q_offset.device != q.device:
            raise ValueError("q_offset must lie on q's device")
    if window is not None:
        if not causal:
            raise ValueError("a sliding window bounds the causal mask from "
                             "below; it needs causal=True")
        if isinstance(window, bool) or int(window) != window or window < 1:
            raise ValueError(f"window must be an integer >= 1; got "
                             f"{window!r}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          q_offset: Optional[torch.Tensor] = None,
                          window: Optional[int] = None) -> torch.Tensor:
    """The kernel's contract in plain PyTorch: float32 partial states
    ``(m, l, o)`` of each KV block of ``PLAIN_BLOCK_K`` keys, with the Pallas
    kernel's ``-inf`` guards, folded with ``core.monoids.attn_state``;
    ``window`` adds the lower edge ``k_pos > q_pos - window``."""
    _check(q, k, v, q_offset, causal, window)
    B, H, Sq, d = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    qf = q.to(torch.float32).reshape(B, KV, H // KV, Sq, d)
    kf = k.to(torch.float32)[:, :, None]                  # (B, KV, 1, Sk, d)
    vf = v.to(torch.float32)[:, :, None]
    q_pos = torch.arange(Sq, device=q.device)
    # under the top-left mask no query sees a key at or past Sq
    k_end = min(Sk, Sq) if causal else Sk
    if q_offset is not None:
        # (B, 1, 1, Sq) positions; the last query sees max(offset) + Sq keys
        q_pos = (q_offset.to(torch.long)[:, None] + q_pos)[:, None, None]
        k_end = min(Sk, max(int(q_offset.max()), 0) + Sq) if B else 0
    rows = qf.new_empty(qf.shape[:-1])
    acc = attn_state.identity_like((rows, rows, qf))
    for k0 in range(0, k_end, PLAIN_BLOCK_K):
        kb = kf[..., k0:k0 + PLAIN_BLOCK_K, :]
        vb = vf[..., k0:k0 + PLAIN_BLOCK_K, :]
        s = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        if causal:
            k_pos = k0 + torch.arange(kb.shape[-2], device=q.device)
            drop = k_pos > q_pos[..., None]
            if window is not None:
                drop |= k_pos <= q_pos[..., None] - window
            s = s.masked_fill(drop, -math.inf)
        m = s.amax(dim=-1)
        m_safe = torch.where(torch.isneginf(m), 0.0, m)
        p = torch.where(torch.isneginf(s), 0.0, torch.exp(s - m_safe[..., None]))
        acc = attn_state.combine(acc, (m, p.sum(dim=-1), torch.matmul(p, vb)))
    return attn_state.extract(acc).reshape(B, H, Sq, d).to(q.dtype)


def _unit_last(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def _device_of(q: torch.Tensor, *others: torch.Tensor) -> torch.device:
    dev = q.device
    if any(t.device != dev for t in others):
        raise ValueError("q, k and v (and o, do) must share a device")
    return dev


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            q_offset: Optional[torch.Tensor], window: Optional[int],
            lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of the forward kernel on CUDA tensors (checked), writing
    each row's log-sum-exp into ``lse`` when given; counted."""
    _check(q, k, v, q_offset, causal, window)
    dev = _device_of(q, k, v)
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch(q, k, v, causal, q_offset, window, lse)
    q, k, v = _unit_last(q), _unit_last(k), _unit_last(v)
    if q_offset is not None and q_offset.dtype != torch.int32:
        q_offset = q_offset.to(torch.int32)
    out = torch.empty_like(q)      # q's layout (dense q) or contiguous
    B, H, Sq, d = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if B == 0 or Sq == 0:
        return out
    # the raw handle of the current stream (the one the inductor's launchers
    # read): torch.cuda.current_stream() builds a Stream object per call
    err = LIBRARY.load().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[q.dtype], B, H, KV, Sq, Sk, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], 1.0 / math.sqrt(d), int(causal),
        None if q_offset is None else q_offset.contiguous().data_ptr(),
        0 if window is None else min(int(window), _INT32_MAX),
        None if lse is None else lse.data_ptr(),
        torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype})")
    flash_attention.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    q_offset: Optional[torch.Tensor] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Attention of ``q`` over ``k`` / ``v`` (layout ``(B, heads, S, d)``),
    queries at ``q_offset[b] + i`` when given, keys within ``window`` of
    each query when given: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Returns ``(B, H, Sq, d)`` in q's dtype, laid
    out in memory as q is.

    When grad mode is on and an input requires grad, the call goes through
    a ``torch.autograd.Function`` whose backward is
    :func:`flash_attention_bwd` (the forward launch then also writes each
    row's log-sum-exp for it); otherwise the call is the serve path's
    launch, which writes no log-sum-exp.  ``q_offset`` has no backward (the
    warm prefill is never differentiated) and raises with grad."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or
                                    v.requires_grad):
        if q_offset is not None:
            raise ValueError("flash_attention has no backward for q_offset "
                             "(the warm prefill is not differentiated); "
                             "call it under torch.no_grad()")
        return _FlashAttention.apply(q, k, v, causal, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda (kernel) or cpu "
                         f"(plain version); got a {q.device} tensor")
    return _launch(q, k, v, causal, q_offset, window)


flash_attention.launches = 0


class _FlashAttention(torch.autograd.Function):
    """The differentiable call: the forward kernel (with its log-sum-exp)
    and :func:`flash_attention_bwd`, or the plain pair on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        if q.device.type == "cpu":
            out = flash_attention_plain(q, k, v, causal=causal,
                                        window=window)
            lse = None
        elif q.device.type == "cuda":
            B, H, Sq, _ = q.shape
            lse = torch.empty((B, H, Sq), dtype=torch.float32,
                              device=q.device)
            out = _launch(q, k, v, causal, None, window, lse)
        else:
            raise ValueError(f"flash_attention runs on cuda (kernel) or cpu "
                             f"(plain version); got a {q.device} tensor")
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do, lse,
                                         causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, o: torch.Tensor,
                                   do: torch.Tensor,
                                   lse: Optional[torch.Tensor] = None, *,
                                   causal: bool = True,
                                   window: Optional[int] = None):
    """The backward's formulas in plain PyTorch, float32, under the
    forward's masks (top-left causal, ``window``, or none): with ``s = (q .
    k) * scale``, ``D = rowsum(do * o)``, ``P = exp(s - lse)``, ``dV = P^T
    do``, ``dP = do V^T``, ``dS = P * (dP - D)``, ``dQ = dS K * scale``,
    ``dK = dS^T Q * scale``, the query heads of a GQA group summed into
    their KV head.  ``lse`` (B, H, Sq) is the forward's row log-sum-exp,
    computed here when None.  Returns (dq, dk, dv) in the inputs' dtypes."""
    _check(q, k, v, None, causal, window)
    B, H, Sq, d = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(d)
    qf = q.to(torch.float32).reshape(B, KV, G, Sq, d)
    kf = k.to(torch.float32)[:, :, None]                  # (B, KV, 1, Sk, d)
    vf = v.to(torch.float32)[:, :, None]
    of = o.to(torch.float32).reshape(B, KV, G, Sq, d)
    dof = do.to(torch.float32).reshape(B, KV, G, Sq, d)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    keep = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        q_pos = torch.arange(Sq, device=q.device)[:, None]
        k_pos = torch.arange(Sk, device=q.device)[None, :]
        keep = k_pos <= q_pos
        if window is not None:
            keep &= k_pos > q_pos - window
    s = s.masked_fill(~keep, -math.inf)
    lse = torch.logsumexp(s, dim=-1) if lse is None else \
        lse.to(torch.float32).reshape(B, KV, G, Sq)
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - (dof * of).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf).sum(dim=2) * scale
    dv = torch.matmul(p.transpose(-1, -2), dof).sum(dim=2)
    return (dq.reshape(B, H, Sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor,
                        lse: Optional[torch.Tensor], *, causal: bool = True,
                        window: Optional[int] = None):
    """(dq, dk, dv) of :func:`flash_attention`'s output ``o`` under the
    upstream gradient ``do``: the CUDA kernel (``csrc/flash_attention_bwd.cu``,
    reading the forward's (B, H, Sq) float32 ``lse``) for CUDA tensors, the
    plain version for CPU tensors.  Each result has its input's dtype and,
    for a dense input, its memory layout.  ``flash_attention_bwd.launches``
    counts kernel calls (each is three CUDA launches: D, dK / dV, dQ)."""
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, o, do, lse,
                                              causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda (kernel) or cpu "
                         f"(plain version); got a {q.device} tensor")
    _check(q, k, v, None, causal, window)
    dev = _device_of(q, k, v, o, do)
    B, H, Sq, d = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or \
            do.dtype != q.dtype:
        raise ValueError(f"o and do must be (B, H, Sq, d) = {tuple(q.shape)} "
                         f"in {q.dtype}; got {tuple(o.shape)} {o.dtype}, "
                         f"{tuple(do.shape)} {do.dtype}")
    if lse is None or tuple(lse.shape) != (B, H, Sq) or \
            lse.dtype != torch.float32 or lse.device != dev:
        raise ValueError(f"the kernel reads the forward's ({B}, {H}, {Sq}) "
                         f"float32 lse on {dev}")
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                       window=window)
    q, k, v = _unit_last(q), _unit_last(k), _unit_last(v)
    o, do, lse = _unit_last(o), _unit_last(do), lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if B == 0:
        return dq, dk, dv
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    err = BWD_LIBRARY.load().flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), _DTYPE_CODE[q.dtype], B, H, KV, Sq,
        Sk, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *o.stride()[:3], *do.stride()[:3], *dq.stride()[:3],
        *dk.stride()[:3], *dv.stride()[:3], 1.0 / math.sqrt(d), int(causal),
        0 if window is None else min(int(window), _INT32_MAX),
        torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {err} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype})")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
