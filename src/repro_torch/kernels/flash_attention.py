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
``causal`` masks top-left, ``k_pos <= q_pos``.  Unlike the Pallas kernel,
any ``Sq`` and ``Sk`` are taken (no block-multiple assert), and the kernel
reads any batch / head / row strides with a unit-stride last axis: the model
hands it its ``(B, S, H, d)`` projections transposed as views, and the
output has q's memory layout.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..core.monoids import attn_state
from ._build import CudaLibrary

_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
LIBRARY = CudaLibrary("flash_attention", {"flash_attention_launch": [
    _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
    _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
    ctypes.c_float, _I, _P]})

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_HEAD_DIM = 256      # the largest attention head of any config (gemma3)
PLAIN_BLOCK_K = 128     # the Pallas kernel's default KV block


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
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


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True) -> torch.Tensor:
    """The kernel's contract in plain PyTorch: float32 partial states
    ``(m, l, o)`` of each KV block of ``PLAIN_BLOCK_K`` keys, with the Pallas
    kernel's ``-inf`` guards, folded with ``core.monoids.attn_state``."""
    _check(q, k, v)
    B, H, Sq, d = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    qf = q.to(torch.float32).reshape(B, KV, H // KV, Sq, d)
    kf = k.to(torch.float32)[:, :, None]                  # (B, KV, 1, Sk, d)
    vf = v.to(torch.float32)[:, :, None]
    q_pos = torch.arange(Sq, device=q.device)
    rows = qf.new_empty(qf.shape[:-1])
    acc = attn_state.identity_like((rows, rows, qf))
    # under the top-left mask no query sees a key at or past Sq
    k_end = min(Sk, Sq) if causal else Sk
    for k0 in range(0, k_end, PLAIN_BLOCK_K):
        kb = kf[..., k0:k0 + PLAIN_BLOCK_K, :]
        vb = vf[..., k0:k0 + PLAIN_BLOCK_K, :]
        s = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        if causal:
            k_pos = k0 + torch.arange(kb.shape[-2], device=q.device)
            s = s.masked_fill(k_pos[None, :] > q_pos[:, None], -math.inf)
        m = s.amax(dim=-1)
        m_safe = torch.where(torch.isneginf(m), 0.0, m)
        p = torch.where(torch.isneginf(s), 0.0, torch.exp(s - m_safe[..., None]))
        acc = attn_state.combine(acc, (m, p.sum(dim=-1), torch.matmul(p, vb)))
    return attn_state.extract(acc).reshape(B, H, Sq, d).to(q.dtype)


def _unit_last(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Attention of ``q`` over ``k`` / ``v`` (layout ``(B, heads, S, d)``):
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    Returns ``(B, H, Sq, d)`` in q's dtype, laid out in memory as q is."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda (kernel) or cpu "
                         f"(plain version); got a {q.device} tensor")
    _check(q, k, v)
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("q, k and v must share a device")
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return flash_attention(q, k, v, causal=causal)
    q, k, v = _unit_last(q), _unit_last(k), _unit_last(v)
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
        torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
