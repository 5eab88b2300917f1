"""Algorithm 5 ("stripes") co-occurrence counts: CUDA kernel + plain version.

Replaces the TPU kernel ``repro/kernels/stripes.py:stripes_pallas``.  The
kernel is ``csrc/stripes.cu``, CUDA C++ for ``sm_90a``, built with ``nvcc``
at first use into ``build/repro_torch/`` and loaded with ``ctypes``
(``kernels/_build.py``).  Its bound is memory: it must read ``4N`` bytes of
tokens and write ``4*V*V``, at 3.35 TB/s on an H100.  The TPU version keeps
the table in VMEM and adds one-hot outer products on the MXU over a
pre-gathered ``(N, window)`` neighbour matrix; the CUDA version loads a
token tile plus its ``window`` halo into shared memory and adds each pair
with one integer atomic at its upper cell (the lower triangle is mirrored at
the end): into a per-CTA shared table when ``V*V*4`` fits in shared memory,
else into the global table, with the pairs of two hot ids (the most frequent
ids of a sample of the tokens) in a per-CTA shared table (see the source's
header).

:func:`stripe_counts` is the wrapper ``monoids.cooccurrence_stripes`` and
``ops.stripes`` call: on a CUDA tensor it launches the kernel (or raises),
on a CPU tensor it runs :func:`stripe_counts_plain`.
``stripe_counts.launches`` counts kernel launches.

Contract: ``tokens`` (N,) int32/int64, ``vocab`` V >= 1, ``window`` >= 1.
The result is a ``(V, V)`` int32 table: every pair of positions
``(i, i + j)``, ``1 <= j <= window``, whose ids both lie in ``[0, V)`` adds 1
at ``[a, b]`` and 1 at ``[b, a]`` (2 on the diagonal).  Ids outside
``[0, V)`` pair with nothing, as the Pallas kernel's one-hot drops them.
(The JAX package's jnp reference, ``monoids.cooccurrence_stripes``, wraps a
negative id to ``V - 1`` instead; the two agree on ids in ``[0, V)``.)
"""
from __future__ import annotations

import ctypes

import torch

from ._build import CudaLibrary, sm_count

LIBRARY = CudaLibrary("stripes", {"stripes_launch": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]})
_HOT_MAX = 128      # csrc/stripes.cu's kHotMax: the hot set's scratch


def _check(tokens: torch.Tensor, vocab: int, window: int) -> None:
    if tokens.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"tokens must be int32 or int64; got {tokens.dtype}")
    if tokens.dim() != 1:
        raise ValueError(f"tokens must be (N,); got {tuple(tokens.shape)}")
    if vocab < 1 or window < 1:
        raise ValueError(f"vocab and window must be >= 1; got {vocab}, "
                         f"{window}")


def stripe_counts_plain(tokens: torch.Tensor, vocab: int,
                        window: int) -> torch.Tensor:
    """The kernel's contract in plain PyTorch: per offset, both directions'
    pair ids ``a*V + b`` go to one ``index_add_`` into a table with one spare
    slot that takes the dropped pairs."""
    _check(tokens, vocab, window)
    t = tokens.long()
    n, cells = t.shape[0], vocab * vocab
    out = torch.zeros((cells + 1,), dtype=torch.int32, device=t.device)
    for j in range(1, min(window, n - 1) + 1):
        a, b = t[:n - j], t[j:]
        keep = (a >= 0) & (a < vocab) & (b >= 0) & (b < vocab)
        ones = torch.ones_like(a, dtype=torch.int32)
        out.index_add_(0, torch.where(keep, a * vocab + b, cells), ones)
        out.index_add_(0, torch.where(keep, b * vocab + a, cells), ones)
    return out[:cells].reshape(vocab, vocab)


def stripe_counts(tokens: torch.Tensor, vocab: int,
                  window: int) -> torch.Tensor:
    """Symmetric co-occurrence counts: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  Returns ``(vocab, vocab)`` int32."""
    if tokens.device.type == "cpu":
        return stripe_counts_plain(tokens, vocab, window)
    if tokens.device.type != "cuda":
        raise ValueError(f"stripe_counts runs on cuda (kernel) or cpu (plain "
                         f"version); got a {tokens.device} tensor")
    _check(tokens, vocab, window)
    dev = tokens.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return stripe_counts(tokens, vocab, window)
    # ids outside int32 are out of [0, V) either way; the cast keeps them so
    flat = tokens.clamp(-1, vocab).to(torch.int32).contiguous() \
        if tokens.dtype == torch.int64 else tokens.contiguous()
    out = torch.zeros((vocab, vocab), dtype=torch.int32, device=dev)
    n = flat.numel()
    if n == 0:
        return out
    hot = torch.empty((_HOT_MAX + 1,), dtype=torch.int32, device=dev)
    err = LIBRARY.load().stripes_launch(
        flat.data_ptr(), out.data_ptr(), hot.data_ptr(), n, vocab, window,
        sm_count(dev), torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"stripes kernel launch failed: CUDA error {err} "
                           f"(N={n}, V={vocab}, window={window})")
    stripe_counts.launches += 1
    return out


stripe_counts.launches = 0
