"""Count-min sketch batch update (paper §3): CUDA kernel + plain version.

Replaces the TPU kernel ``repro/kernels/cms.py:cms_update_pallas``.  The
kernel is ``csrc/cms_update.cu``, CUDA C++ for ``sm_90a``, built with
``nvcc`` at first use into ``build/repro_torch/`` and loaded with ``ctypes``
(``kernels/_build.py``).  Its bound is memory: it must read the tokens (4 or
8 bytes each) and weights (1 or 4) and write ``depth*width*4``, at 3.35 TB/s
on an H100.  The TPU version scatters with a one-hot matmul per hash row on
the MXU; the CUDA version adds one integer atomic per (token, row) into a
per-CTA shared table when the table fits in shared memory, and into the
global table (with each CTA's hot ids counted once per token) otherwise
(see the source's header).  A memset of the table and one launch per call.

:func:`cms_counts` is the wrapper ``monoids.cms_update_batch`` and
``ops.cms_update`` call: on a CUDA tensor it launches the kernel (or
raises), on a CPU tensor it runs :func:`cms_counts_plain`.
``cms_counts.launches`` counts kernel launches.

Contract: ``tokens`` int32/int64 of any shape (flattened; a bucket hashes
the id's low 32 bits, as JAX's int32 -> uint32 convert does), optional
``weights`` of the same number of elements (int32, uint8, or a bool mask
taken as 0/1; the kernel reads each type as it is), ``depth`` hash rows
with seeds ``d``, ``width`` buckets.  The result is a ``(depth, width)``
int32 table of exact counts.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.monoids import _uhash
from ._build import CudaLibrary, sm_count

LIBRARY = CudaLibrary("cms_update", {"cms_update_launch": [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p]})
# the kernel's codes: bytes per token id, and weight kind (0 = none)
_TOKEN_BYTES = {torch.int32: 4, torch.int64: 8}
_WEIGHT_KIND = {torch.int32: 1, torch.uint8: 2, torch.bool: 2}


def _check(tokens: torch.Tensor, depth: int, width: int,
           weights: Optional[torch.Tensor]) -> None:
    if tokens.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"tokens must be int32 or int64; got {tokens.dtype}")
    if depth < 1 or width < 1:
        raise ValueError(f"depth and width must be >= 1; got {depth}, {width}")
    if weights is not None and weights.numel() != tokens.numel():
        raise ValueError(f"weights must have one entry per token "
                         f"({tokens.numel()}); got {tuple(weights.shape)}")
    if weights is not None and weights.dtype not in _WEIGHT_KIND:
        raise TypeError(f"weights must be int32, uint8 or a bool mask; got "
                        f"{weights.dtype}")


def cms_counts_plain(tokens: torch.Tensor, depth: int, width: int, *,
                     weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's contract in plain PyTorch: one ``index_add_`` per hash
    row into the flattened table."""
    _check(tokens, depth, width, weights)
    flat = tokens.reshape(-1)
    w = torch.ones_like(flat, dtype=torch.int32) if weights is None \
        else weights.reshape(-1).to(torch.int32)
    out = torch.zeros((depth * width,), dtype=torch.int32, device=flat.device)
    for d in range(depth):
        out.index_add_(0, d * width + _uhash(flat, d) % width, w)
    return out.reshape(depth, width)


def cms_counts(tokens: torch.Tensor, depth: int, width: int, *,
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Count-min counts of a token batch: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors.  Returns ``(depth, width)`` int32."""
    if not tokens.is_cuda:
        if tokens.device.type == "cpu":
            return cms_counts_plain(tokens, depth, width, weights=weights)
        raise ValueError(f"cms_counts runs on cuda (kernel) or cpu (plain "
                         f"version); got a {tokens.device} tensor")
    _check(tokens, depth, width, weights)
    dev = tokens.device
    if weights is not None and weights.device != dev:
        raise ValueError("tokens and weights must share a device")
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return cms_counts(tokens, depth, width, weights=weights)
    # a contiguous tensor's memory is its flattened ids; the kernel reads
    # int64 ids' low 32 bits, and every weight type, as they are
    flat = tokens if tokens.is_contiguous() else tokens.contiguous()
    w = weights if weights is None or weights.is_contiguous() \
        else weights.contiguous()
    n = flat.numel()
    if n == 0:
        return torch.zeros((depth, width), dtype=torch.int32, device=dev)
    # the launch zeroes the table itself (a memset, no fill_ dispatch)
    out = torch.empty((depth, width), dtype=torch.int32, device=dev)
    # the raw handle of the current stream: torch.cuda.current_stream()
    # builds a Stream object per call
    err = LIBRARY.load().cms_update_launch(
        flat.data_ptr(), _TOKEN_BYTES[flat.dtype],
        w.data_ptr() if w is not None else None,
        _WEIGHT_KIND[w.dtype] if w is not None else 0, out.data_ptr(), n,
        depth, width, sm_count(dev),
        torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"cms_update kernel launch failed: CUDA error "
                           f"{err} (N={n}, depth={depth}, width={width})")
    cms_counts.launches += 1
    return out


cms_counts.launches = 0
