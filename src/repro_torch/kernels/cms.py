"""Count-min sketch batch update (paper §3): CUDA kernel + plain version.

Replaces the TPU kernel ``repro/kernels/cms.py:cms_update_pallas``.  The
kernel is ``csrc/cms_update.cu``, CUDA C++ for ``sm_90a``, built with
``nvcc`` at first use into ``build/repro_torch/`` and loaded with ``ctypes``
(``kernels/_build.py``).  Its bound is memory: it must read ``4N`` bytes of
tokens (``+4N`` of weights) and write ``depth*width*4``, at 3.35 TB/s on an
H100.  The TPU version scatters with a one-hot matmul per hash row on the
MXU; the CUDA version adds one integer atomic per (token, row) into a
per-CTA shared-memory table when the table fits in shared memory, and into
the global table otherwise (see the source's header).

:func:`cms_counts` is the wrapper ``monoids.cms_update_batch`` and
``ops.cms_update`` call: on a CUDA tensor it launches the kernel (or
raises), on a CPU tensor it runs :func:`cms_counts_plain`.
``cms_counts.launches`` counts kernel launches.

Contract: ``tokens`` int32/int64 of any shape (flattened; a bucket hashes
the id's low 32 bits, as JAX's int32 -> uint32 convert does), optional
``weights`` of the same number of elements (int32; a bool mask is taken as
0/1), ``depth`` hash rows with seeds ``d``, ``width`` buckets.  The result
is a ``(depth, width)`` int32 table of exact counts.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.monoids import _uhash
from ._build import CudaLibrary, sm_count

LIBRARY = CudaLibrary("cms_update", {"cms_update_launch": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]})


def _check(tokens: torch.Tensor, depth: int, width: int,
           weights: Optional[torch.Tensor]) -> None:
    if tokens.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"tokens must be int32 or int64; got {tokens.dtype}")
    if depth < 1 or width < 1:
        raise ValueError(f"depth and width must be >= 1; got {depth}, {width}")
    if weights is not None and weights.numel() != tokens.numel():
        raise ValueError(f"weights must have one entry per token "
                         f"({tokens.numel()}); got {tuple(weights.shape)}")


def _weights_i32(weights: torch.Tensor) -> torch.Tensor:
    if weights.dtype not in (torch.bool, torch.int32):
        raise TypeError(f"weights must be int32 (or a bool mask); got "
                        f"{weights.dtype}")
    return weights.reshape(-1).to(torch.int32)


def cms_counts_plain(tokens: torch.Tensor, depth: int, width: int, *,
                     weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's contract in plain PyTorch: one ``index_add_`` per hash
    row into the flattened table."""
    _check(tokens, depth, width, weights)
    flat = tokens.reshape(-1)
    w = torch.ones_like(flat, dtype=torch.int32) if weights is None \
        else _weights_i32(weights)
    out = torch.zeros((depth * width,), dtype=torch.int32, device=flat.device)
    for d in range(depth):
        out.index_add_(0, d * width + _uhash(flat, d) % width, w)
    return out.reshape(depth, width)


def cms_counts(tokens: torch.Tensor, depth: int, width: int, *,
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Count-min counts of a token batch: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors.  Returns ``(depth, width)`` int32."""
    if tokens.device.type == "cpu":
        return cms_counts_plain(tokens, depth, width, weights=weights)
    if tokens.device.type != "cuda":
        raise ValueError(f"cms_counts runs on cuda (kernel) or cpu (plain "
                         f"version); got a {tokens.device} tensor")
    _check(tokens, depth, width, weights)
    dev = tokens.device
    if weights is not None and weights.device != dev:
        raise ValueError("tokens and weights must share a device")
    # the low 32 bits of each id: what the kernel's uint32 hash reads
    flat = tokens.reshape(-1).to(torch.int32).contiguous()
    w = None if weights is None else _weights_i32(weights).contiguous()
    out = torch.zeros((depth, width), dtype=torch.int32, device=dev)
    n = flat.numel()
    if n == 0:
        return out
    with torch.cuda.device(dev):
        err = LIBRARY.load().cms_update_launch(
            flat.data_ptr(), w.data_ptr() if w is not None else None,
            out.data_ptr(), n, depth, width, sm_count(dev),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cms_update kernel launch failed: CUDA error "
                           f"{err} (N={n}, depth={depth}, width={width})")
    cms_counts.launches += 1
    return out


cms_counts.launches = 0
