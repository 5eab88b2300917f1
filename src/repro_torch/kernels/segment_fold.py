"""Keyed semiring fold (the paper's combiner): CUDA kernel + plain version.

Replaces the TPU kernel ``repro/kernels/segment_fold.py:segment_fold_pallas``.
The kernel is ``csrc/segment_fold.cu``, CUDA C++ for ``sm_90a``, built with
``nvcc`` at first use into ``build/repro_torch/`` (git-ignored) and loaded
with ``ctypes`` (``kernels/_build.py``).  Its bound is memory: it must read ``N*D*elt + 4N`` bytes
(+ ``N`` for the mask) and write ``S*W*4``, at 3.35 TB/s on an H100.  The
TPU version scatters with a one-hot matmul on the MXU; the CUDA version
gives each lane its own row, combines the rows of a run of equal ids in the
warp, and folds each run with one native atomic (sign-split integer atomics
for max / min) into a per-CTA shared-memory table when the ``(S, W)`` table
fits in shared memory, and into the global table otherwise.  A small fold
(the decode step's) is one CTA and one launch (see the source's header).

:func:`segment_fold` is the wrapper the planner's kernel tier calls: on a
CUDA tensor it launches the kernel (or raises), on a CPU tensor it runs
:func:`segment_fold_plain`, the same contract in plain PyTorch.
``segment_fold.launches`` counts kernel launches.

Contract (that of ``segment_fold_pallas`` and its ``_finish_dtype``):
values ``(N, D)`` in f32/bf16/f16/int8/uint8/int16/int32, ``seg_ids`` ``(N,)``
int32, ``num_segments`` S, semiring in ``SEMIRINGS``, an optional ``(N,)``
bool ``valid_mask``.  The result is ``(S, D)`` float32 for float inputs and
the input dtype for integer inputs (accumulated in float32, exact below
2**24); empty max/min segments hold -inf/+inf (floats) or iinfo.min/max
(integers).  ``with_count`` (sum only) returns ``(sums, counts)`` with f32
counts from one launch.  Ids outside ``[0, S)`` and masked rows contribute
nothing.  Max/min propagate NaN.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._build import NVCC_FLAGS, CudaLibrary, sm_count  # noqa: F401

SEMIRINGS = ("sum", "max", "min")

_SEMIRING_CODE = {"sum": 0, "max": 1, "min": 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.int8: 3, torch.uint8: 4, torch.int16: 5, torch.int32: 6}
KERNEL_DTYPES = tuple(_DTYPE_CODE)

LIBRARY = CudaLibrary("segment_fold", {"segment_fold_launch": [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]})
library_path = LIBRARY.library_path


# ---------------------------------------------------------------------------
# contract helpers shared by the kernel and the plain version
# ---------------------------------------------------------------------------

def _check(values: torch.Tensor, seg_ids: torch.Tensor, num_segments: int,
           semiring: str, with_count: bool, valid_mask) -> None:
    if semiring not in SEMIRINGS:
        raise ValueError(f"unknown semiring {semiring!r}; one of {SEMIRINGS}")
    if with_count and semiring != "sum":
        raise ValueError("with_count requires the additive semiring")
    if values.dim() != 2 or values.shape[1] < 1:
        raise ValueError(f"values must be (N, D) with D >= 1; got "
                         f"{tuple(values.shape)}")
    if values.dtype not in _DTYPE_CODE:
        raise TypeError(f"segment_fold takes {[str(d) for d in KERNEL_DTYPES]}"
                        f"; got {values.dtype}")
    n = values.shape[0]
    if tuple(seg_ids.shape) != (n,):
        raise ValueError(f"seg_ids must be ({n},); got {tuple(seg_ids.shape)}")
    if valid_mask is not None and tuple(valid_mask.shape) != (n,):
        raise ValueError(f"valid_mask must be ({n},); got "
                         f"{tuple(valid_mask.shape)}")
    if num_segments < 1:
        raise ValueError("num_segments must be >= 1")


def _finish_dtype(out: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Cast the float32 table back for integer inputs, saturating as XLA's
    convert does: empty max/min segments (+-inf) become the integer
    identity iinfo.min/max (float64 holds int32's bounds exactly, float32
    does not)."""
    if dtype.is_floating_point:
        return out
    info = torch.iinfo(dtype)
    return out.to(torch.float64).clamp(info.min, info.max).to(dtype)


def _split(out: torch.Tensor, dtype: torch.dtype, with_count: bool):
    if with_count:
        return _finish_dtype(out[:, :-1], dtype), out[:, -1]
    return _finish_dtype(out, dtype)


# ---------------------------------------------------------------------------
# the plain version and the kernel wrapper
# ---------------------------------------------------------------------------

def segment_fold_plain(values: torch.Tensor, seg_ids: torch.Tensor,
                       num_segments: int, *, semiring: str = "sum",
                       with_count: bool = False,
                       valid_mask: Optional[torch.Tensor] = None):
    """The kernel's contract in plain PyTorch (``index_add_`` /
    ``scatter_reduce_`` into a table with one spare row that takes the
    rows the kernel drops)."""
    _check(values, seg_ids, num_segments, semiring, with_count, valid_mask)
    n, S = values.shape[0], num_segments
    keep = (seg_ids >= 0) & (seg_ids < S)
    if valid_mask is not None:
        keep = keep & valid_mask.to(torch.bool)
    ids = torch.where(keep, seg_ids.long(), S)
    vals = values.to(torch.float32)
    if with_count:
        vals = torch.cat([vals, vals.new_ones((n, 1))], dim=1)
    w = vals.shape[1]
    if semiring == "sum":
        out = vals.new_zeros((S + 1, w)).index_add_(0, ids, vals)
    else:
        fill = float("-inf") if semiring == "max" else float("inf")
        out = vals.new_full((S + 1, w), fill).scatter_reduce_(
            0, ids[:, None].expand(n, w), vals,
            reduce="amax" if semiring == "max" else "amin", include_self=True)
    return _split(out[:S], values.dtype, with_count)


def segment_fold(values: torch.Tensor, seg_ids: torch.Tensor,
                 num_segments: int, *, semiring: str = "sum",
                 with_count: bool = False,
                 valid_mask: Optional[torch.Tensor] = None):
    """Keyed semiring fold: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Returns the ``(S, D)`` table, or
    ``(sums, counts)`` with ``with_count``."""
    if values.device.type == "cpu":
        return segment_fold_plain(values, seg_ids, num_segments,
                                  semiring=semiring, with_count=with_count,
                                  valid_mask=valid_mask)
    if values.device.type != "cuda":
        raise ValueError(f"segment_fold runs on cuda (kernel) or cpu (plain "
                         f"version); got a {values.device} tensor")
    _check(values, seg_ids, num_segments, semiring, with_count, valid_mask)
    dev = values.device
    if seg_ids.device != dev or (valid_mask is not None
                                 and valid_mask.device != dev):
        raise ValueError("values, seg_ids and valid_mask must share a device")
    if seg_ids.dtype != torch.int32:
        raise TypeError(f"seg_ids must be int32; got {seg_ids.dtype}")
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return segment_fold(values, seg_ids, num_segments,
                                semiring=semiring, with_count=with_count,
                                valid_mask=valid_mask)
    values = values.contiguous()
    seg_ids = seg_ids.contiguous()
    mask = valid_mask
    if mask is not None:     # .to() costs a dispatch even when it is a no-op
        mask = (mask if mask.dtype == torch.bool else mask.to(torch.bool)
                ).contiguous()
    n, d = values.shape
    out = torch.empty((num_segments, d + int(with_count)),
                      dtype=torch.float32, device=dev)
    # the raw handle of the current stream: torch.cuda.current_stream()
    # builds a Stream object per call
    err = LIBRARY.load().segment_fold_launch(
        values.data_ptr(), _DTYPE_CODE[values.dtype], seg_ids.data_ptr(),
        mask.data_ptr() if mask is not None else None, out.data_ptr(),
        n, d, num_segments, _SEMIRING_CODE[semiring], int(with_count),
        sm_count(dev), torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"segment_fold kernel launch failed: CUDA error "
                           f"{err} (N={n}, D={d}, S={num_segments}, "
                           f"{values.dtype}, {semiring})")
    segment_fold.launches += 1
    return _split(out, values.dtype, with_count)


segment_fold.launches = 0
