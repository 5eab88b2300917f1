"""The flash-attention backward's design dispatch and its wgmma schedule.

``backward_design`` picks the kernels ``flash_attention_bwd`` launches from
dtype, head dim and strides before the launch (never after a failure):
``wgmma`` (``csrc/flash_attention_bwd.cu``'s TMA-fed, warp-specialised
kernels) for 16-bit inputs at head dims 64 / 128 / 256 whose bases and
strides TMA takes, ``mma_sync`` for the other 16-bit inputs and
``cuda_cores`` for float32.  The second half rehearses the wgmma kernels'
schedule on the CPU: a Python mirror of the loop bounds of
``dkdv_wgmma_kernel`` and ``dq_wgmma_kernel`` (blocks of 64 rows per
consumer warpgroup, looped tiles of 64 or 128 rows, the dead-tile skip
and the unmasked whole-tile test) must visit every (query, key) pair the
forward's mask keeps exactly once per kernel, and read the lse / D
scratch only inside its ``BWD_ROW_PAD`` rows.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (BWD_ROW_PAD,
                                                 backward_design)


def _inputs(B, H, KV, Sq, Sk, d, dtype=torch.bfloat16):
    q = torch.empty((B, H, Sq, d), dtype=dtype)
    k = torch.empty((B, KV, Sk, d), dtype=dtype)
    return q, k, torch.empty_like(k), torch.empty_like(q)


# (B, H, KV, Sq, Sk, d, dtype) -> design
DESIGN_CASES = {
    "t1 at B 1": ((1, 16, 8, 1024, 1024, 128, torch.bfloat16), "wgmma"),
    "t2 d256": ((2, 4, 1, 1024, 1024, 256, torch.bfloat16), "wgmma"),
    "t3 d64": ((1, 12, 12, 1500, 1500, 64, torch.bfloat16), "wgmma"),
    "t4 Sq64 Sk1500": ((2, 12, 12, 64, 1500, 64, torch.bfloat16), "wgmma"),
    "f16 d128": ((1, 4, 2, 100, 100, 128, torch.float16), "wgmma"),
    "tiny S1": ((1, 2, 1, 1, 1, 64, torch.bfloat16), "wgmma"),
    "d40": ((2, 4, 2, 100, 100, 40, torch.bfloat16), "mma_sync"),
    "d8": ((2, 4, 2, 37, 37, 8, torch.float16), "mma_sync"),
    "d96": ((1, 2, 1, 64, 64, 96, torch.bfloat16), "mma_sync"),
    "Sk 0": ((1, 2, 1, 16, 0, 128, torch.bfloat16), "mma_sync"),
    "Sq 0": ((1, 2, 1, 0, 16, 128, torch.bfloat16), "mma_sync"),
    "t5 f32": ((2, 4, 2, 100, 100, 40, torch.float32), "cuda_cores"),
    "f32 d128": ((1, 16, 8, 128, 128, 128, torch.float32), "cuda_cores"),
}


@pytest.mark.parametrize("case", sorted(DESIGN_CASES))
def test_design_by_dtype_and_head_dim(case):
    shape, want = DESIGN_CASES[case]
    assert backward_design(*_inputs(*shape)) == want


def test_design_reads_the_models_strided_views():
    """The model hands (B, S, heads, d) projections over as transposed
    views: 16-byte head and row strides, so TMA takes them."""
    x = torch.empty((2, 40, 16 + 2 * 8, 128), dtype=torch.bfloat16)
    q = x[:, :, :16].transpose(1, 2)
    k = x[:, :, 16:24].transpose(1, 2)
    v = x[:, :, 24:].transpose(1, 2)
    assert q.stride() == (40 * 32 * 128, 128, 32 * 128, 1)
    assert backward_design(q, k, v, torch.empty_like(q)) == "wgmma"


@pytest.mark.parametrize("where", ["q", "k", "v", "do"])
def test_design_unaligned_base_takes_mma_sync(where):
    """A base 2 bytes off a 16-byte boundary is no TMA source."""
    t = dict(zip(("q", "k", "v", "do"), _inputs(1, 4, 2, 70, 70, 64)))
    wide = torch.empty(t[where].shape[:-1] + (65,), dtype=torch.bfloat16)
    t[where] = wide[..., 1:]
    assert t[where].data_ptr() % 16 == 2
    assert backward_design(t["q"], t["k"], t["v"], t["do"]) == "mma_sync"


def test_design_unaligned_row_stride_takes_mma_sync():
    """A row stride of 68 bf16 (136 bytes) is no TMA stride; a size-1
    axis's stride is never stepped and does not count."""
    q, k, v, do = _inputs(1, 4, 2, 70, 70, 64)
    rows = torch.empty((1, 2, 70, 68), dtype=torch.bfloat16)[..., :64]
    assert backward_design(q, rows, v, do) == "mma_sync"
    one = torch.empty((1, 1, 70, 64), dtype=torch.bfloat16).as_strided(
        (1, 1, 70, 64), (3, 5, 64, 1))
    q1 = torch.empty((1, 2, 70, 64), dtype=torch.bfloat16)
    assert backward_design(q1, one, one, torch.empty_like(q1)) == "wgmma"


# -- the wgmma kernels' schedule, mirrored from flash_attention_bwd.cu -------

TILE = 64


def _rows(d):
    """Hop::R: 64 rows per consumer warpgroup, two below d 256."""
    return TILE * (1 if d == 256 else 2)


def _looped(d):
    """Hop<D>::BL, the rows of a looped query (dK / dV) or key (dQ) tile:
    128 at d 64, else 64."""
    return 128 if d == 64 else 64


def _keep(Sq, Sk, causal, window):
    qp = np.arange(Sq)[:, None]
    kp = np.arange(Sk)[None, :]
    keep = np.ones((Sq, Sk), dtype=bool)
    if causal:
        keep &= kp <= qp
        if window:
            keep &= kp > qp - window
    return keep


def _visit(count, keep, q0, nq, k0, nk, whole):
    """Count the kept pairs of the nq x nk tile at (q0, k0); a tile the
    kernel calls whole must keep all of its entries."""
    tile = keep[q0:q0 + nq, k0:k0 + nk]
    if whole:
        assert tile.shape == (nq, nk) and tile.all()
    count[q0:q0 + nq, k0:k0 + nk] += tile


def _dkdv_schedule(Sq, Sk, d, causal, window, keep):
    """dkdv_wgmma_kernel's loops for one (batch, KV head, query head)."""
    R, BL, W = _rows(d), _looped(d), window or 0
    count = np.zeros(keep.shape, dtype=np.int64)
    for k0 in range(0, Sk, R):
        q_lo = k0 if causal else 0
        q_hi = min(Sq, k0 + R - 1 + W) if W > 0 else Sq
        t_lo = q_lo // BL
        nt = (q_hi + BL - 1) // BL - t_lo if q_hi > q_lo else 0
        for t in range(t_lo, t_lo + nt):
            q0 = t * BL
            assert q0 + BL <= -(-Sq // BWD_ROW_PAD) * BWD_ROW_PAD
            for kw in range(k0, k0 + R, TILE):
                dead = kw >= Sk or (causal and kw > q0 + BL - 1) or \
                    (W > 0 and kw + TILE - 1 <= q0 - W)
                if dead:
                    continue
                whole = q0 + BL <= Sq and kw + TILE <= Sk and \
                    (not causal or kw + TILE - 1 <= q0) and \
                    (W == 0 or kw > q0 + BL - 1 - W)
                _visit(count, keep, q0, BL, kw, TILE, whole)
    return count


def _dq_schedule(Sq, Sk, d, causal, window, keep):
    """dq_wgmma_kernel's loops for one (batch, head): blocks in reverse
    query order (heaviest first under the causal mask)."""
    R, BL, W = _rows(d), _looped(d), window or 0
    nqb = -(-Sq // R)
    count = np.zeros(keep.shape, dtype=np.int64)
    for by in range(nqb):
        q0 = (nqb - 1 - by) * R
        assert q0 + R <= -(-Sq // BWD_ROW_PAD) * BWD_ROW_PAD
        k_lo = max(0, q0 - W + 1) if W > 0 else 0
        k_hi = min(Sk, q0 + R) if causal else Sk
        t_lo = k_lo // BL
        n = (k_hi + BL - 1) // BL - t_lo if k_hi > k_lo else 0
        for t in range(t_lo, t_lo + n):
            kt = t * BL
            for qw in range(q0, q0 + R, TILE):
                dead = qw >= Sq or (causal and kt > qw + TILE - 1) or \
                    (W > 0 and kt + BL - 1 <= qw - W)
                if dead:
                    continue
                whole = qw + TILE <= Sq and kt + BL <= Sk and \
                    (not causal or kt + BL - 1 <= qw) and \
                    (W == 0 or kt > qw + TILE - 1 - W)
                _visit(count, keep, qw, TILE, kt, BL, whole)
    return count


# (Sq, Sk, d, causal, window): t1-t4 and the card tests' edges
SCHEDULE_CASES = [
    (1024, 1024, 128, True, None),
    (1024, 1024, 256, True, 512),
    (1500, 1500, 64, False, None),
    (64, 1500, 64, False, None),
    (100, 100, 64, True, None),
    (130, 130, 128, True, None),
    (300, 300, 128, True, None),
    (200, 77, 128, False, None),
    (1100, 1100, 256, True, 512),
    (200, 200, 256, True, 48),
    (70, 70, 128, True, 3),
    (70, 70, 128, True, 1),
    (50, 170, 64, False, None),
    (130, 70, 256, False, None),
    (40, 90, 128, True, None),
    (1, 1, 64, True, None),
]


@pytest.mark.parametrize("kernel", ["dkdv", "dq"])
@pytest.mark.parametrize("case", SCHEDULE_CASES,
                         ids=[f"Sq{c[0]}-Sk{c[1]}-d{c[2]}-"
                              f"{'causal' if c[3] else 'full'}-w{c[4]}"
                              for c in SCHEDULE_CASES])
def test_wgmma_schedule_visits_each_kept_pair_once(kernel, case):
    Sq, Sk, d, causal, window = case
    keep = _keep(Sq, Sk, causal, window)
    schedule = _dkdv_schedule if kernel == "dkdv" else _dq_schedule
    count = schedule(Sq, Sk, d, causal, window, keep)
    assert np.array_equal(count, keep.astype(np.int64))


# ---------------------------------------------------------------------------
# the plain backward at v's head dim dv != d (MLA)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,H,KV,Sq,Sk,d,dv,causal,window", [
    (2, 4, 4, 37, 37, 24, 16, True, None),     # MLA's smoke widths
    (1, 4, 2, 33, 33, 40, 8, True, 5),         # GQA, a window
    (1, 2, 1, 20, 30, 12, 20, False, None),    # dv > d, Sq != Sk
    (1, 2, 2, 16, 16, 192, 128, True, None)])  # MLA's full widths
def test_backward_plain_at_dv_matches_autograd(B, H, KV, Sq, Sk, d, dv,
                                               causal, window):
    """``flash_attention_backward_plain`` with v, o, do at ``dv`` columns
    against ``torch.autograd`` of plain float64 softmax attention (top-left
    causal, window, GQA by repeated heads) at 1e-5."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_plain, flash_attention_plain)

    gen = torch.Generator().manual_seed(Sq + d + dv)
    q = torch.randn((B, H, Sq, d), generator=gen)
    k = torch.randn((B, KV, Sk, d), generator=gen)
    v = torch.randn((B, KV, Sk, dv), generator=gen)
    do = torch.randn((B, H, Sq, dv), generator=gen)
    o = flash_attention_plain(q, k, v, causal=causal, window=window)
    got = flash_attention_backward_plain(q, k, v, o, do, causal=causal,
                                         window=window)
    assert [tuple(g.shape) for g in got] == [tuple(q.shape), tuple(k.shape),
                                             tuple(v.shape)]
    q2, k2, v2 = (t.double().requires_grad_() for t in (q, k, v))
    kk, vv = k2.repeat_interleave(H // KV, 1), v2.repeat_interleave(H // KV,
                                                                     1)
    s = q2 @ kk.transpose(-1, -2) / np.sqrt(d)
    if causal:
        qp, kp = torch.arange(Sq)[:, None], torch.arange(Sk)[None]
        keep = kp <= qp
        if window is not None:
            keep &= kp > qp - window
        s = s.masked_fill(~keep, -np.inf)
    out = torch.softmax(s, -1) @ vv
    np.testing.assert_allclose(o.numpy(), out.detach().numpy(), rtol=1e-5,
                               atol=1e-5)
    want = torch.autograd.grad(out, (q2, k2, v2), do.double())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_design_of_the_padded_mla_backward():
    """The card pads v, o and do of MLA's d 192 / dv 128 to 192 columns:
    192 is no wgmma head dim, so the bf16 backward takes ``mma_sync``."""
    q, k, _, do = _inputs(1, 4, 4, 64, 64, 192)
    assert backward_design(q, k, torch.empty_like(k), do) == "mma_sync"
