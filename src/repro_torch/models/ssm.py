"""Recurrent blocks: Mamba (jamba), mLSTM and sLSTM (xlstm).

The port of ``repro/models/ssm.py``.  A linear recurrence
``h_t = a_t * h_{t-1} + b_t`` is a composition of affine maps, and affine
maps form a monoid (``core.monoids.affine_scan``): that is why the selective
scan can be re-bracketed.  Mamba's full-sequence form is chunked as the
JAX package's is: inside a chunk the prefix compositions come from
:func:`affine_scan`, an inclusive log-step scan over the chunk axis with the
monoid's combine (where the JAX package runs ``lax.associative_scan``; the
two bracket differently, so they agree to rounding), and a float32 carry
crosses the chunks.  :func:`affine_scan_loop`, the sequential fold, is its
plain version and oracle.  mLSTM's full-sequence form is the chunkwise
linear-attention form with a ``(C, n)`` carry, sLSTM's a loop over the
sequence.

Each ``*_decode(p, cfg, x, cache)`` advances one token and writes the new
state into ``cache``'s own tensors (``copy_`` and in-place updates), so a
decode step captured in a CUDA graph keeps its state where the graph reads
it; it reads nothing back to the host.  Where bf16 rounds follows each form
of the JAX package as it stands (``_F32_CHAINS = False``): ``mamba_mix``
adds the ``D_skip`` term in the activation dtype, ``mamba_decode`` in
float32, and both stream the chunk or step output in the activation dtype
while the carried states stay float32.

Shapes: x (B, S, D); Mamba's inner width ``cfg.d_inner``; mLSTM's inner
width ``DI = int(mlstm_proj_factor * D)`` with head dim ``DI // H`` (not
``cfg.head_dim``); sLSTM's head dim ``D // H``.

Under a mesh (an open ``dist.sharding`` rules scope) every block runs on
this rank's blocks of its leaves (:data:`AXES` names their dimensions) and
of its state (``CACHE_AXES``), and reads each cut from the rules, never
assuming it.  Mamba: ``w_in`` is cut by its halves (``Packed``), so x and
the gate z arrive as this rank's channels; the conv, ``dt``, ``A_log`` and
``D_skip`` are per channel; ``w_bcdt``'s rows are cut, so B, C and dt's
low-rank input are partial sums, summed over the axis once a layer before
the split; ``w_out`` is row-parallel.  mLSTM: ``wq`` / ``wk`` / ``wv`` and
``w_if`` are cut on their ``d_inner`` rows (the first dimension wins), so
q, k, v and the gates are partial sums: one ``psum`` a layer of the four
packed side by side (every rank then holds every head's, and slices its
own; a reduce-scatter over heads would move half the bytes, but no
layout of the four packs each rank's heads contiguously, and the psum is
differentiable as it is), then ``b_if``, replicated, is added once; the
cell runs on the state's heads, and the norm over all heads sums its
squares over the axis.  sLSTM: ``w_x``'s columns are head-major (``xg``
reshapes to (B, H, 4 hd)), so a contiguous cut of them is a cut by heads,
which matches ``w_h``, ``b`` and the state; h is gathered over the axis
before the FFN, whose ``embed`` rows are replicated, and the FFN's
``w_up`` / ``w_down`` are cut when the axis divides their width.

Under grad (training on a mesh) every replicated value that enters a cut
product goes through ``dist.enter``, whose backward sums the ranks'
partial cotangents: x into ``w_in`` / ``w_up`` / ``w_x``, Mamba's summed
B, C and dt input into the rank's channels, mLSTM's summed q, k, v and
gates and its ``b_if`` into the state's heads, sLSTM's gathered h into a
cut FFN.  ``dist.sharding.reblock`` transposes itself: where it gathers,
its backward keeps this rank's block; where it cuts a replicated value,
its backward gathers the blocks' cotangents.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import dist
from ..core.monoids import affine_scan as _affine_monoid
from ..dist import sharding as shd
from ..dist.sharding import Packed
from .common import (ModelConfig, cache_cut, cache_leaf, dense, rms_norm,
                     row_parallel)

RECURRENT_BLOCKS = ("mamba", "mlstm", "slstm")

# the logical axes of each block's leaves (the names of the JAX package's
# ParamBuilder); w_in / w_up pack x and the gate z, each d_inner wide
AXES = {
    "mamba": {"A_log": ("d_inner", "d_state"), "D_skip": ("d_inner",),
              "conv_b": ("d_inner",), "conv_w": (None, "d_inner"),
              "dt_bias": ("d_inner",), "w_bcdt": ("d_inner", None),
              "w_dt": (None, "d_inner"),
              "w_in": ("embed", Packed("d_inner", 2)),
              "w_out": ("d_inner", "embed")},
    "mlstm": {"b_if": (None,), "ln_g": ("d_inner",),
              "w_down": ("d_inner", "embed"), "w_if": ("d_inner", None),
              "w_up": ("embed", Packed("d_inner", 2)),
              "wq": ("d_inner", "heads", "head_dim"),
              "wk": ("d_inner", "heads", "head_dim"),
              "wv": ("d_inner", "heads", "head_dim")},
    "slstm": {"b": ("d_inner",), "w_down": ("mlp", "embed"),
              "w_h": ("heads", "head_dim", None), "w_up": ("embed", "mlp"),
              "w_x": ("embed", "d_inner")},
}


def _cut(block: str, leaf: str, shape, dim: int) -> Tuple[str, ...]:
    """The mesh axes dimension ``dim`` of ``block``'s leaf (global
    ``shape``) is cut over in the active scope; () outside one."""
    return shd.cut(AXES[block][leaf], shape, dim)


# ---------------------------------------------------------------------------
# the affine-map scan
# ---------------------------------------------------------------------------

def affine_scan(a: torch.Tensor, b: torch.Tensor,
                dim: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive prefix compositions of the affine maps ``h -> a_t h + b_t``
    along ``dim``: ``(A_t, B_t)`` with ``h_t = A_t h_{-1} + B_t``.  A
    log-step (Hillis-Steele) scan: round ``r`` combines every element with
    the one ``2**r`` before it (``affine_scan``'s combine, earlier map
    first), ``ceil(log2 n)`` rounds."""
    n = a.shape[dim]
    step = 1
    while step < n:
        earlier = (a.narrow(dim, 0, n - step), b.narrow(dim, 0, n - step))
        later = (a.narrow(dim, step, n - step), b.narrow(dim, step, n - step))
        ca, cb = _affine_monoid.combine(earlier, later)
        a = torch.cat([a.narrow(dim, 0, step), ca], dim)
        b = torch.cat([b.narrow(dim, 0, step), cb], dim)
        step *= 2
    return a, b


def affine_scan_loop(a: torch.Tensor, b: torch.Tensor,
                     dim: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`affine_scan`'s plain version: the sequential fold
    ``A_t = a_t A_{t-1}``, ``h_t = a_t h_{t-1} + b_t`` from the identity."""
    A, h = torch.ones_like(a.select(dim, 0)), torch.zeros_like(b.select(dim, 0))
    As, hs = [], []
    for t in range(a.shape[dim]):
        a_t = a.select(dim, t)
        A, h = a_t * A, a_t * h + b.select(dim, t)
        As.append(A)
        hs.append(h)
    return torch.stack(As, dim), torch.stack(hs, dim)


def _chunk(S: int, chunk_size: int) -> int:
    """The chunk length: ``chunk_size`` (at most S), halved until it
    divides S."""
    cs = min(chunk_size, S)
    while S % cs:
        cs //= 2
    return cs


# ---------------------------------------------------------------------------
# Mamba (selective SSM): jamba's sequence mixer
# ---------------------------------------------------------------------------

def _dt_rank(cfg: ModelConfig) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def init_mamba(cfg: ModelConfig, normal, ones, zeros) -> Dict:
    D, DI, N, K = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.d_conv
    R = _dt_rank(cfg)
    return {"w_in": normal((D, 2 * DI), D),          # x and the gate z
            "conv_w": normal((K, DI), K), "conv_b": zeros((DI,)),
            "w_bcdt": normal((DI, 2 * N + R), DI),
            "w_dt": normal((R, DI), R), "dt_bias": zeros((DI,)),
            "A_log": zeros((DI, N)), "D_skip": ones(DI),
            "w_out": normal((DI, D), DI)}


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d.  x (B, S, DI); w (K, DI); state (B, K-1, DI)
    -> (y, the last K-1 inputs: the next call's state)."""
    K, S = w.shape[0], x.shape[1]
    if state is None:
        state = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)                    # (B, S+K-1, DI)
    y = sum(xp[:, i:i + S] * w[i] for i in range(K))
    y = y + b
    return y, (xp[:, -(K - 1):] if K > 1 else state)


def _mamba_scan_inputs(p: Dict, cfg: ModelConfig, xc: torch.Tensor):
    """Post-conv activations (B, S, DI) (this rank's channels) -> the
    discretised (abar, bbar_x, C), float32, abar and bbar_x (B, S, DI, N);
    B, C and dt's input summed over the axes ``w_bcdt``'s rows are cut
    over."""
    N = cfg.d_state
    cut = _cut("mamba", "w_bcdt", (cfg.d_inner, 2 * N + _dt_rank(cfg)), 0)
    # summed over the channels' ranks, then read by this rank's channels
    bcdt = dist.enter(row_parallel(xc, p["w_bcdt"], cut), cut)
    Bm, Cm, dt_in = bcdt[..., :N], bcdt[..., N:2 * N], bcdt[..., 2 * N:]
    dt = F.softplus(dense(dt_in, p["w_dt"]).to(torch.float32)
                    + p["dt_bias"].to(torch.float32))    # (B, S, DI)
    A = -torch.exp(p["A_log"].to(torch.float32))          # (DI, N)
    abar = torch.exp(dt[..., None] * A)
    bbar_x = (dt * xc.to(torch.float32))[..., None] * \
        Bm[..., None, :].to(torch.float32)
    return abar, bbar_x, Cm.to(torch.float32)


def mamba_mix(p: Dict, cfg: ModelConfig, x: torch.Tensor, *,
              chunk_size: int = 256) -> torch.Tensor:
    """The full-sequence Mamba block: chunks of ``chunk_size`` (halved until
    they divide S), prefix compositions inside a chunk by
    :func:`affine_scan`, a float32 carry across chunks."""
    B, S, _ = x.shape
    xi, z = _mamba_in(p, cfg, x)
    xc, _ = _causal_conv(xi, p["conv_w"].to(xi.dtype),
                         p["conv_b"].to(xi.dtype))
    xc = F.silu(xc)
    abar, bbar_x, Cm = _mamba_scan_inputs(p, cfg, xc)
    cs = _chunk(S, chunk_size)
    h = torch.zeros((B, xi.shape[-1], cfg.d_state), dtype=torch.float32,
                    device=x.device)
    ys = []
    for c0 in range(0, S, cs):
        span = slice(c0, c0 + cs)
        a_pref, bx_pref = affine_scan(abar[:, span], bbar_x[:, span])
        h_all = a_pref * h[:, None] + bx_pref             # (B, cs, DI, N)
        # the chunk output streams in the model dtype; the carry stays f32
        ys.append(torch.einsum("bsdn,bsn->bsd", h_all, Cm[:, span])
                  .to(x.dtype))
        h = h_all[:, -1]
    y = torch.cat(ys, dim=1) + p["D_skip"].to(x.dtype) * xc
    return _mamba_out(p, cfg, y * F.silu(z))


def _mamba_in(p: Dict, cfg: ModelConfig, x: torch.Tensor):
    """(x, the gate z), each (B, S, this rank's channels): ``w_in`` packs
    x's columns, then z's (cut by its halves under a mesh)."""
    cut = _cut("mamba", "w_in", (cfg.d_model, 2 * cfg.d_inner), 1)
    xz = dense(dist.enter(x, cut), p["w_in"])
    DI = xz.shape[-1] // 2
    return xz[..., :DI], xz[..., DI:]


def _mamba_out(p: Dict, cfg: ModelConfig, y: torch.Tensor) -> torch.Tensor:
    cut = _cut("mamba", "w_out", (cfg.d_inner, cfg.d_model), 0)
    return row_parallel(y, p["w_out"], cut)


def init_mamba_cache(cfg: ModelConfig, batch: int, device) -> Dict:
    """Zeroed Mamba state: this rank's channels under a mesh."""
    return {"ssm_h": cache_leaf("ssm_h", (batch, cfg.d_inner, cfg.d_state),
                                torch.float32, device),
            "ssm_conv": cache_leaf("ssm_conv",
                                   (batch, cfg.d_conv - 1, cfg.d_inner),
                                   cfg.dtype, device)}


def mamba_decode(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                 cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One token (B, 1, D): the conv window and ``h`` advance in place."""
    xi, z = _mamba_in(p, cfg, x)
    xc, conv_state = _causal_conv(xi, p["conv_w"].to(xi.dtype),
                                  p["conv_b"].to(xi.dtype), cache["ssm_conv"])
    xc = F.silu(xc)
    abar, bbar_x, Cm = _mamba_scan_inputs(p, cfg, xc)     # (B, 1, DI, N)
    h = abar[:, 0] * cache["ssm_h"] + bbar_x[:, 0]
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0])[:, None]
    y = y + p["D_skip"].to(torch.float32) * xc.to(torch.float32)
    y = y.to(x.dtype) * F.silu(z)
    cache["ssm_h"].copy_(h)
    cache["ssm_conv"].copy_(conv_state)
    return _mamba_out(p, cfg, y), cache


# ---------------------------------------------------------------------------
# mLSTM: matrix-memory LSTM (xlstm), chunkwise linear-attention form
# ---------------------------------------------------------------------------

def _mlstm_inner(cfg: ModelConfig) -> int:
    return int(cfg.mlstm_proj_factor * cfg.d_model)


def init_mlstm(cfg: ModelConfig, normal, ones, zeros) -> Dict:
    D, DI, H = cfg.d_model, _mlstm_inner(cfg), cfg.num_heads
    hd = DI // H
    return {"w_up": normal((D, 2 * DI), D),            # x and the gate z
            "wq": normal((DI, H, hd), DI), "wk": normal((DI, H, hd), DI),
            "wv": normal((DI, H, hd), DI),
            "w_if": normal((DI, 2 * H), DI),           # input / forget gates
            "b_if": zeros((2 * H,)),
            "ln_g": ones(DI),                          # norm over all heads
            "w_down": normal((DI, D), DI)}


def _mlstm_heads(cfg: ModelConfig) -> Tuple[int, int, Tuple[str, ...]]:
    """(first head, heads, the mesh axes they are cut over) of the mLSTM
    state this rank holds (all heads outside a mesh)."""
    DI, H = _mlstm_inner(cfg), cfg.num_heads
    hd = DI // H
    cut = cache_cut("ml_C", (1, H, hd, hd), 1)
    return shd.block_start(cut, H), \
        (H // dist.axis_size(cut) if cut else H), cut


def _mlstm_qkv(p: Dict, cfg: ModelConfig, xi: torch.Tensor):
    """-> q, k / sqrt(hd), v (B, S, Hl, hd) in xi's dtype, and the float32
    log-sigmoid input and forget gates (B, S, Hl), of the state's heads.
    ``xi`` is this rank's ``d_inner`` block when the projections' rows are
    cut: their products are then summed over the axes in one ``psum``."""
    DI, H = _mlstm_inner(cfg), cfg.num_heads
    hd = DI // H
    names = ("wq", "wk", "wv", "w_if")
    cut = _cut("mlstm", "wq", (DI, H, hd), 0)
    h0, n, hcut = _mlstm_heads(cfg)
    if cut:
        f32 = torch.float32
        part = torch.cat([torch.matmul(xi.to(f32), p[w].to(f32).reshape(
            p[w].shape[0], -1)) for w in names], dim=-1)
        # every head's, read by this rank's heads
        whole = dist.enter(dist.psum(part, cut), hcut).to(xi.dtype)
        q, k, v, g = torch.split(whole, [H * hd] * 3 + [2 * H], dim=-1)
        q, k, v = (t.unflatten(-1, (H, hd)) for t in (q, k, v))
    else:
        q, k, v, g = dist.enter(tuple(dense(xi, p[w]) for w in names), hcut)
    gates = g + dist.enter(p["b_if"], hcut).to(xi.dtype)
    q, k, v = (t[:, :, h0:h0 + n] for t in (q, k, v))
    logi = F.logsigmoid(gates[..., h0:h0 + n].to(torch.float32))
    logf = F.logsigmoid(gates[..., H + h0:H + h0 + n].to(torch.float32))
    return q, k / math.sqrt(hd), v, logi, logf


def _mlstm_up(p: Dict, cfg: ModelConfig, x: torch.Tensor):
    """(xi, the gate z), each (B, S, this rank's d_inner): ``w_up`` packs
    xi's columns, then z's (cut by its halves under a mesh)."""
    cut = _cut("mlstm", "w_up", (cfg.d_model, 2 * _mlstm_inner(cfg)), 1)
    up = dense(dist.enter(x, cut), p["w_up"])
    DI = up.shape[-1] // 2
    return up[..., :DI], up[..., DI:]


def _mlstm_out(p: Dict, cfg: ModelConfig, h: torch.Tensor,
               z: torch.Tensor) -> torch.Tensor:
    """The state's heads' output h (B, S, Hl * hd) -> (B, S, D): h moved to
    ``ln_g``'s ``d_inner`` block (the heads' own under the serve rules),
    normed over every head, gated by z and projected by ``w_down``, summed
    over the axes its rows are cut over."""
    DI = _mlstm_inner(cfg)
    _, _, hcut = _mlstm_heads(cfg)
    dcut = _cut("mlstm", "ln_g", (DI,), 0)
    h = shd.reblock(h, -1, hcut, dcut)
    h = rms_norm(h, p["ln_g"], cfg.norm_eps, axes=dcut) * F.silu(z)
    return row_parallel(h, p["w_down"],
                        _cut("mlstm", "w_down", (DI, cfg.d_model), 0))


def mlstm_mix(p: Dict, cfg: ModelConfig, x: torch.Tensor, *,
              chunk_size: int = 128) -> torch.Tensor:
    """Chunkwise mLSTM: per head ``C_t = f_t C_{t-1} + i_t k_t v_t^T``,
    ``n_t = f_t n_{t-1} + i_t k_t``, ``h_t = q_t C_t / max(|q_t n_t|, 1)``;
    inside a chunk the masked decayed scores, across chunks the float32
    ``(C, n)`` carry read as ``exp(F_t) q_t . C``."""
    B, S, _ = x.shape
    xi, z = _mlstm_up(p, cfg, x)
    q, k, v, logi, logf = _mlstm_qkv(p, cfg, xi)
    Hl, hd = q.shape[2], q.shape[3]
    cs = _chunk(S, chunk_size)
    f32 = torch.float32
    C = torch.zeros((B, Hl, hd, hd), dtype=f32, device=x.device)
    n = torch.zeros((B, Hl, hd), dtype=f32, device=x.device)
    keep = torch.tril(torch.ones((cs, cs), dtype=torch.bool,
                                 device=x.device))[None, :, :, None]
    hs = []
    for c0 in range(0, S, cs):
        span = slice(c0, c0 + cs)
        qi, ki, vi = (t[:, span].to(f32) for t in (q, k, v))
        li = logi[:, span]
        Fc = torch.cumsum(logf[:, span], dim=1)          # in-chunk decay
        # inter-chunk: exp(F_t) q_t . C_prev
        qf = qi * torch.exp(Fc)[..., None]
        h_inter = torch.einsum("bshk,bhkv->bshv", qf, C)
        n_inter = torch.einsum("bshk,bhk->bsh", qf, n)
        # intra-chunk: masked decayed scores (B, t, s, H)
        dec = Fc[:, :, None, :] - Fc[:, None, :, :] + li[:, None, :, :]
        # exp(-inf) = 0 above the diagonal: there dec grows with the decay
        # and exp(dec) can overflow, whose 0 x inf would be a NaN gradient
        w = torch.exp(dec.masked_fill(~keep, -math.inf))
        scores = torch.einsum("bthk,bshk->btsh", qi, ki) * w
        h = h_inter + torch.einsum("btsh,bshv->bthv", scores, vi)
        nq = n_inter + scores.sum(dim=2)
        h = h / torch.clamp(nq.abs(), min=1.0)[..., None]
        # the carry at the chunk's end
        Fe = Fc[:, -1]                                   # (B, H)
        decay_e = torch.exp(Fe[:, None] - Fc + li)       # (B, cs, H)
        C = C * torch.exp(Fe)[..., None, None] + torch.einsum(
            "bshk,bshv->bhkv", ki * decay_e[..., None], vi)
        n = n * torch.exp(Fe)[..., None] + torch.einsum(
            "bsh,bshk->bhk", decay_e, ki)
        hs.append(h.to(x.dtype))       # streamed in the model dtype
    h = torch.cat(hs, dim=1).reshape(B, S, Hl * hd)
    return _mlstm_out(p, cfg, h, z)


def init_mlstm_cache(cfg: ModelConfig, batch: int, device) -> Dict:
    """Zeroed mLSTM state: this rank's heads under a mesh."""
    DI, H = _mlstm_inner(cfg), cfg.num_heads
    hd = DI // H
    return {"ml_C": cache_leaf("ml_C", (batch, H, hd, hd), torch.float32,
                               device),
            "ml_n": cache_leaf("ml_n", (batch, H, hd), torch.float32,
                               device)}


def mlstm_decode(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                 cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One token (B, 1, D): ``C <- f C + (i k) v^T`` and ``n <- f n + i k``
    in place (two passes over ``C``, no temporary of its size), then the
    read ``q . C / max(|q . n|, 1)``."""
    B = x.shape[0]
    xi, z = _mlstm_up(p, cfg, x)
    q, k, v, logi, logf = _mlstm_qkv(p, cfg, xi)         # (B, 1, Hl, hd)
    f = torch.exp(logf[:, 0])[..., None]                  # (B, Hl, 1)
    i = torch.exp(logi[:, 0])[..., None]
    kf, vf, qf = (t[:, 0].to(torch.float32) for t in (k, v, q))
    C, n = cache["ml_C"], cache["ml_n"]
    ik = i * kf
    C.mul_(f[..., None]).addcmul_(ik[..., :, None], vf[..., None, :])
    n.mul_(f).add_(ik)
    h = torch.einsum("bhk,bhkv->bhv", qf, C)
    nq = torch.einsum("bhk,bhk->bh", qf, n)
    h = (h / torch.clamp(nq.abs(), min=1.0)[..., None]).reshape(
        B, 1, -1).to(x.dtype)
    return _mlstm_out(p, cfg, h, z), cache


# ---------------------------------------------------------------------------
# sLSTM: scalar-memory LSTM with a block-diagonal recurrence (xlstm)
# ---------------------------------------------------------------------------

def init_slstm(cfg: ModelConfig, normal, ones, zeros) -> Dict:
    D, H = cfg.d_model, cfg.num_heads
    hd = D // H
    Fd = int(cfg.slstm_proj_factor * D)
    return {"w_x": normal((D, 4 * D), D),              # i, f, z, o from x
            "w_h": normal((H, hd, 4 * hd), hd),
            "b": zeros((4 * D,)),
            "w_up": normal((D, Fd), D), "w_down": normal((Fd, D), Fd)}


def _slstm_heads(cfg: ModelConfig) -> Tuple[int, Tuple[str, ...]]:
    """(heads, the mesh axes they are cut over) of the sLSTM state this
    rank holds (all heads outside a mesh)."""
    H = cfg.num_heads
    cut = cache_cut("sl_h", (1, H, cfg.d_model // H), 1)
    return (H // dist.axis_size(cut) if cut else H), cut


def _slstm_inputs(p: Dict, cfg: ModelConfig, x: torch.Tensor):
    """(the x-part of the gates (B, S, Hl * 4 hd), the bias (Hl * 4 hd,),
    ``w_h`` (Hl, hd, 4 hd)) of the state's heads.  ``w_x``'s and ``b``'s
    columns are head-major (head h's i, f, z, o side by side), so a
    contiguous cut of them is already a cut by heads: each is moved to the
    state's block, itself under the serve rules."""
    D, H = cfg.d_model, cfg.num_heads
    hd = D // H
    _, hcut = _slstm_heads(cfg)
    xcut = _cut("slstm", "w_x", (D, 4 * D), 1)
    xg = shd.reblock(dense(dist.enter(x, xcut), p["w_x"]), -1, xcut, hcut)
    b = shd.reblock(p["b"], 0, _cut("slstm", "b", (4 * D,), 0), hcut)
    w_h = shd.reblock(p["w_h"], 0, _cut("slstm", "w_h", (H, hd, 4 * hd), 0),
                      hcut)
    return xg, b, w_h


def _slstm_cell(xg: torch.Tensor, b: torch.Tensor, w_h: torch.Tensor,
                h: torch.Tensor, c: torch.Tensor):
    """One recurrent step.  xg (B, Hl * 4 hd): the x-part, in the
    activation dtype; h, c (B, Hl, hd) float32, which promote the sum to
    float32."""
    B, Hl, hd = h.shape
    rec = torch.einsum("bhk,hkg->bhg", h, w_h.to(h.dtype))
    g = xg.reshape(B, Hl, 4 * hd) + rec + b.to(xg.dtype).reshape(Hl, 4 * hd)
    i, f, z, o = torch.chunk(g.to(torch.float32), 4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(z)
    return torch.sigmoid(o) * torch.tanh(c), c


def _slstm_out(p: Dict, cfg: ModelConfig, y: torch.Tensor) -> torch.Tensor:
    """The state's heads' h (B, S, Hl * hd) -> (B, S, D): gathered whole
    over the axes the heads are cut over (the FFN's ``embed`` rows are
    replicated), then the gated projection, ``w_down`` summed over the
    axes its rows are cut over (the axis may leave ``w_up`` / ``w_down``
    whole: xlstm-1.3b's 2730 is not divisible by 4)."""
    D = cfg.d_model
    Fd = int(cfg.slstm_proj_factor * D)
    _, hcut = _slstm_heads(cfg)
    y = shd.reblock(y, -1, hcut, ())
    ucut = _cut("slstm", "w_up", (D, Fd), 1)
    dcut = _cut("slstm", "w_down", (Fd, D), 0)
    u = shd.reblock(F.silu(dense(dist.enter(y, ucut), p["w_up"])), -1, ucut,
                    dcut)
    return row_parallel(u, p["w_down"], dcut)


def slstm_mix(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The sLSTM cell looped over the sequence, then the gated projection."""
    B, S, D = x.shape
    xg, b, w_h = _slstm_inputs(p, cfg, x)                 # (B, S, Hl * 4hd)
    Hl, _ = _slstm_heads(cfg)
    h = torch.zeros((B, Hl, D // cfg.num_heads), dtype=torch.float32,
                    device=x.device)
    c = torch.zeros_like(h)
    hs = []
    for t in range(S):
        h, c = _slstm_cell(xg[:, t], b, w_h, h, c)
        hs.append(h.to(x.dtype))
    return _slstm_out(p, cfg, torch.stack(hs, dim=1).reshape(B, S, -1))


def init_slstm_cache(cfg: ModelConfig, batch: int, device) -> Dict:
    """Zeroed sLSTM state: this rank's heads under a mesh."""
    H = cfg.num_heads
    shape = (batch, H, cfg.d_model // H)
    return {"sl_h": cache_leaf("sl_h", shape, torch.float32, device),
            "sl_c": cache_leaf("sl_c", shape, torch.float32, device)}


def slstm_decode(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                 cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One token (B, 1, D): ``h`` and ``c`` advance in place."""
    B = x.shape[0]
    xg, b, w_h = _slstm_inputs(p, cfg, x)
    h, c = _slstm_cell(xg[:, 0], b, w_h, cache["sl_h"], cache["sl_c"])
    cache["sl_h"].copy_(h)
    cache["sl_c"].copy_(c)
    return _slstm_out(p, cfg, h.reshape(B, 1, -1).to(x.dtype)), cache


# ---------------------------------------------------------------------------
# dispatch by block type
# ---------------------------------------------------------------------------

INIT = {"mamba": init_mamba, "mlstm": init_mlstm, "slstm": init_slstm}
INIT_CACHE = {"mamba": init_mamba_cache, "mlstm": init_mlstm_cache,
              "slstm": init_slstm_cache}
MIX = {"mamba": mamba_mix, "mlstm": mlstm_mix, "slstm": slstm_mix}
DECODE = {"mamba": mamba_decode, "mlstm": mlstm_decode,
          "slstm": slstm_decode}
