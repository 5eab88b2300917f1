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
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.monoids import affine_scan as _affine_monoid
from .common import ModelConfig, dense, rms_norm

RECURRENT_BLOCKS = ("mamba", "mlstm", "slstm")


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
    """Post-conv activations (B, S, DI) -> the discretised (abar, bbar_x,
    C), float32, abar and bbar_x (B, S, DI, N)."""
    N = cfg.d_state
    bcdt = dense(xc, p["w_bcdt"])
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
    DI = cfg.d_inner
    xz = dense(x, p["w_in"])
    xi, z = xz[..., :DI], xz[..., DI:]
    xc, _ = _causal_conv(xi, p["conv_w"].to(xi.dtype),
                         p["conv_b"].to(xi.dtype))
    xc = F.silu(xc)
    abar, bbar_x, Cm = _mamba_scan_inputs(p, cfg, xc)
    cs = _chunk(S, chunk_size)
    h = torch.zeros((B, DI, cfg.d_state), dtype=torch.float32,
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
    return dense(y * F.silu(z), p["w_out"])


def init_mamba_cache(cfg: ModelConfig, batch: int, device) -> Dict:
    return {"ssm_h": torch.zeros((batch, cfg.d_inner, cfg.d_state),
                                 dtype=torch.float32, device=device),
            "ssm_conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner),
                                    dtype=cfg.dtype, device=device)}


def mamba_decode(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                 cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One token (B, 1, D): the conv window and ``h`` advance in place."""
    DI = cfg.d_inner
    xz = dense(x, p["w_in"])
    xi, z = xz[..., :DI], xz[..., DI:]
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
    return dense(y, p["w_out"]), cache


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


def _mlstm_qkv(p: Dict, cfg: ModelConfig, xi: torch.Tensor):
    """-> q, k / sqrt(hd), v (B, S, H, hd) in xi's dtype, and the float32
    log-sigmoid input and forget gates (B, S, H)."""
    H = cfg.num_heads
    q, k, v = (dense(xi, p[w]) for w in ("wq", "wk", "wv"))
    gates = dense(xi, p["w_if"]) + p["b_if"].to(xi.dtype)
    logi = F.logsigmoid(gates[..., :H].to(torch.float32))
    logf = F.logsigmoid(gates[..., H:].to(torch.float32))
    return q, k / math.sqrt(q.shape[-1]), v, logi, logf


def mlstm_mix(p: Dict, cfg: ModelConfig, x: torch.Tensor, *,
              chunk_size: int = 128) -> torch.Tensor:
    """Chunkwise mLSTM: per head ``C_t = f_t C_{t-1} + i_t k_t v_t^T``,
    ``n_t = f_t n_{t-1} + i_t k_t``, ``h_t = q_t C_t / max(|q_t n_t|, 1)``;
    inside a chunk the masked decayed scores, across chunks the float32
    ``(C, n)`` carry read as ``exp(F_t) q_t . C``."""
    B, S, _ = x.shape
    DI, H = _mlstm_inner(cfg), cfg.num_heads
    hd = DI // H
    up = dense(x, p["w_up"])
    xi, z = up[..., :DI], up[..., DI:]
    q, k, v, logi, logf = _mlstm_qkv(p, cfg, xi)
    cs = _chunk(S, chunk_size)
    f32 = torch.float32
    C = torch.zeros((B, H, hd, hd), dtype=f32, device=x.device)
    n = torch.zeros((B, H, hd), dtype=f32, device=x.device)
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
        w = torch.where(keep, torch.exp(dec), 0.0)
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
    h = torch.cat(hs, dim=1).reshape(B, S, DI)
    h = rms_norm(h, p["ln_g"], cfg.norm_eps) * F.silu(z)
    return dense(h, p["w_down"])


def init_mlstm_cache(cfg: ModelConfig, batch: int, device) -> Dict:
    DI, H = _mlstm_inner(cfg), cfg.num_heads
    hd = DI // H
    return {"ml_C": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                                device=device),
            "ml_n": torch.zeros((batch, H, hd), dtype=torch.float32,
                                device=device)}


def mlstm_decode(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                 cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One token (B, 1, D): ``C <- f C + (i k) v^T`` and ``n <- f n + i k``
    in place (two passes over ``C``, no temporary of its size), then the
    read ``q . C / max(|q . n|, 1)``."""
    B = x.shape[0]
    DI = _mlstm_inner(cfg)
    up = dense(x, p["w_up"])
    xi, z = up[..., :DI], up[..., DI:]
    q, k, v, logi, logf = _mlstm_qkv(p, cfg, xi)         # (B, 1, H, hd)
    f = torch.exp(logf[:, 0])[..., None]                  # (B, H, 1)
    i = torch.exp(logi[:, 0])[..., None]
    kf, vf, qf = (t[:, 0].to(torch.float32) for t in (k, v, q))
    C, n = cache["ml_C"], cache["ml_n"]
    ik = i * kf
    C.mul_(f[..., None]).addcmul_(ik[..., :, None], vf[..., None, :])
    n.mul_(f).add_(ik)
    h = torch.einsum("bhk,bhkv->bhv", qf, C)
    nq = torch.einsum("bhk,bhk->bh", qf, n)
    h = (h / torch.clamp(nq.abs(), min=1.0)[..., None]).reshape(
        B, 1, DI).to(x.dtype)
    h = rms_norm(h, p["ln_g"], cfg.norm_eps) * F.silu(z)
    return dense(h, p["w_down"]), cache


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


def _slstm_cell(p: Dict, cfg: ModelConfig, xg: torch.Tensor,
                h: torch.Tensor, c: torch.Tensor):
    """One recurrent step.  xg (B, 4D): the x-part, in the activation dtype;
    h, c (B, H, hd) float32, which promote the sum to float32."""
    B = xg.shape[0]
    H = cfg.num_heads
    hd = cfg.d_model // H
    rec = torch.einsum("bhk,hkg->bhg", h, p["w_h"].to(h.dtype))
    g = xg.reshape(B, H, 4 * hd) + rec + \
        p["b"].to(xg.dtype).reshape(H, 4 * hd)
    i, f, z, o = torch.chunk(g.to(torch.float32), 4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(z)
    return torch.sigmoid(o) * torch.tanh(c), c


def _slstm_out(p: Dict, y: torch.Tensor) -> torch.Tensor:
    return dense(F.silu(dense(y, p["w_up"])), p["w_down"])


def slstm_mix(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The sLSTM cell looped over the sequence, then the gated projection."""
    B, S, D = x.shape
    H = cfg.num_heads
    xg = dense(x, p["w_x"])                               # (B, S, 4D)
    h = torch.zeros((B, H, D // H), dtype=torch.float32, device=x.device)
    c = torch.zeros_like(h)
    hs = []
    for t in range(S):
        h, c = _slstm_cell(p, cfg, xg[:, t], h, c)
        hs.append(h.to(x.dtype))
    return _slstm_out(p, torch.stack(hs, dim=1).reshape(B, S, D))


def init_slstm_cache(cfg: ModelConfig, batch: int, device) -> Dict:
    H = cfg.num_heads
    shape = (batch, H, cfg.d_model // H)
    return {"sl_h": torch.zeros(shape, dtype=torch.float32, device=device),
            "sl_c": torch.zeros(shape, dtype=torch.float32, device=device)}


def slstm_decode(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                 cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One token (B, 1, D): ``h`` and ``c`` advance in place."""
    B, _, D = x.shape
    xg = dense(x, p["w_x"])[:, 0]
    h, c = _slstm_cell(p, cfg, xg, cache["sl_h"], cache["sl_c"])
    cache["sl_h"].copy_(h)
    cache["sl_c"].copy_(c)
    return _slstm_out(p, h.reshape(B, 1, D).to(x.dtype)), cache


# ---------------------------------------------------------------------------
# dispatch by block type
# ---------------------------------------------------------------------------

INIT = {"mamba": init_mamba, "mlstm": init_mlstm, "slstm": init_slstm}
INIT_CACHE = {"mamba": init_mamba_cache, "mlstm": init_mlstm_cache,
              "slstm": init_slstm_cache}
MIX = {"mamba": mamba_mix, "mlstm": mlstm_mix, "slstm": slstm_mix}
DECODE = {"mamba": mamba_decode, "mlstm": mlstm_decode,
          "slstm": slstm_decode}
