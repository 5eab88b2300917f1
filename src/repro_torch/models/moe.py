"""Mixture-of-Experts FFN on one device: the port of ``repro/models/moe.py``.

The MoE layer is the clearest MapReduce instance of the model stack:

    map     : :func:`route` assigns each token to its top-k experts
    shuffle : :func:`dispatch` sorts the (token, expert) pairs by expert and
              gathers the tokens into one expert-ordered buffer
    reduce  : :func:`combine` sums each token's k expert outputs, weighted by
              the gates (a Sum monoid); the per-expert load rides along as
              a second Sum monoid (``expert_load``)

The expert products run as three grouped products over the expert-sorted
buffer (:func:`expert_compute`, ``torch.nn.functional.grouped_mm``, where the
JAX package runs ``lax.ragged_dot``); :func:`expert_compute_plain`, a loop of
one ``torch.matmul`` per expert, is its plain version and oracle.

:func:`combine` does not scatter-add: on the card ``index_add_`` adds in
whatever order the atomics land, so bf16 outputs would vary from run to run.
It lays each token's k contributions out in ascending expert id (the order in
which the reference's scatter over the expert-sorted buffer meets them) and
adds them in that order in the activation dtype.  Nothing in the layer reads
a device value on the host, so a decode step through it can be captured in a
CUDA graph.  The expert-parallel strategies (``moe_ffn_replicated``,
``moe_ffn_a2a``) need the mesh tier's model half, the next slice of
the port.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .common import ModelConfig, dense, init_normal


# ---------------------------------------------------------------------------
# init: the JAX package's shapes and scales (std = 1/sqrt(fan_in))
# ---------------------------------------------------------------------------

def init_dense_ffn(cfg: ModelConfig, gen: torch.Generator, *, device,
                   d_ff: Optional[int] = None) -> Dict[str, torch.Tensor]:
    D = cfg.d_model
    Fd = cfg.d_ff if d_ff is None else d_ff
    p = {"w_up": init_normal(gen, (D, Fd), D, cfg.dtype, device),
         "w_down": init_normal(gen, (Fd, D), Fd, cfg.dtype, device)}
    if cfg.gated_ffn:
        p["w_gate"] = init_normal(gen, (D, Fd), D, cfg.dtype, device)
    return p


def init_moe(cfg: ModelConfig, gen: torch.Generator, *,
             device) -> Dict[str, torch.Tensor]:
    """``router`` (D, E) and ``we_gate`` / ``we_up`` (E, D, F) with fan-in D,
    ``we_down`` (E, F, D) with fan-in F, the padded experts drawn too;
    ``shared``, a dense FFN of width ``num_shared_experts * d_ff_expert``."""
    D, E, Fe = cfg.d_model, cfg.num_experts, cfg.d_ff_expert

    def normal(shape, fan_in):
        return init_normal(gen, shape, fan_in, cfg.dtype, device)

    p = {"router": normal((D, E), D), "we_gate": normal((E, D, Fe), D),
         "we_up": normal((E, D, Fe), D), "we_down": normal((E, Fe, D), Fe)}
    if cfg.num_shared_experts > 0:
        p["shared"] = init_dense_ffn(cfg, gen, device=device,
                                     d_ff=cfg.num_shared_experts * Fe)
    return p


# ---------------------------------------------------------------------------
# dense FFN
# ---------------------------------------------------------------------------

def _act(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.act_fn == "silu":
        return F.silu(x)
    return F.gelu(x, approximate="tanh")    # jax.nn.gelu's default


def dense_ffn(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    up = dense(x, p["w_up"])
    if cfg.gated_ffn:
        up = _act(cfg, dense(x, p["w_gate"])) * up
    else:
        up = _act(cfg, up)
    return dense(up, p["w_down"])


# ---------------------------------------------------------------------------
# map and shuffle
# ---------------------------------------------------------------------------

def route(p: Dict, cfg: ModelConfig,
          x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, D) tokens -> ((T, k) int32 expert ids, (T, k) float32 gates), in
    descending score.  Logits, softmax and gates are float32; the last
    ``num_padded_experts`` experts score exactly 0, so they are never picked
    while ``k <= E - pad``."""
    E = cfg.num_experts
    logits = torch.matmul(x.to(torch.float32), p["router"].to(torch.float32))
    if cfg.num_padded_experts:
        pad = torch.arange(E, device=x.device) >= E - cfg.num_padded_experts
        logits = logits.masked_fill(pad, -1e30)
    scores = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(scores, cfg.moe_top_k, dim=-1)
    if cfg.norm_topk_prob:
        top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return top_e.to(torch.int32), top_w


def group_sizes(flat_e: torch.Tensor, num_experts: int) -> torch.Tensor:
    """(E,) int32 rows per expert: integer adds, exact in any order, and no
    read of the largest id on the host (``torch.bincount`` makes one)."""
    return torch.zeros(num_experts, dtype=torch.int32,
                       device=flat_e.device).index_add_(
        0, flat_e, torch.ones_like(flat_e))


def dispatch(p: Dict, cfg: ModelConfig, xf: torch.Tensor):
    """Route (T, D) tokens and shuffle them by expert -> ``(xbuf, gs, order,
    top_w)``: the (T * k, D) expert-sorted buffer, the (E,) int32 group
    sizes, the stable sort ``order`` of the flat (token, choice) pairs and
    the (T, k) gates.  Each token's choices are first put in ascending
    expert id (gates alike); that leaves the sorted buffer as the
    reference's, whose stable sort orders an expert's rows by token."""
    top_e, top_w = route(p, cfg, xf)
    top_e, perm = torch.sort(top_e, dim=-1)
    top_w = torch.gather(top_w, -1, perm)
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    gs = group_sizes(flat_e, cfg.num_experts)
    return xf[order // cfg.moe_top_k], gs, order, top_w


# ---------------------------------------------------------------------------
# the expert products
# ---------------------------------------------------------------------------

def expert_compute(p: Dict, xbuf: torch.Tensor,
                   gs: torch.Tensor) -> torch.Tensor:
    """SwiGLU of the expert-sorted (C, D) buffer through each row's expert:
    three grouped products in the buffer's dtype (float32 accumulation),
    the weights in their (E, D, F) / (E, F, D) layout.  Counts its calls in
    ``expert_compute.calls`` (three grouped products each)."""
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    dt = xbuf.dtype

    def gmm(a, w):
        return F.grouped_mm(a, w.to(dt), offs=offs)

    expert_compute.calls += 1
    h = F.silu(gmm(xbuf, p["we_gate"])) * gmm(xbuf, p["we_up"])
    return gmm(h, p["we_down"])


expert_compute.calls = 0


def expert_compute_plain(p: Dict, xbuf: torch.Tensor,
                         gs: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`expert_compute`: one ``torch.matmul``
    per expert with rows (it reads the group sizes on the host)."""
    dt = xbuf.dtype
    out = torch.empty((xbuf.shape[0], p["we_down"].shape[-1]), dtype=dt,
                      device=xbuf.device)
    start = 0
    for e, n in enumerate(gs.tolist()):
        if n:
            rows = xbuf[start:start + n]
            h = F.silu(rows @ p["we_gate"][e].to(dt)) * \
                (rows @ p["we_up"][e].to(dt))
            out[start:start + n] = h @ p["we_down"][e].to(dt)
        start += n
    return out


# ---------------------------------------------------------------------------
# reduce
# ---------------------------------------------------------------------------

def combine(out_buf: torch.Tensor, order: torch.Tensor,
            top_w: torch.Tensor) -> torch.Tensor:
    """The gate-weighted Sum over each token's k expert outputs -> (T, D).

    ``out_buf * gate`` in the activation dtype, as the reference scales it;
    the sort is inverted so that token ``t``'s contributions sit at rows
    ``t * k .. t * k + k - 1`` in ascending expert id, and they are added
    in that order, each add rounded to the activation dtype."""
    T, k = top_w.shape
    w = top_w.reshape(-1)[order].to(out_buf.dtype)
    contrib = out_buf * w[:, None]
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=order.device))
    per_tok = contrib[inv].reshape(T, k, -1)
    out = per_tok[:, 0]
    for j in range(1, k):
        out = out + per_tok[:, j]
    return out


def moe_ffn_local(p: Dict, cfg: ModelConfig,
                  x: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """MoE forward on one device -> (out like ``x``, ``{"expert_load": (E,)
    int32, "dropped": int32 0}``): route, sort by expert, grouped SwiGLU,
    gate-weighted combine, plus the shared experts."""
    D = x.shape[-1]
    xf = x.reshape(-1, D)
    xbuf, gs, order, top_w = dispatch(p, cfg, xf)
    out = combine(expert_compute(p, xbuf, gs), order, top_w)
    if cfg.num_shared_experts > 0:
        out = out + dense_ffn(p["shared"], cfg, xf)
    stats = {"expert_load": gs,
             "dropped": torch.zeros((), dtype=torch.int32, device=x.device)}
    return out.reshape(x.shape), stats


def moe_ffn(p: Dict, cfg: ModelConfig, x: torch.Tensor, *,
            mesh=None) -> Tuple[torch.Tensor, Dict]:
    """Dispatch: with no mesh, :func:`moe_ffn_local`."""
    if mesh is not None:
        raise NotImplementedError(
            "moe_ffn(mesh=): the expert-parallel strategies (replicated, "
            "a2a) need the mesh tier's model half, the next slice of the "
            "port (ROADMAP §1 item 4)")
    return moe_ffn_local(p, cfg, x)
