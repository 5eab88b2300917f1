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
CUDA graph.

The expert-parallel strategies run on a mesh's ``model`` axis, each rank
holding its ``E / P`` experts (``dist/sharding.py``'s ``expert`` rule) and
calling the collectives itself, where the JAX package runs the same bodies
inside ``shard_map``:

* :func:`moe_ffn_replicated` -- tokens replicated over the axis; each rank
  runs the (token, choice) pairs routed to its experts, up to its capacity,
  and one ``psum`` combines;
* :func:`moe_ffn_a2a` -- each rank routes its ``S / P`` slice of the
  sequence, one ``all_to_all`` sends the pairs to their experts' ranks and
  a second brings the outputs back (capacity drops counted); the outputs
  are gathered back over the axis, the residual stream being replicated.

Both sum a token's k contributions in the local order (ascending expert
id, each add rounded to the activation dtype), so without drops they give
:func:`moe_ffn_local`'s output: the replicated strategy's ``psum`` carries
the (token, choice) contributions, not their per-token sums, so that the
adds happen after it in that order (the JAX package psums the (T, D) sums;
the wire is k times its bytes).  ``x`` is this rank's block of the batch;
the stats are summed over the axis and over ``batch_axes``, the mesh axes
the caller cut the batch over.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import dist
from ..dist import sharding as shd
from .common import ModelConfig, dense, init_normal, row_parallel


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


def dense_ffn(p: Dict, cfg: ModelConfig, x: torch.Tensor, *,
              d_ff: Optional[int] = None) -> torch.Tensor:
    """The (gated) FFN of width ``d_ff`` (default ``cfg.d_ff``).  Under a
    rules scope that cuts ``mlp``, ``w_up`` / ``w_gate`` hold this rank's
    columns and ``w_down`` its rows: the down projection is summed over the
    cut axes (:func:`row_parallel`), x entering the column-cut products
    through ``dist.enter``."""
    Fd = cfg.d_ff if d_ff is None else d_ff
    cut = shd.cut(("mlp", "embed"), (Fd, cfg.d_model), 0)
    x = dist.enter(x, cut)
    up = dense(x, p["w_up"])
    if cfg.gated_ffn:
        up = _act(cfg, dense(x, p["w_gate"])) * up
    else:
        up = _act(cfg, up)
    if cut:
        return row_parallel(up, p["w_down"], cut)
    return dense(up, p["w_down"])


def _shared_ffn(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return dense_ffn(p["shared"], cfg, x,
                     d_ff=cfg.num_shared_experts * cfg.d_ff_expert)


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
        0, flat_e, torch.ones_like(flat_e, dtype=torch.int32))


def route_sorted(p: Dict, cfg: ModelConfig, xf: torch.Tensor):
    """:func:`route` with each token's choices in ascending expert id (the
    gates alike): (T, k) int32 ids, (T, k) float32 gates."""
    top_e, top_w = route(p, cfg, xf)
    top_e, perm = torch.sort(top_e, dim=-1)
    return top_e, torch.gather(top_w, -1, perm)


def dispatch(p: Dict, cfg: ModelConfig, xf: torch.Tensor):
    """Route (T, D) tokens and shuffle them by expert -> ``(xbuf, gs, order,
    top_w)``: the (T * k, D) expert-sorted buffer, the (E,) int32 group
    sizes, the stable sort ``order`` of the flat (token, choice) pairs and
    the (T, k) gates.  Each token's choices are first put in ascending
    expert id (gates alike); that leaves the sorted buffer as the
    reference's, whose stable sort orders an expert's rows by token."""
    top_e, top_w = route_sorted(p, cfg, xf)
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
    return _sum_choices(contrib[inv].reshape(T, k, -1))


def _sum_choices(per_tok: torch.Tensor) -> torch.Tensor:
    """(T, k, D) contributions in ascending expert id -> (T, D), added in
    that order, each add rounded to their dtype."""
    out = per_tok[:, 0]
    for j in range(1, per_tok.shape[1]):
        out = out + per_tok[:, j]
    return out


def moe_ffn_local(p: Dict, cfg: ModelConfig,
                  x: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """MoE forward on one device -> (out like ``x``, ``{"expert_load": (E,)
    int32, "dropped": int32 0}``): route, sort by expert, grouped SwiGLU,
    gate-weighted combine, plus the shared experts."""
    D = x.shape[-1]
    xf = x.reshape(-1, D)
    # the experts whole on every rank but their mlp dim cut (the axis does
    # not divide the experts): each rank's products are partial sums
    cut = shd.cut(("expert", "mlp", "embed"),
                  (cfg.num_experts, cfg.d_ff_expert, D), 1)
    pe, xe = _entered(p, xf, cut)
    xbuf, gs, order, top_w = dispatch(pe, cfg, xe)
    out = combine(expert_compute(p, xbuf, gs), order, top_w)
    if cut:
        out = dist.psum(out.to(torch.float32), cut).to(x.dtype)
    if cfg.num_shared_experts > 0:
        out = out + _shared_ffn(p, cfg, xf)
    stats = {"expert_load": gs,
             "dropped": torch.zeros((), dtype=torch.int32, device=x.device)}
    return out.reshape(x.shape), stats


# ---------------------------------------------------------------------------
# expert-parallel strategies (each rank calls the collectives itself)
# ---------------------------------------------------------------------------

def _entered(p: Dict, x: torch.Tensor, axes) -> Tuple[Dict, torch.Tensor]:
    """(p, x) as a layer cut over ``axes`` reads them: x and the replicated
    router through ``dist.enter`` (each rank's gates, and its experts'
    rows, give a partial cotangent); the shared experts take x as it is
    (``dense_ffn`` enters it itself)."""
    if not axes:
        return p, x
    return {**p, "router": dist.enter(p["router"], axes)}, \
        dist.enter(x, axes)


def _divisible_batch_axes(mesh, batch_axes, B: int):
    """Keep only mesh axes present AND dividing the batch dim (B=1 decode)."""
    sizes = shd.mesh_sizes(mesh)
    kept, total = [], 1
    for a in batch_axes:
        if a in sizes and B % (total * sizes[a]) == 0:
            kept.append(a)
            total *= sizes[a]
    return tuple(kept)


def _capacity(cfg: ModelConfig, T: int, P: int) -> int:
    """Per-device token-buffer capacity (multiple of 8 for lane alignment)."""
    c = int(math.ceil(T * cfg.moe_top_k * cfg.moe_capacity_factor / P))
    return max(8, ((c + 7) // 8) * 8)


def _local_experts(p: Dict, cfg: ModelConfig, axis_name: str) -> int:
    P = dist.axis_size(axis_name)
    E = cfg.num_experts
    if E % P:
        raise ValueError(f"{E} experts do not split over {axis_name!r} of "
                         f"size {P}")
    if p["we_gate"].shape[0] != E // P:
        raise ValueError(f"expert weights hold {p['we_gate'].shape[0]} "
                         f"experts; {axis_name!r} of size {P} gives each "
                         f"rank {E // P}")
    return E // P


def _stats(load: torch.Tensor, dropped: torch.Tensor, axes) -> Dict:
    """One psum of (load, dropped) over ``axes``."""
    both = dist.psum(torch.cat([load, dropped.reshape(1)]).to(torch.int32),
                     axes)
    return {"expert_load": both[:-1], "dropped": both[-1]}


def moe_ffn_replicated(p: Dict, cfg: ModelConfig, x: torch.Tensor, mesh=None,
                       *, axis_name: str = "model",
                       batch_axes: Tuple[str, ...] = (),
                       with_stats: bool = True) -> Tuple[torch.Tensor, Dict]:
    """Baseline EP: tokens replicated over the expert axis; each rank runs
    the pairs routed to its ``E / P`` experts (the first ``_capacity`` of
    them in expert order; the rest are dropped and counted) and one
    ``psum`` of the (token, choice) contributions combines.  ``mesh`` is
    bound for the collectives (None: the bound mesh)."""
    B, S, D = x.shape
    k = cfg.moe_top_k
    with dist.maybe_mesh(mesh):
        E_l = _local_experts(p, cfg, axis_name)
        xf = x.reshape(-1, D)
        pe, xe = _entered(p, xf, axis_name)
        T = xf.shape[0]
        C = _capacity(cfg, T, dist.axis_size(axis_name))
        top_e, top_w = route_sorted(pe, cfg, xe)      # the same on all ranks
        e0 = dist.axis_index(axis_name) * E_l
        local_e = top_e.reshape(-1) - e0
        is_mine = (local_e >= 0) & (local_e < E_l)
        key = torch.where(is_mine, local_e, E_l)       # others' pairs last
        order = torch.argsort(key, stable=True)[:C]
        kept = is_mine[order]
        gs_all = group_sizes(key, E_l + 1)
        taken = torch.clamp(torch.cumsum(gs_all[:E_l], 0, dtype=torch.int32),
                            max=C)
        gs = torch.diff(taken, prepend=taken.new_zeros(1))
        # the rows past the kept ones run through the last local expert (no
        # copy of the weights for a sentinel) and are zeroed below
        gs_run = gs.clone()
        gs_run[-1] += order.numel() - taken[-1]
        out_buf = expert_compute(p, xe[order // k], gs_run)
        w = top_w.reshape(-1)[order].to(out_buf.dtype)
        contrib = torch.where(kept[:, None], out_buf * w[:, None],
                              torch.zeros((), dtype=out_buf.dtype,
                                          device=x.device))
        pairs = torch.zeros((T * k, D), dtype=torch.float32, device=x.device)
        pairs.index_copy_(0, order, contrib.to(torch.float32))
        # one owner per pair: the float32 sum is each pair's value exactly
        pairs = dist.psum(pairs, axis_name).to(x.dtype)
        out = _sum_choices(pairs.reshape(T, k, D))
        if cfg.num_shared_experts > 0:
            out = out + _shared_ffn(p, cfg, xf)
        stats = None
        if with_stats:
            load = torch.zeros(cfg.num_experts, dtype=torch.int32,
                               device=x.device)
            load[e0:e0 + E_l] = gs
            dropped = is_mine.sum() - kept.sum()
            stats = _stats(load, dropped, (axis_name,) + tuple(batch_axes))
    return out.reshape(B, S, D), stats


def moe_ffn_a2a(p: Dict, cfg: ModelConfig, x: torch.Tensor, mesh=None,
                *, axis_name: str = "model",
                batch_axes: Tuple[str, ...] = (),
                with_stats: bool = True) -> Tuple[torch.Tensor, Dict]:
    """GShard-style dispatch: each rank routes its ``S / P`` slice of the
    sequence, packs for every destination rank a capacity-C buffer of the
    pairs routed to its experts, one ``all_to_all`` moves the buffers, the
    owner runs its experts, a second ``all_to_all`` returns the outputs, and
    each rank adds its tokens' k contributions; an ``all_gather`` over the
    axis restores the replicated sequence.  Falls back to
    :func:`moe_ffn_replicated` when ``S % P != 0``."""
    B, S, D = x.shape
    k = cfg.moe_top_k
    with dist.maybe_mesh(mesh):
        P = dist.axis_size(axis_name)
        if S % P:
            return moe_ffn_replicated(p, cfg, x, axis_name=axis_name,
                                      batch_axes=batch_axes,
                                      with_stats=with_stats)
        E_l = _local_experts(p, cfg, axis_name)
        S_l = S // P
        r = dist.axis_index(axis_name)
        pe, xe = _entered(p, x, axis_name)
        xf = xe[:, r * S_l:(r + 1) * S_l].reshape(-1, D)
        T = xf.shape[0]
        C = _capacity(cfg, T, P)
        top_e, top_w = route_sorted(pe, cfg, xf)
        flat_e = top_e.reshape(-1).long()
        dst = flat_e // E_l                            # the owning rank
        order = torch.argsort(dst, stable=True)
        dst_sorted = dst[order]
        per_dst = group_sizes(dst_sorted, P)
        starts = torch.cumsum(per_dst, 0) - per_dst
        rank = torch.arange(T * k, device=x.device) - starts[dst_sorted]
        keep = rank < C                                # capacity drop
        slot = torch.where(keep, dst_sorted * C + rank, P * C)
        send_x = torch.zeros((P * C + 1, D), dtype=x.dtype, device=x.device)
        send_x[slot] = xf[order // k]
        send_e = torch.full((P * C + 1,), E_l, dtype=torch.int32,
                            device=x.device)
        send_e[slot] = (flat_e[order] % E_l).to(torch.int32)
        recv_x = dist.all_to_all(send_x[:P * C], axis_name)
        recv_e = dist.all_to_all(send_e[:P * C], axis_name)
        # the owner's experts over the received rows; empty slots (expert
        # E_l, zero rows) run through the last expert and give zeros
        rorder = torch.argsort(recv_e, stable=True)
        gs_all = group_sizes(recv_e, E_l + 1)
        gs = gs_all[:E_l].clone()
        gs[-1] += gs_all[E_l]
        out_r = torch.empty_like(recv_x)
        out_r[rorder] = expert_compute(p, recv_x[rorder], gs)
        back = dist.all_to_all(out_r, axis_name)
        w = top_w.reshape(-1)[order].to(x.dtype)
        contrib = torch.where(keep[:, None],
                              back[slot.clamp(max=P * C - 1)] * w[:, None],
                              torch.zeros((), dtype=x.dtype,
                                          device=x.device))
        pairs = torch.empty((T * k, D), dtype=x.dtype, device=x.device)
        pairs[order] = contrib
        out = _sum_choices(pairs.reshape(T, k, D))
        out = dist.all_gather(out.reshape(B, S_l, D).transpose(0, 1)
                              .contiguous(), axis_name, tiled=True)
        out = out.transpose(0, 1).reshape(B * S, D)
        if cfg.num_shared_experts > 0:
            out = out + _shared_ffn(p, cfg, x.reshape(-1, D))
        stats = None
        if with_stats:
            stats = _stats(group_sizes(flat_e, cfg.num_experts),
                           (~keep).sum(), tuple(batch_axes) + (axis_name,))
    return out.reshape(B, S, D), stats


def moe_ffn(p: Dict, cfg: ModelConfig, x: torch.Tensor, *, mesh=None,
            impl: str = "replicated", axis_name: str = "model",
            batch_axes: Tuple[str, ...] = (),
            with_stats: bool = True) -> Tuple[torch.Tensor, Dict]:
    """Dispatch to the configured expert-parallel strategy: local when there
    is no mesh, the mesh lacks ``axis_name`` or has size 1 there, or the
    axis does not divide the experts (as the JAX package's)."""
    size = shd.mesh_sizes(mesh).get(axis_name, 1) if mesh is not None else 1
    if size == 1 or cfg.num_experts % size != 0:
        return moe_ffn_local(p, cfg, x)
    if impl == "replicated":
        return moe_ffn_replicated(p, cfg, x, mesh, axis_name=axis_name,
                                  batch_axes=batch_axes,
                                  with_stats=with_stats)
    if impl == "a2a":
        return moe_ffn_a2a(p, cfg, x, mesh, axis_name=axis_name,
                           batch_axes=batch_axes, with_stats=with_stats)
    raise ValueError(impl)
