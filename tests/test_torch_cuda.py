"""Tests that need the card: the CUDA kernels against their plain versions,
and the serving (prefill and decode), training (one rank and across gloo
ranks sharing the card), stream-stats and MapReduce paths through them.
They import no JAX (the card's machine has none) and skip without a GPU;
run them there with

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import pytest
import torch
import torch.utils._pytree as pytree

from repro_torch.kernels import segment_fold, segment_fold_plain
from repro_torch.kernels.cms import cms_counts, cms_counts_plain
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.stripes import stripe_counts, stripe_counts_plain


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("semiring,dtype", [
    ("sum", torch.float32), ("sum", torch.bfloat16), ("max", torch.uint8),
    ("min", torch.int32), ("max", torch.float32)])
def test_cuda_kernel_matches_plain(cuda_device, semiring, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    n, d, s = 5000, 7, 33
    if dtype.is_floating_point:
        v = torch.randn((n, d), generator=gen, device=cuda_device).to(dtype)
    else:
        v = torch.randint(0, 100, (n, d), generator=gen, device=cuda_device,
                          dtype=dtype)
    ids = torch.randint(-2, s + 2, (n,), generator=gen, device=cuda_device,
                        dtype=torch.int32)
    mask = torch.rand((n,), generator=gen, device=cuda_device) < 0.8
    before = segment_fold.launches
    got = segment_fold(v, ids, s, semiring=semiring, valid_mask=mask)
    torch.cuda.synchronize()
    assert segment_fold.launches == before + 1
    want = segment_fold_plain(v, ids, s, semiring=semiring, valid_mask=mask)
    if semiring == "sum" and dtype.is_floating_point:
        # atomics sum in run-dependent order
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    else:
        assert torch.equal(got, want)


def _chip_smoke():
    """The repo's ``chip_smoke.py``, loaded as a module."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke


def _device_launches(fn):
    """Kernels and memsets one call of ``fn`` puts on the card:
    ``chip_smoke.cuda_launches`` (the profiler's device events)."""
    return _chip_smoke().cuda_launches(fn)


def _fold_both(v, ids, s, semiring, mask=None, with_count=False):
    got = segment_fold(v, ids, s, semiring=semiring, with_count=with_count,
                       valid_mask=mask)
    torch.cuda.synchronize()
    return got, segment_fold_plain(v, ids, s, semiring=semiring,
                                   with_count=with_count, valid_mask=mask)


@pytest.mark.cuda
@pytest.mark.parametrize("semiring", ["sum", "max", "min"])
@pytest.mark.parametrize("d,s", [(1, 65536), (2, 128), (3, 8), (33, 40)])
def test_cuda_fold_lanes_over_rows(cuda_device, d, s, semiring):
    """D = 1, 2, 3 (a lane holds its row) and 33 (lanes walk the elements),
    in the shared-table, global-table and one-CTA regimes; sums of small
    integers are exact, so every case is compared bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    for n in (5, 3000, 70_001):
        v = torch.randint(-50, 50, (n, d), generator=gen, device=cuda_device
                          ).float()
        ids = torch.randint(-1, s + 1, (n,), generator=gen,
                            device=cuda_device, dtype=torch.int32)
        mask = torch.rand((n,), generator=gen, device=cuda_device) < 0.8
        got, want = _fold_both(v, ids, s, semiring, mask)
        assert torch.equal(got, want), (n, d, s, semiring)
        if semiring == "sum":
            got, want = _fold_both(v, ids, s, semiring, mask, with_count=True)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("semiring", ["sum", "max", "min"])
@pytest.mark.parametrize("runs", ["one id", "packed_stats runs"])
def test_cuda_fold_runs_of_equal_ids(cuda_device, runs, semiring):
    """Every row on one id (all lanes of every warp aggregate), and runs of
    4096 rows per id with a ragged masked tail per run, as packed_stats
    folds a stream batch."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    n, s = 128 * 4096, 128
    v = torch.randint(0, 3, (n, 2), generator=gen, device=cuda_device).float()
    if runs == "one id":
        ids = torch.full((n,), 5, dtype=torch.int32, device=cuda_device)
        mask = None
    else:
        ids = torch.arange(s, dtype=torch.int32, device=cuda_device
                           ).repeat_interleave(4096)
        lengths = torch.randint(1, 4097, (s,), generator=gen,
                                device=cuda_device)
        mask = (torch.arange(4096, device=cuda_device)[None, :]
                < lengths[:, None]).reshape(-1)
    got, want = _fold_both(v, ids, s, semiring, mask,
                           with_count=semiring == "sum")
    for g, w in zip(got, want) if semiring == "sum" else [(got, want)]:
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("semiring", ["max", "min"])
@pytest.mark.parametrize("d", [1, 16])
def test_cuda_fold_int32_extremes(cuda_device, d, semiring):
    """int32 values beyond +-2**24 and at int32's limits: the float32
    contract rounds them, and the kernel's result equals the plain
    version's bit for bit (empty segments hold iinfo.min / max)."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    n, s = 50_000, 300
    info = torch.iinfo(torch.int32)
    v = torch.randint(info.min, info.max, (n, d), generator=gen,
                      device=cuda_device, dtype=torch.int32)
    v[::7] = info.max
    v[3::7] = info.min
    v[5::11] = (1 << 24) + 1
    ids = torch.randint(0, s + 20, (n,), generator=gen, device=cuda_device,
                        dtype=torch.int32)
    got, want = _fold_both(v, ids, s, semiring)
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("semiring", ["max", "min"])
@pytest.mark.parametrize("n", [64, 200_000])
def test_cuda_fold_float_specials(cuda_device, n, semiring):
    """NaN, +-inf and +-0.0: NaN wins wherever it lands, infinities order
    as numbers, and a zero result is +0.0 for max unless every zero is
    -0.0, -0.0 for min if any zero is (the kernel's stated rule)."""
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    specials = torch.tensor([float("nan"), float("inf"), -float("inf"), 0.0,
                             -0.0, 1.0, -1.0], device=cuda_device)
    pick = torch.randint(0, len(specials), (n, 2), generator=gen,
                         device=cuda_device)
    pick[: n // 2] = torch.randint(3, 5, (n // 2, 2), generator=gen,
                                   device=cuda_device)     # zeros only
    v = specials[pick]
    s = max(2, n // 16)
    ids = torch.randint(0, s, (n,), generator=gen, device=cuda_device,
                        dtype=torch.int32)
    got, want = _fold_both(v, ids, s, semiring)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    zeros = (got == 0).cpu()

    def has(flags):      # (S, 2): some row of the segment has the flag
        return torch.zeros((s, 2), dtype=torch.long).index_add_(
            0, ids.long().cpu(), flags.long().cpu()) > 0

    neg, pos = has((v == 0) & torch.signbit(v)), has((v == 0)
                                                     & ~torch.signbit(v))
    want_neg = (neg & ~pos) if semiring == "max" else neg
    assert torch.equal(torch.signbit(got.cpu())[zeros], want_neg[zeros])


@pytest.mark.cuda
def test_cuda_fold_serve_shape_is_one_launch(cuda_device):
    """The decode step's 8 x 3 masked fold: one CTA, one CUDA launch, the
    table written with plain stores."""
    gen = torch.Generator(device=cuda_device).manual_seed(17)
    v = torch.randn((8, 3), generator=gen, device=cuda_device)
    ids = torch.arange(8, dtype=torch.int32, device=cuda_device)
    mask = torch.tensor([1, 1, 0, 1, 1, 1, 0, 1], dtype=torch.bool,
                        device=cuda_device)
    assert _device_launches(
        lambda: segment_fold(v, ids, 8, valid_mask=mask)) == 1
    got, want = _fold_both(v, ids, 8, "sum", mask)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_engine_folds_through_the_kernel(cuda_device):
    """The serving path on the card: one kernel launch per decode step, and
    the same tokens as the same float32 weights served on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import (ContinuousEngine, ServeConfig,
                                     decode_metrics_plan, make_backend)

    plan = decode_metrics_plan(4, 4, device=cuda_device)
    assert plan.local_tier.kind == "kernel"
    config = ServeConfig(num_slots=2, prefill_buckets=(8,), max_new_tokens=4)
    cfg = dataclasses.replace(get_config("qwen3-0.6b", smoke=True),
                              dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    results = {}
    for dev in ("cpu", cuda_device):
        p = pytree.tree_map(lambda t: t.to(dev), params)
        eng = ContinuousEngine(make_backend(cfg, p, config, dev), config)
        uids = [eng.submit(x) for x in ([5, 9, 2, 7], [11, 3], [6, 6, 6])]
        before = segment_fold.launches
        for _ in eng.run(max_steps=50):
            pass
        launched = segment_fold.launches - before
        assert launched == (eng.stats.steps if dev != "cpu" else 0)
        results[str(dev)] = [eng.result(u) for u in uids]
    for a, b in zip(results["cpu"], results[str(cuda_device)]):
        assert a.tokens == b.tokens
        assert abs(a.logprob_sum - b.logprob_sum) < 1e-3


def _zipf_tokens(gen, n, vocab, dev):
    """Zipf-like ids (rank ~ 1/u): one hot id takes a large share."""
    u = torch.rand((n,), generator=gen, device=dev)
    return torch.clamp((1.0 / (u + 1e-6)).long(), max=vocab - 1).to(
        torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("depth,width,weights", [
    (4, 2048, None), (4, 2048, "mask"), (5, 65536, None), (5, 65536, "int"),
    (3, 56 * 1024 // 3, None), (1, 7, "mask")])
def test_cuda_cms_update_matches_plain(cuda_device, depth, width, weights):
    """Shared-table (<= 227 KB, and above the 48 KB opt-in) and global
    regimes, unweighted, masked and int-weighted: exact int32 counts."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    n = 300_001
    toks = _zipf_tokens(gen, n, 1 << 20, cuda_device)
    toks[::7] = -toks[::7] - 5          # negative ids hash their low 32 bits
    w = None
    if weights == "mask":
        w = torch.rand((n,), generator=gen, device=cuda_device) < 0.9
    elif weights == "int":
        w = torch.randint(-3, 4, (n,), generator=gen, device=cuda_device,
                          dtype=torch.int32)
    before = cms_counts.launches
    got = cms_counts(toks, depth, width, weights=w)
    torch.cuda.synchronize()
    assert cms_counts.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (depth, width)
    assert torch.equal(got, cms_counts_plain(toks, depth, width, weights=w))
    assert torch.equal(cms_counts(toks.long(), depth, width, weights=w), got)


# cms_update cases: name -> (tokens, N, depth, width, weights).  Tables of
# 4 x 2048 sit in one CTA's shared memory; 232448 bytes (227 KB) and up to
# 8 x ~221 KB are split over a cluster; 5 x 100000 (2 MB) is global.
CMS_CASES = {
    "every token one id": ("one id", 300_001, 4, 2048, None),
    "every token one id, cluster table": ("one id", 300_001, 5, 65536, "mask"),
    "every token one id, global table": ("one id", 300_001, 5, 100_000, None),
    "uniform ids": ("uniform", 300_001, 4, 2048, None),
    "uniform ids, cluster table": ("uniform", 300_001, 5, 65536, None),
    "uniform ids, global table": ("uniform", 300_001, 5, 100_000, "int"),
    "largest one-CTA table": ("zipf", 300_001, 1, 56_576, "mask"),
    "227 KB table": ("zipf", 300_001, 4, 14_528, None),
    "227 KB + 4 bytes": ("zipf", 300_001, 1, 58_113, "int"),
    "cluster table 5 x 65536": ("zipf", 1 << 20, 5, 65536, None),
    "cluster table, width split unevenly": ("zipf", 300_001, 3, 100_003,
                                            "mask"),
    "above a cluster's capacity": ("zipf", 300_001, 5, 100_000, "u8"),
    "N=1": ("zipf", 1, 4, 2048, None),
    "N=1, cluster table": ("zipf", 1, 5, 65536, "int"),
    "N=1, global table": ("zipf", 1, 5, 100_000, "mask"),
    "N below one CTA's share": ("zipf", 1000, 4, 2048, "mask"),
    "N below one CTA's share, cluster table": ("zipf", 3000, 5, 65536, None),
    "N below one CTA's share, global table": ("zipf", 1500, 5, 100_000,
                                              None),
    "negative int32 weights": ("zipf", 300_001, 4, 2048, "negative"),
    "negative int32 weights, cluster table": ("zipf", 300_001, 5, 65536,
                                              "negative"),
    "bool weights, global table": ("zipf", 300_001, 5, 100_000, "mask"),
    "uint8 weights": ("zipf", 300_001, 4, 2048, "u8"),
    "uint8 weights, cluster table": ("zipf", 300_001, 5, 65536, "u8"),
    "int64 tokens with high bits": ("int64", 300_001, 4, 2048, "mask"),
    "int64 tokens with high bits, cluster table": ("int64", 300_001, 5,
                                                   65536, None),
    "int64 tokens with high bits, global table": ("int64", 300_001, 5,
                                                  100_000, "u8"),
}


def _cms_inputs(case, dev):
    tokens, n, depth, width, weights = CMS_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(23)
    if tokens == "one id":
        toks = torch.full((n,), 12345, dtype=torch.int32, device=dev)
    elif tokens == "uniform":
        toks = torch.randint(0, 151936, (n,), generator=gen, device=dev,
                             dtype=torch.int32)
    else:
        toks = _zipf_tokens(gen, n, 151936, dev)
    if tokens == "int64":
        high = torch.randint(-2 ** 31, 2 ** 31, (n,), generator=gen,
                             device=dev, dtype=torch.int64)
        toks = toks.long() + (high << 32)
    w = None
    if weights == "mask":
        w = torch.rand((n,), generator=gen, device=dev) < 0.9
    elif weights == "int":
        w = torch.randint(-3, 4, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
    elif weights == "negative":
        w = torch.randint(-1000, 1, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
    elif weights == "u8":
        w = torch.randint(0, 256, (n,), generator=gen, device=dev,
                          dtype=torch.uint8)
    return toks, depth, width, w


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CMS_CASES))
def test_cuda_cms_update_regimes(cuda_device, case):
    """One id, uniform ids, every table regime and its edges (one CTA's
    shared memory, split over a cluster, global), N of 1 and below one
    CTA's share, every weight type and int64 ids with high bits set: exact
    against the plain version, one launch each."""
    toks, depth, width, w = _cms_inputs(case, cuda_device)
    before = cms_counts.launches
    got = cms_counts(toks, depth, width, weights=w)
    torch.cuda.synchronize()
    assert cms_counts.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (depth, width)
    assert torch.equal(got, cms_counts_plain(toks, depth, width, weights=w))
    if toks.dtype == torch.int64:   # the low 32 bits are the id
        low = (toks & 0xFFFFFFFF).to(torch.int32)
        assert torch.equal(cms_counts(low, depth, width, weights=w), got)


@pytest.mark.cuda
@pytest.mark.parametrize("vocab,window", [(128, 4), (238, 2), (239, 1),
                                          (1024, 5), (4096, 4)])
def test_cuda_stripes_matches_plain(cuda_device, vocab, window):
    """Shared-table (V <= 238) and global regimes; ids outside [0, V) and a
    length that is no multiple of the tile: exact int32 counts."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    n = 100_003
    toks = _zipf_tokens(gen, n, vocab + 3, cuda_device) - 2
    before = stripe_counts.launches
    got = stripe_counts(toks, vocab, window)
    torch.cuda.synchronize()
    assert stripe_counts.launches == before + 1
    want = stripe_counts_plain(toks, vocab, window)
    assert torch.equal(got, want)
    assert torch.equal(got, got.T)
    assert torch.equal(stripe_counts(toks.long(), vocab, window), got)


@pytest.mark.cuda
@pytest.mark.parametrize("tokens,vocab,window", [
    ("one repeated id", 4096, 4), ("uniform", 4096, 4), ("uniform", 238, 4),
    ("uniform", 239, 4), ("10 distinct ids", 4096, 3)])
def test_cuda_stripes_regimes(cuda_device, tokens, vocab, window):
    """Every pair on one cell; uniform ids (no hot id); V either side of the
    shared-table limit at window 4; a hot set larger than the ids seen.
    Exact and symmetric against the plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(19)
    n = 300_007
    if tokens == "one repeated id":
        toks = torch.full((n,), 7, dtype=torch.int32, device=cuda_device)
    elif tokens == "uniform":
        toks = torch.randint(0, vocab, (n,), generator=gen,
                             device=cuda_device, dtype=torch.int32)
    else:
        toks = torch.randint(0, 10, (n,), generator=gen, device=cuda_device,
                             dtype=torch.int32) * 397
    got = stripe_counts(toks, vocab, window)
    torch.cuda.synchronize()
    assert torch.equal(got, stripe_counts_plain(toks, vocab, window))
    assert torch.equal(got, got.T)
    if tokens == "one repeated id":
        pairs = sum(n - j for j in range(1, window + 1))
        assert int(got[7, 7]) == 2 * pairs and int(got.sum()) == 2 * pairs


@pytest.mark.cuda
def test_cuda_stream_stats_equal_cpu(cuda_device):
    """The stream-stats path on the card (one cms_update launch and one
    packed_stats segment_fold launch per batch) equals the CPU's bit for
    bit, dense and ragged."""
    from repro_torch.data import (DataConfig, SyntheticCorpus, init_stats,
                                  make_stream_stats, packed_stats,
                                  update_stats)

    m = make_stream_stats()
    for ragged in (False, True):
        cfg = DataConfig(vocab_size=5000, seq_len=256, global_batch=8,
                         seed=3, ragged=ragged)
        states = {}
        for dev in ("cpu", cuda_device):
            corpus = SyntheticCorpus(cfg, device=dev)
            state = init_stats(m, device=dev)
            before = (cms_counts.launches, segment_fold.launches)
            for step in range(3):
                b = corpus(step)
                state = update_stats(state, b["tokens"],
                                     valid_mask=b.get("valid_mask"))
                if ragged:
                    packed_stats(b["tokens"], b["valid_mask"])
            torch.cuda.synchronize()
            launched = (cms_counts.launches - before[0],
                        segment_fold.launches - before[1])
            assert launched == ((0, 0) if dev == "cpu"
                                else (3, 3 if ragged else 0))
            states[str(dev)] = {k: v.cpu() for k, v in state.items()}
        for k in states["cpu"]:
            assert torch.equal(states["cpu"][k], states[str(cuda_device)][k])


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["naive", "combiner", "in_mapper"])
def test_cuda_mapreduce_jobs(cuda_device, strategy):
    """Algorithms 1/3/4 on the card against float64 oracles.  Mean-by-key's
    int32 count leaf keeps it on the exact segment tier (the planner's
    exactness rule); max-by-key (float32) folds through segment_fold."""
    from repro_torch.core import MapReduceJob, average_by_key_job, monoids

    gen = torch.Generator(device=cuda_device).manual_seed(4)
    n, k = 4096, 64
    keys = torch.randint(0, k, (n,), generator=gen, device=cuda_device,
                         dtype=torch.int32)
    vals = torch.randn((n,), generator=gen, device=cuda_device)
    recs = {"key": keys, "value": vals}
    mean_job = average_by_key_job(k)
    max_job = MapReduceJob(mapper=lambda r: (r["key"], r["value"]),
                           monoid=monoids.max_, num_keys=k)
    kinds = {"naive": ("segment_ops", "kernel"),
             "combiner": ("segment_ops", "kernel"),
             "in_mapper": ("scan", "scan")}[strategy]
    for job, kind in zip((mean_job, max_job), kinds):
        assert job.plan(recs, strategy=strategy,
                        num_shards=4).local_tier.kind == kind
        before = segment_fold.launches
        out = job.run_local(recs, strategy=strategy, num_shards=4)
        torch.cuda.synchronize()
        want = 0 if kind != "kernel" else (1 if strategy == "naive" else 4)
        assert segment_fold.launches - before == want
        if job is mean_job:
            sums = torch.zeros(k, dtype=torch.float64).index_add_(
                0, keys.long().cpu(), vals.double().cpu())
            cnt = torch.bincount(keys.long().cpu(), minlength=k).clamp(min=1)
            oracle = sums / cnt
        else:
            oracle = torch.full((k,), -float("inf"), dtype=torch.float64
                                ).scatter_reduce(0, keys.long().cpu(),
                                                 vals.double().cpu(), "amax")
        torch.testing.assert_close(out.cpu().double(), oracle, rtol=0,
                                   atol=1e-5)


# chip_smoke.py's flash cases a (the prefill path's shape), e (ragged
# edges), f (Sq != Sk: the top-left mask), g (qwen2.5-14b's smoke heads,
# head_dim 8) and i (qwen2-moe-a2.7b's prefill, 16 / 16 heads):
# (B, H, KV, Sq, Sk, d)
FLASH_CASES = {"a": (4, 16, 8, 64, 64, 128), "e": (2, 4, 2, 100, 100, 64),
               "f": (1, 4, 2, 64, 192, 128), "g": (2, 8, 2, 100, 100, 8),
               "i": (4, 16, 16, 64, 64, 128)}


def _qkv(gen, dev, B, H, KV, Sq, Sk, d, dtype):
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((B, H, Sq, d), (B, KV, Sk, d), (B, KV, Sk, d))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [
    (torch.float32, 1e-4),      # the same f32 sums in another order
    (torch.bfloat16, 3e-2),     # one bf16 ulp of |o| ~ 2-4 on the rounding
    (torch.float16, 4e-3)])     # two f16 ulps of |o| ~ 2-4
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_cuda_flash_attention_matches_plain(cuda_device, case, dtype, atol):
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v = _qkv(gen, cuda_device, *FLASH_CASES[case], dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    # the model's (B, S, heads, d) layout, read through the strides
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
    strided = flash_attention(*views, causal=True)
    assert strided.stride() == views[0].stride()
    assert torch.equal(strided, got)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [8, 16, 24, 48, 96, 256])
def test_cuda_flash_attention_head_dims(cuda_device, d, causal):
    """Every head-dim bucket of the kernel (32, 64, 128, 256; d padded up
    to a multiple of 16 inside it) on a ragged length, float32."""
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    q, k, v = _qkv(gen, cuda_device, 2, 6, 3, 70, 70, d, torch.float32)
    got = flash_attention(q, k, v, causal=causal)
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 13])
def test_cuda_flash_attention_unaligned_rows(cuda_device, d):
    """Rows of 3 or 13 bf16 (no 16-byte chunks) and a sliced, offset base:
    the element-wise load path."""
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    q, k, v = _qkv(gen, cuda_device, 2, 4, 2, 50, 50, d + 1, torch.bfloat16)
    q, k, v = q[..., 1:], k[..., 1:], v[..., 1:]
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=3e-2)


@pytest.mark.cuda
def test_cuda_prefill_launches_flash_once_per_layer(cuda_device):
    """A full-width qwen3-0.6b engine run: every prefill call launches the
    flash-attention kernel once per layer (28), every decode step the
    segment fold once."""
    from repro_torch.serving import ServeConfig, build_engine

    config = ServeConfig(arch="qwen3-0.6b", full=True, num_slots=4,
                         prefill_buckets=(16, 32), max_new_tokens=4,
                         prefill_batch=2)
    eng = build_engine(config, device=cuda_device)
    flash0, fold0 = flash_attention.launches, segment_fold.launches
    for prompt in ([5, 9, 2, 7], [11, 3] * 9, [6, 6, 6], list(range(1, 30))):
        eng.submit(prompt)
    for _ in eng.run(max_steps=50):
        pass
    torch.cuda.synchronize()
    assert eng.stats.prefill_calls >= 2 and eng.stats.completed == 4
    assert flash_attention.launches - flash0 == 28 * eng.stats.prefill_calls
    assert segment_fold.launches - fold0 == eng.stats.steps


# flash_attention with per-row query offsets (the prefix cache's warm
# prefill): (B, H, KV, Sq, Sk, d, offsets)
FLASH_OFFSET_CASES = {
    "serve": (4, 16, 8, 16, 96, 128, (0, 20, 44, 60)),
    "ragged": (3, 4, 2, 37, 150, 64, (0, 50, 113)),
    "d8": (2, 8, 2, 20, 70, 8, (7, 50)),
    "long": (2, 16, 8, 128, 4096, 128, (3968, 2000))}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [
    (torch.float32, 1e-4), (torch.bfloat16, 3e-2), (torch.float16, 4e-3)])
@pytest.mark.parametrize("case", sorted(FLASH_OFFSET_CASES))
def test_cuda_flash_attention_query_offsets(cuda_device, case, dtype, atol):
    """Query i of row b at q_offset[b] + i against the plain version; the
    keys read through the strides of a (B, Sk, KV, d) cache; offsets of
    zero give the top-left call's output bit for bit."""
    B, H, KV, Sq, Sk, d, offsets = FLASH_OFFSET_CASES[case]
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v = _qkv(gen, cuda_device, B, H, KV, Sq, Sk, d, dtype)
    off = torch.tensor(offsets, dtype=torch.int32, device=cuda_device)
    before = flash_attention.launches
    got = flash_attention(q, k, v, q_offset=off)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, q_offset=off)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    kc, vc = (t.transpose(1, 2).contiguous() for t in (k, v))  # the cache
    strided = flash_attention(q, kc.transpose(1, 2), vc.transpose(1, 2),
                              q_offset=off)
    assert torch.equal(strided, got)
    zero = torch.zeros_like(off)
    assert torch.equal(flash_attention(q, k, v, q_offset=zero),
                       flash_attention(q, k, v))


@pytest.mark.cuda
def test_cuda_warm_prefill_launches_flash_once_per_layer(cuda_device):
    """A full-width qwen3-0.6b engine with the prefix cache on (the
    default) over prompts that share a prefix: the warm prefills hit the
    trie and launch the flash-attention kernel once per layer, like the
    cold ones, and the stats fold accounts for every resident byte."""
    from repro_torch.serving import ServeConfig, build_engine

    config = ServeConfig(arch="qwen3-0.6b", full=True, num_slots=2,
                         prefill_buckets=(8, 32), max_new_tokens=3,
                         prefill_batch=2)
    eng = build_engine(config, device=cuda_device)
    shared = list(range(100, 120))
    flash0 = flash_attention.launches
    for tail in ([1, 2], [3], [4, 5, 6], [7, 8]):
        eng.submit(shared + tail)
    for _ in eng.run(max_steps=50):
        pass
    torch.cuda.synchronize()
    assert eng.prefix.stats.hit_tokens >= 2 * 20
    assert flash_attention.launches - flash0 == 28 * eng.stats.prefill_calls
    assert eng.prefix.accounted_bytes() == eng.prefix.total_bytes
    assert sum(eng.compile_counts().values()) <= eng.compile_bound()


# flash_attention with a sliding window (gemma3's local layers): (B, H, KV,
# Sq, Sk, d, offsets or None, window)
FLASH_WINDOW_CASES = {
    "gemma_cold": (2, 4, 1, 1024, 1024, 256, None, 512),
    "ragged": (3, 4, 2, 600, 600, 64, None, 100),
    "gemma_warm": (4, 4, 1, 128, 1024, 256, (0, 300, 600, 896), 512),
    "tiny": (2, 8, 2, 70, 70, 8, None, 1),
    "below_tile": (2, 4, 2, 37, 150, 24, (0, 113), 17),
    "cache_long": (2, 4, 1, 128, 1024, 256, (0, 896), 1024)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [
    (torch.float32, 1e-4), (torch.bfloat16, 3e-2), (torch.float16, 4e-3)])
@pytest.mark.parametrize("case", sorted(FLASH_WINDOW_CASES))
def test_cuda_flash_attention_sliding_window(cuda_device, case, dtype, atol):
    """Keys qp - window < k <= qp against the plain version, with and
    without per-row query offsets, one launch per call; a window as long as
    the keys gives the windowless call's output bit for bit."""
    B, H, KV, Sq, Sk, d, offsets, window = FLASH_WINDOW_CASES[case]
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    q, k, v = _qkv(gen, cuda_device, B, H, KV, Sq, Sk, d, dtype)
    off = None if offsets is None else torch.tensor(
        offsets, dtype=torch.int32, device=cuda_device)
    before = flash_attention.launches
    got = flash_attention(q, k, v, q_offset=off, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, q_offset=off, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    if window >= Sk:
        assert torch.equal(got, flash_attention(q, k, v, q_offset=off))


@pytest.mark.cuda
def test_cuda_window_folds_launch_the_kernel_once(cuda_device):
    """tumbling_fold (sum_, max_) and session_fold on the card take the
    kernel tier: one segment_fold launch each, exact against the CPU."""
    import numpy as np

    from repro_torch.core import monoids
    from repro_torch.data import session_fold, sessionize, tumbling_fold

    rng = np.random.default_rng(10)
    n = 1 << 16
    ts = np.sort(rng.uniform(0.0, 64 * 0.37 * 1.01, n))
    vals = rng.integers(-100, 101, n).astype(np.float32)
    sids, n_sess = sessionize(rng.integers(0, 256, n), ts, gap=1.0)
    v_gpu = torch.from_numpy(vals).to(cuda_device)
    v_cpu = torch.from_numpy(vals)
    for m in (monoids.sum_, monoids.max_):
        before = segment_fold.launches
        got, plan = tumbling_fold(m, v_gpu, ts, width=0.37, num_windows=64,
                                  with_plan=True)
        torch.cuda.synchronize()
        assert segment_fold.launches == before + 1
        assert plan.local_tier.kind == "kernel"
        want = tumbling_fold(m, v_cpu, ts, width=0.37, num_windows=64)
        assert torch.equal(got.cpu(), want)
    before = segment_fold.launches
    got = session_fold(monoids.sum_, v_gpu, sids, n_sess)
    torch.cuda.synchronize()
    assert segment_fold.launches == before + 1
    assert torch.equal(got.cpu(), session_fold(monoids.sum_, v_cpu, sids,
                                               n_sess))


# ---------------------------------------------------------------------------
# MoE (qwen2-moe-a2.7b): the grouped expert products and the served tokens
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("tokens", [8, 256])
def test_cuda_grouped_product_matches_the_loop(cuda_device, tokens):
    """qwen2-moe-a2.7b's experts at full width (64 of 2048 x 1408, bf16):
    tokens routed by the layer's router at the decode (8 x top-4) and
    prefill (4 x 64 x top-4) shapes; ``grouped_mm`` against one matmul per
    expert within ``chip_smoke.grouped_tolerance``, the group sizes exact
    and the 4 pad experts empty."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config("qwen2-moe-a2.7b")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    p = moe.init_moe(cfg, gen, device=cuda_device)
    x = torch.randn((tokens, cfg.d_model), generator=gen, device=cuda_device
                    ).to(cfg.dtype)
    xbuf, gs, order, top_w = moe.dispatch(p, cfg, x)
    top_e, _ = moe.route(p, cfg, x)
    want_gs = torch.bincount(top_e.reshape(-1).long(),
                             minlength=cfg.num_experts).to(torch.int32)
    assert torch.equal(gs, want_gs) and int(gs[-4:].sum()) == 0
    got = moe.expert_compute(p, xbuf, gs)
    want = moe.expert_compute_plain(p, xbuf, gs)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    err = float((got.float() - want.float()).abs().max())
    assert err <= _chip_smoke().grouped_tolerance(want), err


@pytest.mark.cuda
def test_cuda_moe_decode_step_replays_from_a_graph(cuda_device):
    """The MoE decode step (bf16 smoke model, 8 slots) reads nothing back to
    the host: it captures in a CUDA graph, and the replay's logits and KV
    rows equal the eager step's bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_cache, init_params

    cfg = get_config("qwen2-moe-a2.7b", smoke=True)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    params = init_params(cfg, gen, device=cuda_device)
    tok = torch.randint(1, cfg.vocab_size, (8, 1), dtype=torch.int32,
                        device=cuda_device)

    def fresh():
        cache = init_cache(params, cfg, 8, 32, pos_per_slot=True)
        cache["pos"].copy_(torch.arange(8, dtype=torch.int32) * 3)
        return cache

    eager_cache = fresh()
    want, _ = decode_step(params, cfg, eager_cache, tok)
    cache = fresh()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode_step(params, cfg, fresh(), tok)      # warm-up off the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got, _ = decode_step(params, cfg, cache, tok)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for a, b in zip(cache["layers"], eager_cache["layers"]):
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("prefix_cache", [False, True])
def test_cuda_moe_smoke_model_serves_the_cpus_tokens(cuda_device, temperature,
                                                     prefix_cache):
    """The float32 qwen2-moe smoke model (8 experts, 1 pad, top-2, 2
    shared) served on the card and on the CPU with the same weights: the
    same tokens, greedy and at 0.8, with the prefix cache off and on."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import ContinuousEngine, ServeConfig, make_backend

    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b", smoke=True),
                              dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    shared = [7, 7, 1, 9, 4, 4, 2, 8]
    prompts = [shared + [5, 9], [11, 3, 7], shared + [6], [3] * 13,
               shared[:4] + [1, 2, 3], shared + [2, 2, 2, 2, 2]]
    config = ServeConfig(arch="qwen2-moe-a2.7b", num_slots=3,
                         prefill_buckets=(8, 16), max_new_tokens=5,
                         prefill_batch=2, temperature=temperature, seed=4,
                         prefix_cache=prefix_cache, prefix_block=2)
    results = {}
    for dev in ("cpu", cuda_device):
        p = pytree.tree_map(lambda t: t.to(dev), params)
        eng = ContinuousEngine(make_backend(cfg, p, config, dev), config)
        uids = [eng.submit(x) for x in prompts]
        before = flash_attention.launches
        for _ in eng.run(max_steps=100):
            pass
        launched = flash_attention.launches - before
        assert launched == (cfg.num_layers * eng.stats.prefill_calls
                            if torch.device(dev).type == "cuda" else 0)
        results[dev] = [eng.result(u) for u in uids]
    assert prefix_cache == (eng.prefix is not None)
    for a, b in zip(results["cpu"], results[cuda_device]):
        assert a.tokens == b.tokens
        assert abs(a.logprob_sum - b.logprob_sum) < 1e-3


# chip_smoke.py's context cases x1 (whisper-small's encoder), x2 (its
# cross-attention in forward: Sq 64 over Sk 1500) and x3 (llama-3.2-vision's
# cross-attention, Sq 64 over 1600 patches): (B, H, KV, Sq, Sk, d),
# non-causal
CONTEXT_FLASH_CASES = {"x1": (8, 12, 12, 1500, 1500, 64),
                       "x2": (8, 12, 12, 64, 1500, 64),
                       "x3": (4, 64, 8, 64, 1600, 128)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [
    (torch.float32, 1e-4), (torch.bfloat16, 3e-2), (torch.float16, 4e-3)])
@pytest.mark.parametrize("case", sorted(CONTEXT_FLASH_CASES))
def test_cuda_flash_attention_context_shapes(cuda_device, case, dtype, atol):
    """Non-causal attention at Sq == Sk 1500 (no tile multiple) and Sq !=
    Sk: one launch, equal to the plain version within phase 2's
    tolerances, in the model's (B, S, heads, d) layout too."""
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    q, k, v = _qkv(gen, cuda_device, *CONTEXT_FLASH_CASES[case], dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=False)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
    assert torch.equal(flash_attention(*views, causal=False), got)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-small", "llama-3.2-vision-90b"])
def test_cuda_context_smoke_model_equals_the_cpu(cuda_device, arch):
    """The float32 smoke model (gates 0.5) on the card and the CPU with the
    same weights and context: ``forward(context=)`` logits within 1e-4
    (one ``flash_attention`` launch per encoder, self- and cross-attention
    on the card), and 16 greedy serve steps give the same tokens."""
    from repro_torch.configs import get_config

    err, cpu_tokens, card_tokens, launched = \
        _chip_smoke().context_reference_run(arch, 0)
    cfg = get_config(arch, smoke=True)
    assert err <= 1e-4
    assert torch.equal(cpu_tokens, card_tokens)
    assert launched == (cfg.encoder_layers + 2 * cfg.num_layers
                        if cfg.decoder_cross_attn else cfg.num_layers)


@pytest.mark.cuda
def test_cuda_whisper_decode_step_replays_from_a_graph(cuda_device):
    """whisper-small's bf16 smoke decode step over a context cache (8
    slots) reads nothing back to the host: it captures in a CUDA graph, and
    one replay's logits and cache equal the eager step's bit for bit; no
    ``flash_attention`` launch in the step."""
    chip_smoke = _chip_smoke()
    cfg, params, context = chip_smoke.context_model(
        "whisper-small", 1, dtype=torch.bfloat16, device=cuda_device,
        batch=8)
    from repro_torch.models import init_cache

    cache = init_cache(params, cfg, 8, 32, context=context)
    tok = torch.randint(1, cfg.vocab_size, (8, 1), dtype=torch.int32,
                        device=cuda_device)
    before = flash_attention.launches
    _, _, equal = chip_smoke.step_eager_vs_graph(cfg, params, cache, tok,
                                                 iters=2)
    assert equal
    assert flash_attention.launches == before


# chip_smoke.py's case j: jamba-v0.1-52b's attention layer in a (4, 64)
# forward, (B, H, KV, Sq, Sk, d), causal
JAMBA_FLASH_CASE = (4, 32, 8, 64, 64, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [
    (torch.float32, 1e-4), (torch.bfloat16, 3e-2), (torch.float16, 4e-3)])
def test_cuda_flash_attention_jamba_shape(cuda_device, dtype, atol):
    """Causal GQA at 32 / 8 x 128 heads (4 query heads per K/V head): one
    launch, equal to the plain version within phase 2's tolerances."""
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    q, k, v = _qkv(gen, cuda_device, *JAMBA_FLASH_CASE, dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["xlstm-1.3b", "jamba-v0.1-52b"])
def test_cuda_recurrent_smoke_model_equals_the_cpu(cuda_device, arch):
    """The float32 smoke model on the card and the CPU with the same
    weights: ``forward`` logits within 1e-4 (jamba's attention layer one
    ``flash_attention`` launch), and ``build_engine``'s greedy tokens for
    prompts shorter than their buckets equal, ``segment_fold`` once per
    engine step."""
    err, cpu_tokens, card_tokens, launched, folds, steps = \
        _chip_smoke().recurrent_reference_run(arch, 0)
    assert err <= 1e-4
    assert cpu_tokens == card_tokens
    assert launched == (1 if arch == "jamba-v0.1-52b" else 0)
    assert folds == steps > 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["xlstm-1.3b", "jamba-v0.1-52b"])
def test_cuda_recurrent_decode_step_replays_from_a_graph(cuda_device, arch):
    """The bf16 smoke decode step (8 slots) advances its recurrent states
    in place and reads nothing back to the host: it captures in a CUDA
    graph, and one replay's logits and cache equal the eager step's bit
    for bit; no ``flash_attention`` launch in the step."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_cache, init_params

    chip_smoke = _chip_smoke()
    cfg = get_config(arch, smoke=True)
    params = init_params(cfg, torch.Generator(device=cuda_device)
                         .manual_seed(1), device=cuda_device)
    cache = init_cache(params, cfg, 8, 32)
    toks = torch.randint(1, cfg.vocab_size, (8, 5), dtype=torch.int32,
                         device=cuda_device)
    chip_smoke.feed_prompt(cfg, params, cache, toks[:, :4])
    before = flash_attention.launches
    _, _, equal = chip_smoke.step_eager_vs_graph(cfg, params, cache,
                                                 toks[:, 4:], iters=2)
    assert equal
    assert flash_attention.launches == before


# (B, H, KV, Sq, Sk, d, causal, window): the backward's contract at small
# shapes -- head-dim buckets, GQA, ragged tiles, Sq != Sk, the window; the
# wgmma design's edges: d 64 / 128 / 256, Sq and Sk off the 64-row tile,
# GQA groups of 1, 2 and 8, window 512 at d 256
FLASH_BWD_CASES = {
    "d8 GQA causal": (2, 4, 2, 37, 37, 8, True, None),
    "d40 causal ragged": (2, 4, 1, 100, 100, 40, True, None),
    "d128 GQA causal": (1, 8, 2, 130, 130, 128, True, None),
    "d256 window": (1, 4, 1, 200, 200, 256, True, 48),
    "d64 non-causal Sq<Sk": (2, 3, 3, 50, 170, 64, False, None),
    "d40 non-causal Sq>Sk": (1, 4, 2, 90, 33, 40, False, None),
    "d128 window 3": (1, 2, 1, 70, 70, 128, True, 3),
    "d64 GQA8 causal ragged": (2, 8, 1, 100, 100, 64, True, None),
    "d128 GQA2 causal S300": (2, 4, 2, 300, 300, 128, True, None),
    "d128 GQA1 non-causal Sq>Sk": (1, 3, 3, 200, 77, 128, False, None),
    "d256 window 512 ragged": (1, 4, 1, 1100, 1100, 256, True, 512),
    "d256 GQA2 non-causal Sq>Sk": (1, 4, 2, 130, 70, 256, False, None),
    "d128 causal Sk>Sq": (1, 2, 1, 40, 90, 128, True, None),
    "d128 window past int32": (1, 2, 1, 70, 70, 128, True, 1 << 40),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2),
                                        (torch.float16, 2e-2)])
@pytest.mark.parametrize("case", sorted(FLASH_BWD_CASES))
def test_cuda_flash_attention_backward_matches_plain(cuda_device, case,
                                                     dtype, rtol):
    """The backward kernel (through the autograd Function) against
    ``flash_attention_backward_plain`` in f32 on the same inputs: each of
    dq, dk, dv within ``rtol`` of its max magnitude (16-bit: one rounding
    of each gradient and of the forward's o); one backward launch per
    call; the forward's output equal to the no-grad launch's bit for
    bit."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_plain, flash_attention_bwd)

    B, H, KV, Sq, Sk, d, causal, window = FLASH_BWD_CASES[case]
    gen = torch.Generator(device=cuda_device).manual_seed(Sq + d)
    q, k, v = [torch.randn(s, generator=gen, device=cuda_device).to(dtype)
               .requires_grad_() for s in
               ((B, H, Sq, d), (B, KV, Sk, d), (B, KV, Sk, d))]
    do = torch.randn((B, H, Sq, d), generator=gen,
                     device=cuda_device).to(dtype)
    f0, b0 = flash_attention.launches, flash_attention_bwd.launches
    o = flash_attention(q, k, v, causal=causal, window=window)
    got = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    assert flash_attention.launches == f0 + 1
    assert flash_attention_bwd.launches == b0 + 1
    with torch.no_grad():
        plain_launch = flash_attention(q, k, v, causal=causal, window=window)
    assert torch.equal(o.detach(), plain_launch)
    want = flash_attention_backward_plain(
        q.detach().float(), k.detach().float(), v.detach().float(),
        o.detach().float(), do.float(), causal=causal, window=window)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        assert float((g.float() - w).abs().max()) <= \
            rtol * float(w.abs().max())


def _bwd_inputs(device, shape, dtype, seed=0):
    B, H, KV, Sq, Sk, d = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = [torch.randn(s, generator=gen, device=device).to(dtype)
               for s in ((B, H, Sq, d), (B, KV, Sk, d), (B, KV, Sk, d))]
    do = torch.randn((B, H, Sq, d), generator=gen, device=device).to(dtype)
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,causal,window", [
    ((2, 16, 8, 512, 512, 128), torch.bfloat16, True, None),
    ((1, 4, 1, 700, 700, 256), torch.bfloat16, True, 512),
    ((2, 4, 4, 300, 300, 64), torch.float16, False, None),
    ((2, 4, 2, 100, 100, 40), torch.bfloat16, True, None),
    ((2, 4, 2, 100, 100, 40), torch.float32, True, None),
])
def test_cuda_flash_attention_backward_is_deterministic(
        cuda_device, shape, dtype, causal, window):
    """Two backward calls on the same inputs give bit-identical dq, dk, dv
    in every design: each sum is taken in one fixed order, no atomics."""
    from repro_torch.kernels.flash_attention import (_launch,
                                                     flash_attention_bwd)

    q, k, v, do = _bwd_inputs(cuda_device, shape, dtype, seed=shape[3])
    B, H, Sq = q.shape[:3]
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=cuda_device)
    o = _launch(q, k, v, causal, None, window, lse)
    first = flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                window=window)
    second = flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                 window=window)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,design", [
    ((1, 16, 8, 1024, 1024, 128), torch.bfloat16, "wgmma"),
    ((2, 4, 1, 1024, 1024, 256), torch.bfloat16, "wgmma"),
    ((2, 12, 12, 64, 1500, 64), torch.bfloat16, "wgmma"),
    ((2, 4, 2, 100, 100, 40), torch.bfloat16, "mma_sync"),
    ((2, 4, 2, 100, 100, 40), torch.float32, "cuda_cores"),
])
def test_cuda_flash_attention_backward_design(cuda_device, shape, dtype,
                                              design):
    """t1's shape at B 1 (and t2's, t4's) runs the wgmma design, d 40 the
    mma.sync kernels and f32 the CUDA cores: one backward launch each,
    ``last_design`` naming the design, the gradients within the 16-bit /
    f32 tolerance of the plain version."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_plain, flash_attention_bwd)

    q, k, v, do = _bwd_inputs(cuda_device, shape, dtype)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = flash_attention_bwd.launches
    o = flash_attention(q, k, v, causal=True)
    got = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    assert flash_attention_bwd.last_design == design
    want = flash_attention_backward_plain(
        q.detach().float(), k.detach().float(), v.detach().float(),
        o.detach().float(), do.float(), causal=True)
    rtol = 1e-4 if dtype == torch.float32 else 2e-2
    for g, w in zip(got, want):
        assert float((g.float() - w).abs().max()) <= \
            rtol * float(w.abs().max())


@pytest.mark.cuda
def test_cuda_flash_attention_backward_empty_and_strided(cuda_device):
    """Keys no query sees get zero dk / dv (causal Sk > Sq); inputs read
    through (B, S, heads, d) strides, as the model passes them."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_plain)

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((2, 40, 6, 32), generator=gen, device=cuda_device)
    q = x[:, :, :4].transpose(1, 2).detach().requires_grad_()
    kv = torch.randn((2, 90, 2, 32), generator=gen, device=cuda_device)
    k = kv[:, :, :1].transpose(1, 2).detach().requires_grad_()
    v = kv[:, :, 1:].transpose(1, 2).detach().requires_grad_()
    o = flash_attention(q, k, v, causal=True)
    do = torch.randn_like(o)
    dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)
    want = flash_attention_backward_plain(q.detach(), k.detach(), v.detach(),
                                          o.detach(), do, causal=True)
    for g, w in zip((dq, dk, dv), want):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
    assert float(dk[:, :, 40:].abs().max()) == 0.0
    assert float(dv[:, :, 40:].abs().max()) == 0.0
    # window 1: each query sees only its own key, so P = 1 and dS = P (dP -
    # D) = 0: dq and dk vanish up to the rounding of D, dv is do
    q1, k1, v1 = (torch.randn((1, 2, 70, 128), generator=gen,
                              device=cuda_device).to(torch.bfloat16)
                  .requires_grad_() for _ in range(3))
    o1 = flash_attention(q1, k1, v1, causal=True, window=1)
    do1 = torch.randn_like(o1)
    dq1, dk1, dv1 = torch.autograd.grad(o1, (q1, k1, v1), do1)
    assert torch.equal(o1.detach(), v1.detach())
    assert torch.equal(dv1, do1)
    assert float(dq1.abs().max()) <= 1e-3 and float(dk1.abs().max()) <= 1e-3


@pytest.mark.cuda
def test_cuda_train_smoke_matches_cpu(cuda_device):
    """chip_smoke phase 14(b): the f32 qwen3 smoke model trains 5 steps (2
    microbatches, remat) on the card and on the CPU from the same weights
    and batches; loss and grad_norm within 1e-4 at every step."""
    import argparse
    _chip_smoke().train_smoke_card_vs_cpu(argparse.Namespace(seed=0))


# MLA (deepseek-v2-236b): chip_smoke.py's cases m1 (the engine's (4, 64)
# bucket), m2 (S 4096) and m3 (the warm call at per-row offsets) at q / k
# 192, v 128, 128 heads: (B, H, KV, Sq, Sk, d, dv, offsets)
MLA_FLASH_CASES = {"m1": (4, 128, 128, 64, 64, 192, 128, None),
                   "m2": (1, 128, 128, 4096, 4096, 192, 128, None),
                   "m3": (4, 128, 128, 16, 96, 192, 128, (0, 20, 44, 80))}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [
    (torch.float32, 1e-4), (torch.bfloat16, 3e-2), (torch.float16, 4e-3)])
@pytest.mark.parametrize("case", sorted(MLA_FLASH_CASES))
def test_cuda_flash_attention_mla_shapes(cuda_device, case, dtype, atol):
    """The kernel at dv != d (the (256, 128) column buckets) against its
    plain version, one launch, a (B, H, Sq, dv) output; through the
    model's (B, S, heads, d) views the output keeps the (B, S, H, dv)
    layout and the same values."""
    B, H, KV, Sq, Sk, d, dv, offsets = MLA_FLASH_CASES[case]
    gen = torch.Generator(device=cuda_device).manual_seed(15)
    q, k = _qkv(gen, cuda_device, B, H, KV, Sq, Sk, d, dtype)[:2]
    v = torch.randn((B, KV, Sk, dv), generator=gen,
                    device=cuda_device).to(dtype)
    off = None if offsets is None else torch.tensor(
        offsets, dtype=torch.int32, device=cuda_device)
    before = flash_attention.launches
    got = flash_attention(q, k, v, q_offset=off)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, H, Sq, dv)
    want = flash_attention_plain(q, k, v, q_offset=off)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
    strided = flash_attention(*views, q_offset=off)
    assert strided.transpose(1, 2).is_contiguous()
    assert torch.equal(strided, got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("d,dv", [(96, 64), (96, 128), (192, 64),
                                  (192, 128), (64, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention_v_head_dims(cuda_device, d, dv, causal, dtype,
                                          atol):
    """dv in {64, 128} at d in {96, 192} (and dv > d), GQA 2:1, ragged
    lengths (Sq 77, Sk 77 causal / 150 not), against the plain version."""
    Sk = 77 if causal else 150
    gen = torch.Generator(device=cuda_device).manual_seed(d + dv)
    q, k = _qkv(gen, cuda_device, 2, 4, 2, 77, Sk, d, dtype)[:2]
    v = torch.randn((2, 2, Sk, dv), generator=gen,
                    device=cuda_device).to(dtype)
    got = flash_attention(q, k, v, causal=causal)
    want = flash_attention_plain(q, k, v, causal=causal)
    assert got.shape == (2, 4, 77, dv)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
def test_cuda_mla_backward_pads_v_to_d(cuda_device, dtype, rtol):
    """The backward at m1's shape (d 192, dv 128): the kernel runs on v, o
    and do zero-padded to 192 columns (``mma_sync`` for bf16, the CUDA
    cores for f32) and slices dV back; each gradient within ``rtol`` of
    its max magnitude of the f32 plain backward at dv columns."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_plain, flash_attention_bwd)

    B, H, KV, Sq, Sk, d, dv, _ = MLA_FLASH_CASES["m1"]
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = [torch.randn(s, generator=gen, device=cuda_device).to(dtype)
               .requires_grad_() for s in
               ((B, H, Sq, d), (B, KV, Sk, d), (B, KV, Sk, dv))]
    do = torch.randn((B, H, Sq, dv), generator=gen,
                     device=cuda_device).to(dtype)
    b0 = flash_attention_bwd.launches
    o = flash_attention(q, k, v)
    got = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == b0 + 1
    assert flash_attention_bwd.last_design == (
        "cuda_cores" if dtype == torch.float32 else "mma_sync")
    want = flash_attention_backward_plain(
        q.detach().float(), k.detach().float(), v.detach().float(),
        o.detach().float(), do.float())
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.shape == t.shape and g.dtype == dtype
        assert float((g.float() - w).abs().max()) <= \
            rtol * float(w.abs().max())


@pytest.mark.cuda
def test_cuda_deepseek_smoke_model_equals_the_cpu(cuda_device):
    """chip_smoke.py's phase 15(b): the float32 deepseek-v2 smoke model on
    the card and the CPU: forward logits and ``loss_fn``'s loss and
    gradient norm within 1e-4, engine tokens equal with the prefix cache
    on and off, greedy and at 0.8 (it raises on any difference)."""
    import argparse

    _chip_smoke().deepseek_reference(argparse.Namespace(seed=0))


@pytest.mark.cuda
def test_cuda_deepseek_decode_step_replays_from_a_graph(cuda_device):
    """The bf16 deepseek-v2 smoke decode step (8 slots; MLA's
    weight-absorbed form and the MoE layers) writes its latent rows in
    place and reads nothing back to the host: it captures in a CUDA
    graph, one replay equals the eager step bit for bit, and it launches
    no ``flash_attention``."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_cache, init_params

    chip_smoke = _chip_smoke()
    cfg = get_config("deepseek-v2-236b", smoke=True)
    params = init_params(cfg, torch.Generator(device=cuda_device)
                         .manual_seed(1), device=cuda_device)
    cache = init_cache(params, cfg, 8, 32, pos_per_slot=True)
    toks = torch.randint(1, cfg.vocab_size, (8, 5), dtype=torch.int32,
                         device=cuda_device)
    chip_smoke.feed_prompt(cfg, params, cache, toks[:, :4])
    before = flash_attention.launches
    _, _, equal = chip_smoke.step_eager_vs_graph(cfg, params, cache,
                                                 toks[:, 4:], iters=2)
    assert equal
    assert flash_attention.launches == before


def _sharded_max_by_key_rank(rank, world, store_path):
    """One rank of a gloo world on cuda:0: max-by-key through run_sharded,
    each strategy, against run_local(num_shards=world)."""
    from repro_torch.core import MapReduceJob, monoids
    from repro_torch.launch.mesh import init_distributed, make_mesh

    dev = torch.device("cuda", 0)
    init_distributed("gloo", rank, world,
                     torch.distributed.FileStore(store_path, world),
                     device=dev)
    mesh = make_mesh((world,), ("data",))
    gen = torch.Generator(device=dev).manual_seed(0)
    recs = {"key": torch.randint(0, 4096, (1 << 16,), generator=gen,
                                 device=dev, dtype=torch.int32),
            "value": torch.randn((1 << 16,), generator=gen, device=dev)}
    job = MapReduceJob(mapper=lambda r: (r["key"], r["value"]),
                       monoid=monoids.max_, num_keys=4096)
    out = {}
    for strategy in ("naive", "combiner"):
        segment_fold.launches = 0
        got = job.run_sharded(recs, mesh, strategy=strategy)
        torch.cuda.synchronize()
        launches = segment_fold.launches
        want = job.run_local(recs, strategy=strategy, num_shards=world)
        plan = job.plan(recs, strategy=strategy, num_shards=world,
                        axis_name="data")
        out[strategy] = (torch.equal(got, want), launches,
                         plan.local_tier.kind)
    return out


@pytest.mark.cuda
def test_cuda_run_sharded_max_by_key_on_two_gloo_ranks(cuda_device,
                                                       tmp_path):
    """Two gloo ranks share the one card (NCCL refuses two ranks on one
    device): run_sharded's max-by-key table equals run_local(num_shards=2)
    exactly, each rank's fold one segment_fold launch."""
    from repro_torch.launch.mesh import run_world

    for rank, res in enumerate(run_world(_sharded_max_by_key_rank, 2,
                                         timeout_s=240,
                                         store_dir=str(tmp_path))):
        for strategy, (equal, launches, tier) in res.items():
            assert equal, (rank, strategy)
            assert tier == "kernel" and launches == 1, (rank, strategy,
                                                        launches)


@pytest.mark.cuda
def test_cuda_embedding_backward_is_deterministic(cuda_device):
    """Two backwards of the same batch through the bf16 qwen3 smoke model
    on the card give bit-equal gradients (the embedding's rows are added
    in a fixed order, ``add_rows``), and ``add_rows`` on the card equals
    ``add_rows`` on the CPU bit for bit, a hot id included."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import _grad_fn
    from repro_torch.models import RunCtx, init_params
    from repro_torch.models.common import add_rows

    cfg = get_config("qwen3-0.6b", smoke=True)
    params = init_params(cfg, torch.Generator(device=cuda_device)
                         .manual_seed(0), device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 256), generator=gen,
                         device=cuda_device, dtype=torch.int32)
    toks[:, ::3] = 7
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    grad = _grad_fn(cfg, RunCtx())
    first, second = grad(params, batch)[1], grad(params, batch)[1]
    for a, b in zip(pytree.tree_leaves(first), pytree.tree_leaves(second)):
        assert torch.equal(a, b)
    rows = torch.randn((toks.numel(), 64), generator=gen,
                       device=cuda_device).to(torch.bfloat16)
    assert torch.equal(add_rows(cfg.vocab_size, toks, rows).cpu(),
                       add_rows(cfg.vocab_size, toks.cpu(), rows.cpu()))


def _mesh_train_rank(rank, world, store_path):
    """One rank of a (1, 2) gloo world on cuda:0: the f32 smoke qwen3's
    step at mesh (1, 2) and on one rank, the same weights and batch."""
    import dataclasses as dc

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import RunCtx, init_params
    from repro_torch.optim import init_opt_state

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    init_distributed("gloo", rank, world,
                     torch.distributed.FileStore(store_path, world),
                     device=dev)
    mesh = make_mesh((1, 2), ("data", "model"), device=dev)
    cfg = dc.replace(get_config("qwen3-0.6b", smoke=True),
                     dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                         device=dev, dtype=torch.int32)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    ctx = RunCtx(remat="full", ce_chunk=16)
    built = make_train_step(cfg, mesh, ctx=ctx, num_microbatches=2)
    _, _, one = make_train_step(cfg, ctx=ctx, num_microbatches=2)(
        params, init_opt_state(params), batch)
    p, o, b = built.local(params, init_opt_state(params), batch)
    _, _, got = built.fn(p, o, b)
    return {k: (float(got[k]), float(one[k])) for k in ("loss",
                                                         "grad_norm")}


@pytest.mark.cuda
def test_cuda_mesh_train_step_matches_one_rank(cuda_device, tmp_path):
    """The train step at mesh (1, 2) on two gloo ranks sharing the card
    (autograd runs its backward, and the checkpointed layers' recompute, on
    the card's own thread, which sees no mesh scope): loss and grad_norm
    within 1e-5 relative of one rank's step."""
    from repro_torch.launch.mesh import run_world

    for res in run_world(_mesh_train_rank, 2, timeout_s=300,
                         store_dir=str(tmp_path)):
        for k, (got, want) in res.items():
            assert abs(got - want) <= 1e-5 * abs(want), (k, got, want)


def _mla_mesh_backward_rank(rank, world, store_path, device="cuda:0"):
    """One rank of a (1, ``world``) gloo world: deepseek-v2's bf16 smoke
    model cut to its dense prelude layer (MLA, the dense FFN) at model
    ``world``, ``loss_fn``'s gradients on this rank's blocks through
    ``flash_attention`` and its backward kernel, then through the plain
    version differentiated by autograd, from the same blocks and batch."""
    import dataclasses as dc

    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.models import RunCtx, attention, init_params, loss_fn
    from repro_torch.models.transformer import param_axes

    dev = torch.device(device)
    init_distributed("gloo", rank, world,
                     torch.distributed.FileStore(store_path, world),
                     device=dev if dev.type == "cuda" else None)
    mesh = make_mesh((1, world), ("data", "model"), device=dev)
    cfg = dc.replace(get_config("deepseek-v2-236b", smoke=True),
                     num_layers=1)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    local = shd.shard_params(params, param_axes(cfg), mesh,
                             shd.TRAIN_RULES)
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                         device=dev, dtype=torch.int32)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}

    def grads():
        leaves, spec = pytree.tree_flatten(local)
        req = [t.detach().requires_grad_() for t in leaves]
        with shd.use_rules(mesh, shd.TRAIN_RULES):
            loss, _ = loss_fn(pytree.tree_unflatten(req, spec), cfg, batch,
                              RunCtx(mesh=mesh, remat="none"))
            out = torch.autograd.grad(loss, req, allow_unused=True)
        return float(loss.detach()), [torch.zeros_like(t) if g is None
                                      else g for g, t in zip(out, req)]

    b0 = flash_attention_bwd.launches
    loss_k, got = grads()
    launches = flash_attention_bwd.launches - b0
    design = flash_attention_bwd.last_design
    kernel = attention.flash_attention
    attention.flash_attention = flash_attention_plain
    try:
        loss_p, want = grads()
    finally:
        attention.flash_attention = kernel
    rel = [float((g.float() - w.float()).abs().max()) /
           max(float(w.float().abs().max()), 1e-30)
           for g, w in zip(got, want)]
    return dict(loss=(loss_k, loss_p), rel=max(rel), launches=launches,
                design=design, heads=local["layers"][0]["mix"]["wq_b"]
                .shape[1], dtypes={str(g.dtype) for g in got})


@pytest.mark.cuda
def test_cuda_mla_loss_backward_at_model_4_matches_plain(cuda_device,
                                                          tmp_path):
    """MLA trained at model 4 on four gloo ranks sharing the card (one of
    the smoke model's 4 heads a rank, at d 24 / dv 16 in bf16): the
    gradients of ``loss_fn`` on each rank's blocks through the forward and
    backward kernels (one backward launch, ``mma_sync`` with v padded) are
    within 3e-2 of each leaf's max magnitude of the same gradients through
    the plain version differentiated by autograd (the backward kernel
    rounds P and dS to bf16 for its products: 2e-2 of each attention
    gradient's max in phase 14, then the layer's products in bf16), and
    the loss within 2e-3."""
    from repro_torch.launch.mesh import run_world

    for res in run_world(_mla_mesh_backward_rank, 4, timeout_s=300,
                         store_dir=str(tmp_path)):
        assert res["heads"] == 1 and res["dtypes"] == {"torch.bfloat16"}
        assert res["launches"] == 1 and res["design"] == "mma_sync", res
        got, want = res["loss"]
        assert abs(got - want) <= 2e-3 * abs(want), res
        assert res["rel"] <= 3e-2, res
