"""Tests that need the card: the CUDA kernels against their plain versions,
and the serving (prefill and decode), stream-stats and MapReduce paths
through them.  They import no JAX (the card's machine
has none) and skip without a GPU; run them there with

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


def _device_launches(fn):
    """Kernels and memsets one call of ``fn`` puts on the card:
    ``chip_smoke.cuda_launches`` (the profiler's device events)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke.cuda_launches(fn)


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
# edges), f (Sq != Sk: the top-left mask) and g (qwen2.5-14b's smoke heads,
# head_dim 8): (B, H, KV, Sq, Sk, d)
FLASH_CASES = {"a": (4, 16, 8, 64, 64, 128), "e": (2, 4, 2, 100, 100, 64),
               "f": (1, 4, 2, 64, 192, 128), "g": (2, 8, 2, 100, 100, 8)}


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
