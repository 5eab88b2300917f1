"""Tests that need the card: the CUDA kernels against their plain versions,
and the serving, stream-stats and MapReduce paths through them.  They import no JAX (the card's machine
has none) and skip without a GPU; run them there with

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import pytest
import torch
import torch.utils._pytree as pytree

from repro_torch.kernels import segment_fold, segment_fold_plain
from repro_torch.kernels.cms import cms_counts, cms_counts_plain
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
