"""Tests that need the card: the CUDA kernels against their plain versions
and the serving path through them.  They import no JAX (the card's machine
has none) and skip without a GPU; run them there with

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import pytest
import torch
import torch.utils._pytree as pytree

from repro_torch.kernels import segment_fold, segment_fold_plain


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
