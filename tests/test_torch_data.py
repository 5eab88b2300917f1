"""The port's data pipeline and stream statistics vs the JAX package's.

``SyntheticCorpus`` is the same numpy generation, so its batches must be
the JAX package's bit for bit (dense, ragged, host-sharded); the stream
stats folded over the same batches must give bit-identical count-min, HLL
and Bloom states and counts.  A JAX state carried across with
``state_from_numpy`` continues exactly.  The last tests run the port's two
examples on the CPU and hold the streaming example's printed results
against the JAX example's paths 1-3.
"""
import contextlib
import io
import re
import runpy
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticCorpus as JSyntheticCorpus
from repro.data import init_stats as j_init_stats
from repro.data import make_stream_stats as j_make_stream_stats
from repro.data import packed_stats as j_packed_stats
from repro.data import summarize as j_summarize
from repro.data import update_stats as j_update_stats
from repro_torch.core import tree_fold
from repro_torch.data import (DataConfig, Prefetcher, SyntheticCorpus,
                              init_stats, make_stream_stats, packed_stats,
                              state_from_numpy, summarize, sync_stats,
                              update_stats)

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(vocab_size=1000, seq_len=64, global_batch=8, seed=42)


def _corpora(ragged=False, **kw):
    cfg = dict(CFG, ragged=ragged)
    return (SyntheticCorpus(DataConfig(**cfg), device="cpu", **kw),
            JSyntheticCorpus(JDataConfig(**cfg), **kw))


def _assert_state_equal(t_state, j_state):
    assert set(t_state) == set(j_state)
    for k in j_state:
        want = np.asarray(j_state[k])
        got = t_state[k].numpy()
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("hosts", [(0, 1), (1, 4)])
def test_batches_equal_jax(ragged, hosts):
    host_id, num_hosts = hosts
    tc, jc = _corpora(ragged, host_id=host_id, num_hosts=num_hosts)
    for step in (0, 5):
        tb, jb = tc(step), jc(step)
        assert set(tb) == set(jb)
        for k in jb:
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    assert tb["tokens"].shape == (8 // num_hosts, 64)


def test_context_matches_jax_in_bf16():
    tc, jc = _corpora(context_shape=(3,))
    got, want = tc(1)["context"], jc(1)["context"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("ragged", [False, True])
def test_update_stats_bit_identical(ragged):
    tc, jc = _corpora(ragged)
    tm_, jm_ = make_stream_stats(), j_make_stream_stats()
    ts, js = init_stats(tm_, device="cpu"), j_init_stats(jm_)
    _assert_state_equal(ts, js)
    for step in range(4):
        tb, jb = tc(step), jc(step)
        ts = update_stats(ts, tb["tokens"], valid_mask=tb.get("valid_mask"))
        js = j_update_stats(js, jb["tokens"], valid_mask=jb.get("valid_mask"))
    _assert_state_equal(ts, js)
    got, want = summarize(tm_, ts), j_summarize(jm_, js)
    assert got["tokens"] == want["tokens"]
    assert got["approx_distinct"] == pytest.approx(want["approx_distinct"],
                                                   rel=1e-6)


def test_streaming_equals_tree_fold_over_batches():
    tc, _ = _corpora(ragged=True)
    m = make_stream_stats()
    stream = init_stats(m, device="cpu")
    per_batch = []
    for step in range(5):
        b = tc(step)
        stream = update_stats(stream, b["tokens"], valid_mask=b["valid_mask"])
        per_batch.append(update_stats(init_stats(m, device="cpu"),
                                      b["tokens"],
                                      valid_mask=b["valid_mask"]))
    folded = tree_fold(m, pytree.tree_map(lambda *xs: torch.stack(xs),
                                          *per_batch))
    for k in stream:
        assert torch.equal(stream[k], folded[k]), k


def test_packed_stats_equal_jax():
    tc, jc = _corpora(ragged=True)
    tb, jb = tc(2), jc(2)
    got = packed_stats(tb["tokens"], tb["valid_mask"])
    want = j_packed_stats(jb["tokens"], jb["valid_mask"])
    for k in want:
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_jax_state_continues_exactly_in_the_port():
    """Batches [0, k) in JAX, carried over, [k, n) in the port == JAX's
    state after [0, n)."""
    tc, jc = _corpora(ragged=True)
    jm_ = j_make_stream_stats()
    k, n = 3, 6
    js = j_init_stats(jm_)
    for step in range(k):
        b = jc(step)
        js = j_update_stats(js, b["tokens"], valid_mask=b["valid_mask"])
    ts = state_from_numpy(jax.tree_util.tree_map(np.asarray, js),
                          device="cpu")
    _assert_state_equal(ts, js)
    for step in range(k, n):
        tb, jb = tc(step), jc(step)
        ts = update_stats(ts, tb["tokens"], valid_mask=tb["valid_mask"])
        js = j_update_stats(js, jb["tokens"], valid_mask=jb["valid_mask"])
    _assert_state_equal(ts, js)


def test_prefetcher_order_and_close():
    tc, _ = _corpora()
    pf = Prefetcher(tc, start_step=3, depth=2, num_steps=8)
    steps = [s for s, _ in pf]
    assert steps == [3, 4, 5, 6, 7]
    pf.close()


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SyntheticCorpus(DataConfig(**CFG))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_stats(make_stream_stats())
    # sync_stats runs on a bound mesh (tests/test_torch_dist.py); an
    # unbound axis is refused by name, never run as a world of one
    with pytest.raises(ValueError, match="'data' is not bound"):
        sync_stats(make_stream_stats(), init_stats(make_stream_stats(),
                                                   device="cpu"), ("data",))
    with pytest.raises(ValueError, match="hosts"):
        SyntheticCorpus(DataConfig(**CFG), num_hosts=3, device="cpu")


# ---------------------------------------------------------------------------
# the slice as a whole: the port's examples against the JAX examples
# ---------------------------------------------------------------------------

def _run(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn()
    return result, buf.getvalue()


def _paths_1_to_3(text):
    """The lines of paths 1-3: token counts, HLL estimates, the top tokens,
    exact counts and CMS estimates, and the HLL error line."""
    keep = [line.strip() for line in text.splitlines()
            if re.match(r"\s*(streaming|batch\s*):|\s*token \d+:|top-5|HLL "
                        r"distinct", line)]
    assert len(keep) == 7, text
    return keep


def test_streaming_example_matches_the_jax_example():
    from repro_torch.examples import streaming_analytics

    result, port_out = _run(lambda: streaming_analytics.main(
        ["--device", "cpu"]))
    _, jax_out = _run(lambda: runpy.run_path(
        str(ROOT / "examples" / "streaming_analytics.py"),
        run_name="__main__"))
    assert _paths_1_to_3(port_out) == _paths_1_to_3(jax_out)
    assert result["tokens"] == 8 * 8 * 256
    for exact, est in result["estimates"].values():
        assert est >= exact


def test_quickstart_example_runs_on_cpu():
    from repro_torch.examples import quickstart

    outs, text = _run(lambda: quickstart.main(["--device", "cpu"]))
    assert "Algorithm 2 rejected" in text
    for s in ("naive", "combiner"):
        np.testing.assert_allclose(outs[s].numpy(), outs["in_mapper"].numpy(),
                                   atol=1e-5)
    assert "64.0x" in text
