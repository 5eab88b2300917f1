"""The port's trainer (``repro_torch.launch.train``) on the CPU: twins of
``tests/test_system.py``'s end-to-end tests (the loss falls, the metrics
accumulator is the sum of the steps, 8 steps + restore + 8 equal 16
straight, preemption checkpoints and stops), with the restart held bit for
bit here (parameters, optimizer state, stream statistics and metrics: the
CPU runs every sum in one order); the CLI and the ``train_lm`` example at
a tiny size with ``--device cpu``."""
import dataclasses

import pytest
import torch
import torch.utils._pytree as pytree

from repro_torch.checkpoint import CheckpointStore
from repro_torch.launch.train import TrainerConfig, main, train
from repro_torch.runtime.fault_tolerance import PreemptionHandler


def _tc(**kw):
    base = dict(arch="qwen3-0.6b", steps=16, global_batch=4, seq_len=64,
                ckpt_every=8, log_every=4, device="cpu")
    base.update(kw)
    return TrainerConfig(**base)


@pytest.fixture(scope="module")
def short_run(tmp_path_factory):
    tc = _tc(ckpt_dir=str(tmp_path_factory.mktemp("ck")))
    return tc, train(tc)


def test_training_reduces_loss(short_run):
    _, out = short_run
    hist = out["history"]
    assert [h["step"] for h in hist] == [4, 8, 12, 16]
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert all(torch.isfinite(torch.tensor(h["loss"])) for h in hist)


def test_metrics_accumulator_is_sum_of_steps(short_run):
    tc, out = short_run
    acc = out["metrics_acc"]
    # the last position of every sequence has label -1 (masked)
    assert float(acc["tokens"]) == tc.steps * tc.global_batch * \
        (tc.seq_len - 1)
    assert int(out["stream_stats"]["count"]) == \
        tc.steps * tc.global_batch * tc.seq_len


def _equal_trees(a, b):
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    assert len(la) == len(lb)
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(la, lb))


def test_restart_continues_exactly(short_run, tmp_path):
    """16 straight steps against 8, a 'crash', a restore and 8 more: the
    same data (stateless pipeline), the same state (checkpoint), the same
    aggregates (monoid merge) -- bit for bit on the CPU."""
    tc_full, out_full = short_run
    train(dataclasses.replace(tc_full, ckpt_dir=str(tmp_path), steps=8))
    out2 = train(dataclasses.replace(tc_full, ckpt_dir=str(tmp_path)))
    assert out2["steps_done"] == 16
    assert [h["step"] for h in out2["history"]] == [12, 16]
    assert _equal_trees(out_full["params"], out2["params"])
    assert _equal_trees(out_full["opt_state"], out2["opt_state"])
    assert _equal_trees(out_full["stream_stats"], out2["stream_stats"])
    assert _equal_trees(out_full["metrics_acc"], out2["metrics_acc"])
    assert CheckpointStore(str(tmp_path)).all_steps() == [8, 16]


def test_preemption_checkpoints_and_stops(tmp_path):
    h = PreemptionHandler(signals=())
    h.trigger()
    out = train(_tc(steps=50, ckpt_dir=str(tmp_path), ckpt_every=1000),
                preemption=h)
    assert out["steps_done"] < 50
    assert CheckpointStore(str(tmp_path)).latest_step() == out["steps_done"]


def test_ragged_lossy_microbatched_run(tmp_path):
    """A ragged corpus (the stream stats fold only real tokens), a lossy
    fold (the EF residual checkpoints with the optimizer) and two
    microbatches, resumed once."""
    tc = _tc(steps=3, ragged=True, lossy="int8", microbatches=2,
             ckpt_dir=str(tmp_path), ckpt_every=2, log_every=1)
    out = train(dataclasses.replace(tc, steps=2))
    assert "ef" in out["opt_state"]
    out = train(tc)
    assert out["steps_done"] == 3 and len(out["history"]) == 1
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticCorpus
    corpus = SyntheticCorpus(DataConfig(
        vocab_size=get_config("qwen3-0.6b", smoke=True).vocab_size,
        seq_len=64, global_batch=4, ragged=True), device="cpu")
    valid = sum(int(corpus(i)["valid_mask"].sum()) for i in range(3))
    assert int(out["stream_stats"]["count"]) == valid < 3 * 4 * 64


def test_model_parallel_waits_for_the_mesh_tier():
    """model_parallel > 1 trains across the ranks of a world
    (tests/test_torch_tp_train*.py); outside one it refuses.  Every family
    trains under a mesh: MLA's step is built with its heads cut over
    'model'."""
    with pytest.raises(ValueError, match="ranks of a world"):
        train(_tc(model_parallel=2))
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    built = make_train_step(get_config("deepseek-v2-236b", smoke=True),
                            mesh={"data": 1, "model": 2})
    mix = built.in_shardings[0]["layers"][1]["mix"]
    assert mix["wk_b"] == mix["wv_b"] == (None, "model")
    assert mix["wkv_a"] == ()


def test_cli_and_example_run_on_the_cpu(tmp_path, capsys):
    out = main(["--device", "cpu", "--steps", "3", "--batch", "2", "--seq",
                "16", "--microbatches", "2", "--log-every", "1",
                "--ckpt-dir", str(tmp_path / "cli")])
    assert out["steps_done"] == 3
    printed = capsys.readouterr().out
    assert "step     3 loss=" in printed and "done: 3 steps" in printed
    from repro_torch.examples import train_lm
    res = train_lm.main(["--device", "cpu", "--steps", "2", "--dim", "32",
                         "--batch", "2", "--seq", "16",
                         "--ckpt-dir", str(tmp_path / "lm")])
    assert res["steps_done"] == 2
    printed = capsys.readouterr().out
    assert "model: lm-100m" in printed and "corpus stats" in printed
    assert CheckpointStore(str(tmp_path / "lm")).latest_step() == 2
