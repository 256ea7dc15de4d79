"""The port's reporters, loss plot, profiling spans and device trace and
the text-similarity metrics against the JAX package's: ``smooth`` bit for
bit, the plot's file names, what a (fake) wandb run is given, the SFT
loop with ``report_to`` and ``plot_loss``, the span keys, a CPU trace
holding an ``annotate`` region, and ``similarity_scores`` exactly
(``do_predict`` through the SFT CLIs: tests/test_torch_predict.py)."""

import json
import os
import sys
import types

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, set up by conftest)

from iadr1_tpu.core import profiling as jax_profiling
from iadr1_tpu.train import loop as jax_loop
from iadr1_tpu.train import metrics_text as jax_metrics
from iadr1_tpu.train import reporters as jax_reporters
from iadr1_tpu_torch.core import profiling
from iadr1_tpu_torch.train import loop, metrics_text, reporters
import torch_threads  # noqa: F401  (one intra-op thread)


@pytest.mark.parametrize("n", [0, 1, 5, 37, 400])
def test_smooth_is_bitwise_jax(n):
    vals = list(np.random.default_rng(n).standard_normal(n) * 3 + 2)
    assert reporters.smooth(vals) == jax_reporters.smooth(vals)


def _write_log(path, records):
    with open(os.path.join(path, "trainer_log.jsonl"), "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")


def test_plot_loss_writes_the_jax_file_names(tmp_path):
    records = [{"current_steps": i + 1, "loss": 2.0 / (i + 1),
                "rewards/acc": 0.1 * i} for i in range(6)]
    records.append({"current_steps": 7, "grad_norm": 1.0})
    names = {}
    for side, mod in (("port", reporters), ("jax", jax_reporters)):
        d = tmp_path / side
        d.mkdir()
        _write_log(str(d), records)
        paths = mod.plot_loss(str(d), keys=("loss", "rewards/acc", "absent"))
        names[side] = [os.path.basename(p) for p in paths]
        assert all(os.path.getsize(p) > 1000 for p in paths)
    assert names["port"] == names["jax"] == ["training_loss.png",
                                             "training_rewards_acc.png"]


class FakeWandb:
    """A stand-in ``wandb`` module that records what a run is given."""

    def __init__(self):
        self.inits, self.logs, self.finished = [], [], 0
        self.module = types.ModuleType("wandb")
        self.module.init = self._init
        self.module.log = lambda metrics, step=None: self.logs.append(
            (step, dict(metrics)))

    def _init(self, project=None, name=None, config=None):
        self.inits.append(dict(project=project, name=name, config=config))
        fake = self

        class Run:
            def finish(self):
                fake.finished += 1

        return Run()


@pytest.fixture
def fake_wandb(monkeypatch):
    def install():
        fake = FakeWandb()
        monkeypatch.setitem(sys.modules, "wandb", fake.module)
        return fake
    return install


def test_wandb_reporter_logs_what_jax_logs(fake_wandb, monkeypatch):
    """The same init, steps and metrics; the port's run is offline unless
    the environment says otherwise."""
    monkeypatch.delenv("WANDB_MODE", raising=False)
    seen = {}
    for side, mod in (("port", reporters), ("jax", jax_reporters)):
        fake = fake_wandb()
        rep = mod.make_reporters(["none", "wandb"], run_name="run1",
                                 config={"lr": 1e-4})
        rep.log(3, {"loss": 0.5, "grad_norm": 1.25})
        rep.log(6, {"loss": 0.25})
        rep.finish()
        seen[side] = (fake.inits, fake.logs, fake.finished)
        if side == "port":
            assert os.environ["WANDB_MODE"] == "offline"
    assert seen["port"] == seen["jax"]
    assert seen["port"][0][0]["project"] == "iadr1_tpu"
    assert reporters.make_reporters(["none"]).reporters == []
    with pytest.raises(ValueError, match="unknown reporter"):
        reporters.make_reporters(["swanlab"])


def test_missing_host_packages_raise_naming_them(monkeypatch, tmp_path):
    """No silent substitute: a missing wandb, matplotlib, jieba or nltk
    raises an ImportError that names it."""
    for name in ("wandb", "matplotlib", "jieba"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError, match="wandb"):
        reporters.make_reporters(["wandb"])
    _write_log(str(tmp_path), [{"current_steps": 1, "loss": 1.0}])
    with pytest.raises(ImportError, match="matplotlib"):
        reporters.plot_loss(str(tmp_path))
    with pytest.raises(ImportError, match="jieba"):
        metrics_text.similarity_scores(["a"], ["a"])


def _fake_step(state, batch):
    return state + 1, {"loss": np.float32(2.0 / (state + 1)),
                       "grad_norm": np.float32(0.5 * state)}


def _batches():
    while True:
        yield {"input_ids": np.zeros((2, 8), np.int64)}


def test_sft_loop_reports_and_plots_as_jax(fake_wandb, tmp_path,
                                          monkeypatch):
    """``run_sft_loop`` with ``report_to=["wandb"]`` and ``plot_loss``: the
    reporter gets every logging step's metrics, the loss curve is drawn
    from the run's own trainer log, as in the JAX loop."""
    monkeypatch.delenv("WANDB_MODE", raising=False)
    seen = {}
    for side, mod in (("port", loop), ("jax", jax_loop)):
        fake = fake_wandb()
        out = tmp_path / side
        cfg = mod.LoopConfig(output_dir=str(out), max_steps=6, batch_size=2,
                             logging_steps=2, prefetch=0,
                             report_to=["wandb"], plot_loss=True)
        state, history = mod.run_sft_loop(0, _fake_step, _batches(), cfg)
        assert state == 6 and len(history) == 3
        seen[side] = (fake.logs, fake.finished, sorted(os.listdir(out)))
    assert seen["port"] == seen["jax"]
    assert [step for step, _ in seen["port"][0]] == [2, 4, 6]
    assert "training_loss.png" in seen["port"][2]


def _spanned(x):
    return x + 1


def test_profiling_spans_carry_the_jax_keys():
    for mod in (profiling, jax_profiling):
        mod.drain_profiling_metrics()
    port_fn = profiling.profiling_decorator(_spanned)
    jax_fn = jax_profiling.profiling_decorator(_spanned)
    for _ in range(3):
        assert port_fn(1) == jax_fn(1) == 2
    with profiling.profiling_context("rollout"), \
            jax_profiling.profiling_context("rollout"):
        pass
    got = profiling.drain_profiling_metrics()
    want = jax_profiling.drain_profiling_metrics()
    assert sorted(got) == sorted(want) == [
        "profiling/Time taken: _spanned", "profiling/Time taken: rollout"]
    assert all(v >= 0 for v in got.values())
    assert profiling.drain_profiling_metrics() == {}


def test_device_trace_on_the_cpu_holds_the_annotated_region(tmp_path):
    import torch

    with profiling.device_trace(str(tmp_path / "trace")):
        with profiling.annotate("chat_turn_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "trace" / profiling.TRACE_FILE
    trace = json.loads(path.read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "chat_turn_region" in names
    assert any(n and "mm" in n for n in names)


SIMILARITY_PAIRS = [
    ("the surface has a scratch", "the surface has a scratch"),
    ("a small dent on the left", "a deep scratch on the top left corner"),
    ("no defect", "there is a hole in the middle"),
    ("表面有划痕", "表面有一道划痕"),
    ("图像中没有缺陷", "图像左上角有污渍"),
    ("", "a reference answer"),
    ("a prediction", ""),
    ("", ""),
    ("scratch scratch scratch", "scratch"),
    ("<answer>Yes</answer>", "<think>x</think><answer>Yes</answer>"),
    ("Mixed 中英 text with 123", "mixed 中英 TEXT with 1234"),
]


@pytest.mark.parametrize("pairs", [SIMILARITY_PAIRS[:1], SIMILARITY_PAIRS,
                                   SIMILARITY_PAIRS[3:5]])
def test_similarity_scores_equal_jax(pairs):
    preds, labels = zip(*pairs)
    got = metrics_text.similarity_scores(preds, labels)
    assert got == jax_metrics.similarity_scores(preds, labels)
    assert sorted(got) == ["bleu-4", "rouge-1", "rouge-2", "rouge-l"]
