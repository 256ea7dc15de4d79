"""Metric reporters + loss-curve plotting (the port's own copy of
iadr1_tpu/train/reporters.py).

The counterpart of the reference's --report_to wandb plumbing
(SC_GRPO_*.sh:13-18, ReporterCallback) and extras/ploting.py: reporters
receive every logged step; plot_loss renders original + TensorBoard-EMA
smoothed curves from trainer_log.jsonl to PNG.  ``wandb`` and
``matplotlib`` are imported where they are used, and a missing one
raises an ImportError that names it.
"""

from __future__ import annotations

import json
import math
import os
from typing import Sequence


class Reporter:
    """Interface: log(step, metrics) per logging step, finish() at end."""

    def log(self, step: int, metrics: dict) -> None:  # pragma: no cover
        raise NotImplementedError

    def finish(self) -> None:
        pass


class WandbReporter(Reporter):
    """Weights & Biases reporter (lazy import).  Offline unless the
    caller's environment sets ``WANDB_MODE`` (the JAX reporter sets no
    mode by default, and an online run contacts the wandb service)."""

    def __init__(self, project: str = "iadr1_tpu", run_name: str | None = None,
                 config: dict | None = None, mode: str | None = "offline"):
        try:
            import wandb
        except ImportError as e:
            raise ImportError(
                "report_to=wandb requires the wandb package") from e
        self._wandb = wandb
        if mode:
            os.environ.setdefault("WANDB_MODE", mode)
        self._run = wandb.init(project=project, name=run_name,
                               config=config or {})

    def log(self, step: int, metrics: dict) -> None:
        self._wandb.log(dict(metrics), step=step)

    def finish(self) -> None:
        self._run.finish()


class CompositeReporter(Reporter):
    def __init__(self, reporters: Sequence[Reporter]):
        self.reporters = list(reporters)

    def log(self, step: int, metrics: dict) -> None:
        for r in self.reporters:
            r.log(step, metrics)

    def finish(self) -> None:
        for r in self.reporters:
            r.finish()


def make_reporters(report_to: Sequence[str], run_name: str | None = None,
                   config: dict | None = None) -> Reporter:
    """Resolve --report_to names ("wandb", "none") into one reporter."""
    reporters: list[Reporter] = []
    for name in report_to or []:
        if name in ("none", ""):
            continue
        if name == "wandb":
            reporters.append(WandbReporter(run_name=run_name, config=config))
        else:
            raise ValueError(f"unknown reporter {name!r}")
    return CompositeReporter(reporters)


# ---------------------------------------------------------------------------
# loss curves (extras/ploting.py analogue)
# ---------------------------------------------------------------------------


def smooth(scalars: list[float]) -> list[float]:
    """TensorBoard-style EMA with a length-dependent weight
    (ploting.py:34-48)."""
    if not scalars:
        return []
    last = scalars[0]
    out = []
    weight = 1.8 * (1 / (1 + math.exp(-0.05 * len(scalars))) - 0.5)
    for v in scalars:
        last = last * weight + (1 - weight) * v
        out.append(last)
    return out


def plot_loss(output_dir: str, keys: Sequence[str] = ("loss",),
              log_name: str = "trainer_log.jsonl") -> list[str]:
    """Render training_<key>.png per metric from trainer_log.jsonl; returns
    the written paths."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plot_loss requires the matplotlib package") from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(os.path.join(output_dir, log_name)) as f:
        records = [json.loads(line) for line in f]

    written = []
    for key in keys:
        steps = [r["current_steps"] for r in records if r.get(key) is not None]
        vals = [r[key] for r in records if r.get(key) is not None]
        if not vals:
            continue
        plt.figure()
        plt.plot(steps, vals, color="#1f77b4", alpha=0.4, label="original")
        plt.plot(steps, smooth(vals), color="#1f77b4", label="smoothed")
        plt.title(f"training {key} of {output_dir}")
        plt.xlabel("step")
        plt.ylabel(key)
        plt.legend()
        path = os.path.join(
            output_dir, "training_{}.png".format(key.replace("/", "_")))
        plt.savefig(path, format="png", dpi=100)
        plt.close("all")
        written.append(path)
    return written
