"""Checkpoint / resume over safetensors files (the port's counterpart of
iadr1_tpu/train/checkpoint.py, whose checkpoints are orbax's).

The checkpoint of step s is ``{directory}/{s}.safetensors``: the
TrainState's parameters (``params.<path>``), the optimizer's per-leaf
tensors (AdamW's moments ``mu.<path>`` and ``nu.<path>``; each list of the
state under its key, named by its parameter's path), the step and the
optimizer's count, which set the schedule and the bias correction,
so a run resumed from it takes the steps an uninterrupted run would, bit
for bit.  ``meta_{s}.json`` holds the caller's metadata beside it.

Saves are synchronous: each tensor is copied from the card to the host
once and written before the next (``params_io.save_safetensors``), and
the file appears whole or not at all; ``wait`` has nothing to join.
Orbax checkpoints and these do not read each other: weights cross between
the two packages through the HF export (``models/params_export.py``).
"""

from __future__ import annotations

import json
import os
import re

import torch

from iadr1_tpu_torch.models.params_io import save_safetensors
from iadr1_tpu_torch.train.state import TrainState, named_leaves, unflatten

_NAME = re.compile(r"^(\d+)\.safetensors$")


def _opt_leaves(opt: dict, named):
    """(key, (path, param), tensor) of each per-leaf tensor of an optimizer
    state: every list under its key, None entries skipped."""
    return [(key, item, t) for key, val in opt.items()
            if isinstance(val, list)
            for item, t in zip(named, val) if t is not None]


class CheckpointManager:
    """``save(step, state)`` keeps the newest ``max_to_keep`` checkpoints
    (all of them when it is 0 or None) and, as orbax does, saves only a
    step later than the newest one and on ``save_interval_steps``;
    ``restore`` fills a TrainState's tensors in place."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int | None = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps or 1

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.safetensors")

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(
            _NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState,
             metadata: dict | None = None) -> bool:
        """Write ``state`` as step ``step``; returns whether it was
        written (a step not later than the newest checkpoint, or off the
        save interval, is not)."""
        latest = self.latest_step()
        if (latest is not None and step <= latest) or (
                step % self.save_interval_steps):
            return False
        named = named_leaves(state.params)
        tensors = {f"params.{name}": p for name, p in named}
        opt = state.opt_state
        for key, (name, _), t in _opt_leaves(opt, named):
            tensors[f"{key}.{name}"] = t
        tensors["step"] = torch.tensor(int(state.step), dtype=torch.int64)
        tensors["opt_count"] = torch.tensor(int(opt["count"]),
                                            dtype=torch.int64)
        save_safetensors(self.path(step), tensors, {"format": "pt"})
        if metadata:
            with open(os.path.join(self.directory, f"meta_{step}.json"),
                      "w") as f:
                json.dump(metadata, f)
        old_steps = self.all_steps()[:-self.max_to_keep] if (
            self.max_to_keep) else []
        for old in old_steps:
            os.remove(self.path(old))
            meta = os.path.join(self.directory, f"meta_{old}.json")
            if os.path.exists(meta):
                os.remove(meta)
        return True

    def _step_path(self, step: int | None) -> str:
        step = step if step is not None else self.latest_step()
        if step is None or not os.path.exists(self.path(step)):
            raise FileNotFoundError(
                f"no checkpoint{'' if step is None else f' {step}'} under "
                f"{self.directory}")
        return self.path(step)

    @torch.no_grad()
    def restore(self, state_like: TrainState,
                step: int | None = None) -> TrainState:
        """The checkpoint of ``step`` (default: the newest) copied into
        ``state_like``'s tensors, which must match it in shape and dtype;
        with ``opt_state`` None only the parameters and the step are read.
        Raises FileNotFoundError when there is none."""
        from safetensors import safe_open

        with safe_open(self._step_path(step), framework="pt",
                       device="cpu") as f:
            def fill(key, dst):
                src = f.get_tensor(key)
                if src.shape != dst.shape or src.dtype != dst.dtype:
                    raise ValueError(
                        f"checkpoint tensor {key} is {src.dtype} "
                        f"{tuple(src.shape)}, the state's {dst.dtype} "
                        f"{tuple(dst.shape)}")
                dst.copy_(src)

            named = named_leaves(state_like.params)
            for name, p in named:
                fill(f"params.{name}", p)
            opt = state_like.opt_state
            if opt is not None:
                for key, (name, _), t in _opt_leaves(opt, named):
                    fill(f"{key}.{name}", t)
                opt["count"] = int(f.get_tensor("opt_count"))
            return state_like._replace(step=int(f.get_tensor("step")))

    def restore_params(self, step: int | None = None,
                       device="cpu") -> dict:
        """The parameters alone, in their saved dtypes, as a nested dict
        (keys in sorted order) with no state to fill: what an export
        reads."""
        from safetensors import safe_open

        with safe_open(self._step_path(step), framework="pt",
                       device="cpu") as f:
            return unflatten({k[len("params."):]: f.get_tensor(k).to(device)
                              for k in f.keys() if k.startswith("params.")})

    def wait(self) -> None:
        """Saves are synchronous; nothing is in flight."""

    def close(self) -> None:
        """Nothing is held open between calls."""
