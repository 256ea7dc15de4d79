"""SFT training loop: data -> step -> logging (the port's own copy of
iadr1_tpu/train/loop.py).

Checkpointing and resuming (ROADMAP A.4), the wandb/tensorboard reporters
and the loss plot (A.15) are not ported yet: the config takes their keys,
and a run that asks for them raises.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import threading
import time
from typing import Callable, Iterable, Sequence

import numpy as np


@dataclasses.dataclass
class LoopConfig:
    output_dir: str = "output"
    max_steps: int = 100
    batch_size: int = 8               # global batch (rows per step)
    logging_steps: int = 10
    save_steps: int = 0               # 0 = only final
    seed: int = 0
    keep_checkpoints: int = 3
    resume: bool = False              # resume from the latest checkpoint
    plot_loss: bool = False
    report_to: list = dataclasses.field(default_factory=list)
    # background host-collation prefetch depth (0 = synchronous)
    prefetch: int = 2


class JsonlLogger:
    """trainer_log.jsonl-compatible progress log (+ stdout)."""

    def __init__(self, output_dir: str, total_steps: int):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "trainer_log.jsonl")
        self.total = total_steps
        self.start = time.time()
        self._f = open(self.path, "a")

    def log(self, step: int, metrics: dict):
        elapsed = time.time() - self.start
        rate = elapsed / max(step, 1)
        record = {
            "current_steps": step,
            "total_steps": self.total,
            "percentage": round(step / self.total * 100, 2),
            "elapsed_time": round(elapsed, 1),
            "remaining_time": round(rate * (self.total - step), 1),
            **{k: round(float(v), 6) for k, v in metrics.items()},
        }
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()
        print(f"[step {step}/{self.total}] " + " ".join(
            f"{k}={record[k]}" for k in metrics))

    def close(self):
        self._f.close()


def batch_iterator(rows: Sequence[dict], batch_size: int, seed: int,
                   collate: Callable, skip: int = 0) -> Iterable[dict]:
    """Infinite shuffled epochs over packed rows; ``skip`` fast-forwards
    past the first N batches without collating them."""
    if len(rows) < batch_size:
        raise ValueError(
            f"{len(rows)} packed rows < batch_size {batch_size}; an empty "
            "iterator would spin forever")
    rng = np.random.default_rng(seed)
    order = np.arange(len(rows))
    skipped = 0
    while True:
        rng.shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            if skipped < skip:
                skipped += 1
                continue
            yield collate([rows[j] for j in order[i:i + batch_size]])


def prefetch_iterator(batches: Iterable[dict], depth: int = 2):
    """Background-thread prefetch over a batch iterable: host collation
    overlaps the device step.  Order-preserving; exceptions propagate to
    the consumer; the thread is a daemon."""
    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    end = object()

    def worker():
        try:
            for item in batches:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 -- re-raised below
            q.put((end, e))
            return
        q.put((end, None))

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if isinstance(item, tuple) and len(item) == 2 and item[0] is end:
            if item[1] is not None:
                raise item[1]
            return
        yield item


def run_sft_loop(state, step_fn, batches: Iterable[dict], cfg: LoopConfig,
                 checkpoint_manager=None, meter=None, start_step: int = 0):
    """Drive training for cfg.max_steps; returns (final_state, history).

    ``meter`` (core/metrics.ThroughputMeter) is fed the tokens and the
    wall time of every step; reading the loss synchronises the device."""
    if checkpoint_manager is not None or cfg.save_steps or cfg.resume:
        raise NotImplementedError(
            "checkpointing and resuming are not ported yet (ROADMAP A.4)")
    if cfg.report_to or cfg.plot_loss:
        raise NotImplementedError(
            "reporters and the loss plot are not ported yet (ROADMAP A.15)")
    logger = JsonlLogger(cfg.output_dir, cfg.max_steps)
    history = []
    if cfg.prefetch:
        batches = prefetch_iterator(batches, cfg.prefetch)
    it = iter(batches)
    t_last = time.perf_counter()
    for step in range(start_step + 1, cfg.max_steps + 1):
        batch = next(it)
        state, metrics = step_fn(state, batch)
        log_now = step % max(cfg.logging_steps, 1) == 0
        if meter is not None or log_now:
            float(metrics["loss"])                 # waits for the device
            now = time.perf_counter()
            if meter is not None:
                meter.update(int(np.prod(np.shape(batch["input_ids"]))),
                             now - t_last)
            t_last = now
        if log_now:
            out = {k: float(v) for k, v in metrics.items()}
            if meter is not None:
                out["tokens_per_sec_per_chip"] = meter.tokens_per_sec
                out["mfu"] = meter.mfu
            logger.log(step, out)
            history.append(out)
    logger.close()
    return state, history
