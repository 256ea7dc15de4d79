"""SFT training loop: data -> step -> logging -> checkpoints (the port's
own copy of iadr1_tpu/train/loop.py).

The wandb/tensorboard reporters and the loss plot (ROADMAP A.15) are not
ported yet: the config takes their keys, and a run that asks for them
raises.
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
    the consumer.  Closing the generator stops and joins the thread, so
    nothing of a finished run (rows, collator, queued batches) outlives
    it."""
    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    end = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in batches:
                if not put(item):
                    return
        except BaseException as e:  # noqa: BLE001 -- re-raised below
            put((end, e))
            return
        put((end, None))

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, tuple) and len(item) == 2 and item[0] is end:
                if item[1] is not None:
                    raise item[1]
                return
            yield item
    finally:
        stop.set()
        thread.join()


def run_sft_loop(state, step_fn, batches: Iterable[dict], cfg: LoopConfig,
                 checkpoint_manager=None, meter=None, start_step: int = 0):
    """Drive training for cfg.max_steps; returns (final_state, history).

    ``start_step``: the resume point -- steps start at start_step + 1 and
    the caller restores ``state`` and fast-forwards ``batches``
    (``batch_iterator(skip=start_step)``).  ``checkpoint_manager``
    (train/checkpoint.py) saves every ``save_steps`` steps and at the end.
    ``meter`` (core/metrics.ThroughputMeter) is fed the tokens and the
    wall time of every step; reading the loss synchronises the device."""
    if checkpoint_manager is None and (cfg.save_steps or cfg.resume):
        raise ValueError(
            "the loop config asks for checkpoints (save_steps or resume) "
            "but no checkpoint manager was given")
    if cfg.report_to or cfg.plot_loss:
        raise NotImplementedError(
            "reporters and the loss plot are not ported yet (ROADMAP A.15)")
    logger = JsonlLogger(cfg.output_dir, cfg.max_steps)
    history = []
    prefetch = prefetch_iterator(batches, cfg.prefetch) if cfg.prefetch else None
    it = prefetch or iter(batches)
    t_last = time.perf_counter()
    try:
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
            if (checkpoint_manager is not None and cfg.save_steps
                    and step % cfg.save_steps == 0):
                checkpoint_manager.save(step, state)
        if checkpoint_manager is not None:
            checkpoint_manager.save(cfg.max_steps, state)
            checkpoint_manager.wait()
    finally:
        if prefetch is not None:
            prefetch.close()
        logger.close()
    return state, history
