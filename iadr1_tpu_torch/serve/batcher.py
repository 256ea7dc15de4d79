"""Dynamic request micro-batching for the serving API (the port's own copy
of iadr1_tpu/serve/batcher.py).

The reference serializes requests behind a per-model semaphore
(llamafactory chat/hf_engine.py semaphore; api/app.py) -- under load,
N concurrent chat requests take N full generate calls.  Here concurrent
requests coalesce into one batch: the worker picks up the first queued
request, drains up to ``max_batch - 1`` more within ``max_wait_ms``, and
runs a single generate over the padded fixed-size batch (VLMGenerator
pads short batches to its batch_size).  Early-exit decoding
(train/rollout.py) bounds the batch's decode length by its longest
completion.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Sequence


class RequestBatcher:
    """submit(request) blocks until the batched result is available.

    ``generate_fn(requests: list) -> list`` must return one result per
    request, in order (VLMGenerator.generate's contract).
    """

    def __init__(self, generate_fn: Callable[[Sequence], Sequence],
                 max_batch: int = 4, max_wait_ms: float = 10.0):
        self.generate_fn = generate_fn
        self.max_batch = max(int(max_batch), 1)
        self.max_wait = max_wait_ms / 1000.0
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # --- public -------------------------------------------------------------

    def submit(self, request):
        """Enqueue one request and wait for its result (raises the
        batch's exception if generate_fn failed)."""
        if self._closed:
            raise RuntimeError("batcher is closed")
        done = threading.Event()
        slot = {"done": done}
        self._q.put((request, slot))
        done.wait()
        if "error" in slot:
            raise slot["error"]
        return slot["result"]

    def close(self):
        self._closed = True
        self._q.put(None)

    # --- worker ---------------------------------------------------------------

    def _drain_batch(self):
        """Block for the first request, then coalesce up to max_batch
        within the wait window.  Returns [] at shutdown."""
        first = self._q.get()
        if first is None:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.max_wait
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                self._q.put(None)   # re-signal shutdown after this batch
                break
            batch.append(item)
        return batch

    def _run(self):
        while True:
            batch = self._drain_batch()
            if not batch:
                return
            requests = [r for r, _ in batch]
            try:
                results = self.generate_fn(requests)
                if len(results) != len(requests):
                    raise RuntimeError(
                        f"generate_fn returned {len(results)} results for "
                        f"{len(requests)} requests"
                    )
                for (_, slot), res in zip(batch, results):
                    slot["result"] = res
                    slot["done"].set()
            except Exception as e:  # noqa: BLE001 -- delivered per-request
                for _, slot in batch:
                    slot["error"] = e
                    slot["done"].set()
