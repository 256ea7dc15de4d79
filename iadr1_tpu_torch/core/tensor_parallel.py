"""Tensor parallelism with explicit collectives, for the rollout (the
Megatron layout; training runs on DTensors instead, ``core/mesh.py``).

Each tp rank holds its slice of the decoder as plain tensors
(``train/rollout.py tp_local_params``): the column-parallel products
(q, k, v, gate, up) give the rank's heads and MLP columns, the
row-parallel ones (o, down) a partial sum that one all-reduce completes,
the vocabulary-sharded embedding a masked lookup that one all-reduce
completes, and the vocabulary-sharded LM head its logits columns, which an
all-gather joins before the sampler.  The decoder reads the group from
``tp_scope``: its ``all_reduce`` and ``all_gather`` are the functions it
is given, so the same decode step runs

* on a mesh, one process a rank (``MeshTP``, the tp ranks of a
  DeviceMesh over NCCL or Gloo), and
* in one process, the ranks one after another (``run_sequential_ranks``:
  each rank a thread that runs only while it holds the turn, each
  collective combining the ranks' parts in rank order with the function
  the caller gives), which holds a rank's arithmetic to the unsharded
  step on one card.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Sequence

import torch
import torch.distributed as dist

_SCOPE = threading.local()


def tp_group():
    """The tensor-parallel group of the decoder's current call (a
    ``MeshTP`` or a sequential rank), or None."""
    return getattr(_SCOPE, "group", None)


@contextlib.contextmanager
def tp_scope(group):
    """Run the decoder as rank ``group.rank`` of ``group`` (None: as one
    process); per thread."""
    prev = tp_group()
    _SCOPE.group = group
    try:
        yield group
    finally:
        _SCOPE.group = prev


def tp_sum(x: torch.Tensor) -> torch.Tensor:
    """A row-parallel product's partial sum completed over the tp ranks;
    ``x`` itself outside a tp scope."""
    group = tp_group()
    return x if group is None else group.all_reduce(x)


class MeshTP:
    """The tp ranks of a DeviceMesh: NCCL (or Gloo) collectives over the
    mesh's tp group.  A failed collective raises."""

    def __init__(self, mesh):
        self.group = mesh.get_group("tp")
        self.rank = mesh.get_local_rank("tp")
        self.size = mesh.size(mesh.mesh_dim_names.index("tp"))

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``x`` reduced over the tp ranks by ``op`` ("sum", "max" or
        "min"), in place where ``x`` is contiguous."""
        x = x.contiguous()
        dist.all_reduce(x, op=getattr(dist.ReduceOp, op.upper()),
                        group=self.group)
        return x

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=dim)


def rank_ordered_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The ranks' partial sums added in rank order."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


# how long a sequential rank waits for its turn before it gives up: a
# rank that makes fewer collectives than the others would leave them
# waiting for ever
TURN_TIMEOUT_S = 600.0


class _Turns:
    """The shared state of ranks that run one at a time: whose turn it
    is, each rank's part of the current collective and its result."""

    def __init__(self, size: int, reduce: Callable,
                 timeout: float = TURN_TIMEOUT_S):
        self.size, self.reduce, self.timeout = size, reduce, timeout
        self.cond = threading.Condition()
        self.turn = 0
        self.parts: list = [None] * size
        self.result, self.collectives = None, 0
        self.failed: BaseException | None = None

    def wait(self, rank: int) -> None:
        if not self.cond.wait_for(lambda: self.turn == rank or self.failed,
                                  self.timeout):
            raise RuntimeError(f"rank {rank} waited {self.timeout} s for its "
                               "turn: the ranks' collectives differ")
        if self.failed is not None:
            raise RuntimeError("another rank failed") from self.failed

    def pass_turn(self, rank: int) -> None:
        self.turn = (rank + 1) % self.size
        self.cond.notify_all()

    def exchange(self, rank: int, n: int, x, combine: Callable):
        """Deposit ``x`` as this rank's part of its ``n``-th collective;
        the last rank combines every part; each rank reads the result when
        its turn comes back.  Only the last rank writes a result, and
        every other rank has read the previous one by then.  A rank that
        finds a part missing, or no result of its own collective, raises:
        the ranks' collectives differ."""
        with self.cond:
            self.parts[rank] = x
            if rank == self.size - 1:
                if any(p is None for p in self.parts):
                    raise RuntimeError("a rank made no part of collective "
                                       f"{n}: the ranks' collectives differ")
                self.result = combine(self.parts)
                self.parts = [None] * self.size
                self.collectives += 1
            self.pass_turn(rank)
            self.wait(rank)
            if self.collectives != n:
                raise RuntimeError(f"rank {rank}'s collective {n} was not "
                                   "made: the ranks' collectives differ")
            return self.result


class SequentialRank:
    """One rank of ``run_sequential_ranks``: ``all_reduce`` combines the
    ranks' parts with the run's ``reduce`` (or their elementwise max or
    min), ``all_gather`` concatenates them in rank order."""

    def __init__(self, rank: int, turns: _Turns):
        self.rank, self.size, self._turns = rank, turns.size, turns
        self._made = 0

    def _exchange(self, x, combine):
        self._made += 1
        return self._turns.exchange(self.rank, self._made, x, combine)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        combine = {"sum": self._turns.reduce,
                   "max": lambda parts: torch.stack(parts).amax(0),
                   "min": lambda parts: torch.stack(parts).amin(0)}[op]
        return self._exchange(x, combine)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return self._exchange(x, lambda parts: torch.cat(parts, dim=dim))


def run_sequential_ranks(fn: Callable, size: int,
                         reduce: Callable = rank_ordered_sum,
                         timeout: float = TURN_TIMEOUT_S) -> list:
    """``fn(group)`` as ``size`` tp ranks of one process, one running at
    a time (rank 0 to the first collective, rank 1 to it, ..., then rank 0
    on to the next), each under ``tp_scope`` of its ``SequentialRank``;
    returns every rank's result.  ``reduce(parts)`` is the all-reduce
    (the rank-ordered sum by default; a control may drop a part).  Every
    rank must make the same collectives, as on a mesh; a rank left
    waiting ``timeout`` seconds for its turn raises, and the first rank's
    error is raised here once every rank has stopped."""
    turns = _Turns(size, reduce, timeout)
    results: list = [None] * size

    def body(rank):
        group = SequentialRank(rank, turns)
        try:
            with turns.cond:
                turns.wait(rank)
            with tp_scope(group), torch.no_grad():
                results[rank] = fn(group)
            with turns.cond:
                turns.pass_turn(rank)
        except BaseException as e:      # every rank stops with the first
            with turns.cond:
                turns.failed = turns.failed or e
                turns.cond.notify_all()

    threads = [threading.Thread(target=body, args=(r,)) for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if turns.failed is not None:
        raise turns.failed
    return results
