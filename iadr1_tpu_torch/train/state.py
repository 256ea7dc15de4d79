"""Train state: step + parameters + optimizer state (the port's own copy of
iadr1_tpu/train/state.py).

Parameters stay the nested dict of tensors the models read; the optimizer
sees them as ``tree_leaves(params)``, a list in a fixed order, and
gradients come as a list in that same order.  ``apply_gradients`` updates
parameters and moments in place (the JAX state is rebuilt functionally;
in place saves a parameter-sized copy at 2B scale).

On a mesh (``core/mesh.py``) the leaves are DTensors, and every
optimizer runs on them as they are: ``init`` places each state tensor
shaped like a parameter as that parameter (a DTensor with its
placements), the others along the dims they keep, and ``apply`` updates
each rank's shards in place (``train/optimizers.py``,
``train/custom_optim.py``), gathering at most one matrix at a time.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a nested dict, depth first in insertion order; None
    leaves (those of a LoRA tree, ``train/adapters.py``) are empty."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


def named_leaves(tree, prefix: str = "",
                 sep: str = ".") -> list[tuple[str, torch.Tensor]]:
    """(dotted path, tensor) of every leaf, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [item for k, v in tree.items()
                for item in named_leaves(v, f"{prefix}{k}{sep}", sep)]
    return [] if tree is None else [(prefix[:-len(sep)], tree)]


def leaf_paths(tree) -> list[str]:
    """Every leaf's path in the JAX package's form ("text/layers/attn/q/
    kernel"), in ``tree_leaves`` order: what the optimizers that choose by
    path read."""
    return [name for name, _ in named_leaves(tree, sep="/")]


def unflatten(named: dict) -> dict:
    """{dotted path: tensor} -> the nested dict ``named_leaves`` read."""
    tree: dict = {}
    for path, leaf in named.items():
        *parents, last = path.split(".")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


class TrainState(NamedTuple):
    step: int
    params: dict
    opt_state: Any

    def apply_gradients(self, grads, optimizer, grad_norm=None) -> "TrainState":
        optimizer.apply(tree_leaves(self.params), grads, self.opt_state,
                        grad_norm)
        return self._replace(step=self.step + 1)


def create_train_state(params: dict, optimizer) -> TrainState:
    """Marks every floating parameter as requiring grad and initialises
    the optimizer's moments beside it, from the leaves as they are (on a
    mesh, the DTensors); every optimizer's ``init(leaves, paths)`` is
    given the leaves' paths (``leaf_paths``), which those that choose by
    path read."""
    leaves = tree_leaves(params)
    for p in leaves:
        if p.is_floating_point():
            p.requires_grad_(True)
    opt_state = optimizer.init(leaves, leaf_paths(params))
    return TrainState(step=0, params=params, opt_state=opt_state)
