"""Train state: step + parameters + optimizer state (the port's own copy of
iadr1_tpu/train/state.py).

Parameters stay the nested dict of tensors the models read; the optimizer
sees them as ``tree_leaves(params)``, a list in a fixed order, and
gradients come as a list in that same order.  ``apply_gradients`` updates
parameters and moments in place (the JAX state is rebuilt functionally;
in place saves a parameter-sized copy at 2B scale).
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


def named_leaves(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(dotted path, tensor) of every leaf, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [item for k, v in tree.items()
                for item in named_leaves(v, f"{prefix}{k}.")]
    return [] if tree is None else [(prefix[:-1], tree)]


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
    the optimizer's moments beside it."""
    leaves = tree_leaves(params)
    for p in leaves:
        if p.is_floating_point():
            p.requires_grad_(True)
    return TrainState(step=0, params=params, opt_state=optimizer.init(leaves))
