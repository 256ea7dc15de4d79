"""Train state: step + parameters + optimizer state (the port's own copy of
iadr1_tpu/train/state.py).

Parameters stay the nested dict of tensors the models read; the optimizer
sees them as ``tree_leaves(params)``, a list in a fixed order, and
gradients come as a list in that same order.  ``apply_gradients`` updates
parameters and moments in place (the JAX state is rebuilt functionally;
in place saves a parameter-sized copy at 2B scale).

On a mesh (``core/mesh.py``) the leaves are DTensors.  An optimizer that
declares ``shard_local`` (AdamW: elementwise, with a global norm that
reduces over the mesh) updates each rank's shards in place; every other
one runs on whole leaves, gathered for the update (its state whole on
each rank), and each rank keeps its shard of the result, so its update
is the one of a single process.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from iadr1_tpu_torch.core.mesh import full, is_dtensor, local


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
        leaves = tree_leaves(self.params)
        if gathers_leaves(optimizer, leaves):
            _apply_gathered(optimizer, leaves, grads, self.opt_state,
                            grad_norm)
        else:
            optimizer.apply(leaves, grads, self.opt_state, grad_norm)
        return self._replace(step=self.step + 1)


def gathers_leaves(optimizer, leaves) -> bool:
    """Whether ``optimizer`` runs on whole leaves: DTensor leaves and no
    ``shard_local`` declaration."""
    return (not getattr(optimizer, "shard_local", False)
            and any(is_dtensor(p) for p in leaves))


@torch.no_grad()
def _apply_gathered(optimizer, leaves, grads, opt_state, grad_norm) -> None:
    from torch.distributed.tensor import distribute_tensor

    whole = [full(p).detach() for p in leaves]
    optimizer.apply(whole, [full(g) for g in grads], opt_state,
                    None if grad_norm is None else full(grad_norm))
    for p, w in zip(leaves, whole):
        if is_dtensor(p):
            local(p).copy_(distribute_tensor(
                w, p.device_mesh, p.placements, src_data_rank=None
            ).to_local())


def create_train_state(params: dict, optimizer) -> TrainState:
    """Marks every floating parameter as requiring grad and initialises
    the optimizer's moments beside it; every optimizer's ``init(leaves,
    paths)`` is given the leaves' paths (``leaf_paths``), which those that
    choose by path read."""
    leaves = tree_leaves(params)
    for p in leaves:
        if p.is_floating_point():
            p.requires_grad_(True)
    if gathers_leaves(optimizer, leaves):
        with torch.no_grad():
            leaves = [full(p) for p in leaves]
    opt_state = optimizer.init(leaves, leaf_paths(params))
    return TrainState(step=0, params=params, opt_state=opt_state)
