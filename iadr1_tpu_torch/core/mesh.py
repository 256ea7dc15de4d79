"""Device mesh and logical-axis sharding on ``torch.distributed``
(counterpart of iadr1_tpu/core/mesh.py).

One mesh with three named axes, as in the JAX package:

* ``dp``   -- data parallelism (batch split, parameters replicated)
* ``fsdp`` -- the ZeRO-3 analogue: batch split AND parameters and
  optimizer moments sharded
* ``tp``   -- tensor parallelism (heads, MLP and vocabulary split)

Parameters carry logical axis names (``("embed", "mlp")``), and the rule
table maps them to mesh axes; ``shard_pytree`` makes every leaf a
``DTensor`` placed by them.

How a training step runs on the mesh (``compute_view``): each parameter
is gathered over dp and fsdp, keeping its tp shard: the decoder's
layer-stacked parameters one layer at a time, inside the layer's remat
checkpoints (FSDP's per-layer gather), the rest (embeddings, head,
vision towers) whole at the start of the step.  With tp > 1 the forward
runs on DTensors over the tp submesh, whose activations are replicated
over tp (the tp ranks of one batch slice hold the same rows); with tp =
1 it runs on plain tensors, as FSDP2 unshards a module's parameters for
its forward.  Each rank feeds its own dp x fsdp slice of the batch
(``core/distributed.py host_batch_slice``); the gradients come back
reduced over dp and reduce-scattered over fsdp into the leaves' own
placements.  So every loss and additive metric a step computes is this
rank's share: its numerator over its rows divided by the global count
(``batch_total``), and the step sums the shares over the batch ranks.

The hand kernels never see a DTensor: their wrappers apply the sharding
rule (``kernels/flash_attention.py`` ``mesh_batch_heads``) and call the
unsharded kernel on each rank's local shard.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

MESH_AXES = ("dp", "fsdp", "tp")

# The ambient mesh: build_mesh() arms it, and the training steps read it
# (the batch ranks' totals, the rollout's agreement on stopping).  Tests
# scope it with kernel_mesh_scope().  The kernel wrappers read the mesh
# of the DTensors they are given.
_KERNEL_MESH = None


def set_kernel_mesh(mesh):
    """Set the ambient mesh; returns the previous value."""
    global _KERNEL_MESH
    prev = _KERNEL_MESH
    _KERNEL_MESH = mesh
    return prev


def kernel_mesh():
    return _KERNEL_MESH


@contextlib.contextmanager
def kernel_mesh_scope(mesh):
    """Temporarily set (or clear, with None) the ambient mesh."""
    prev = set_kernel_mesh(mesh)
    try:
        yield mesh
    finally:
        set_kernel_mesh(prev)


# Default logical-axis -> mesh-axis rules.  "embed" over fsdp gives the
# ZeRO-3 analogue; vocab/mlp/heads over tp gives Megatron-style TP.
DEFAULT_RULES: dict[str, str | None] = {
    "batch": "dp",          # leading batch dim of activations
    "fsdp_batch": "fsdp",   # batch dims may also split over fsdp
    "embed": "fsdp",        # param hidden dim -> ZeRO-3 style shard
    "vocab": "tp",
    "mlp": "tp",
    "heads": "tp",
    "kv_heads": "tp",
    "qkv": "tp",
    "seq": None,            # sequence axis unsharded (no CP in the recipe)
    "head_dim": None,
    "patch": None,
    "norm": None,
    # the MoE expert axis rides tp in JAX; the port refuses tp > 1 for the
    # MoE (ROADMAP A.11b)
    "expert": "tp",
}


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes of the three mesh axes; -1 on at most one axis means "fill"."""

    dp: int = 1
    fsdp: int = -1
    tp: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int, int]:
        sizes = [self.dp, self.fsdp, self.tp]
        fill = [i for i, s in enumerate(sizes) if s == -1]
        if len(fill) > 1:
            raise ValueError("at most one mesh axis may be -1")
        if fill:
            known = int(np.prod([s for s in sizes if s != -1]))
            if n_devices % known:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {known}"
                )
            sizes[fill[0]] = n_devices // known
        if int(np.prod(sizes)) != n_devices:
            raise ValueError(
                f"mesh {tuple(sizes)} does not cover {n_devices} devices"
            )
        return tuple(sizes)


def mesh_config(section) -> MeshConfig:
    """A CLI's ``mesh`` section (a dict or a dataclass) -> MeshConfig."""
    if dataclasses.is_dataclass(section):
        section = dataclasses.asdict(section)
    section = section or {}
    return MeshConfig(int(section.get("dp", 1)), int(section.get("fsdp", -1)),
                      int(section.get("tp", 1)))


def build_mesh(config: MeshConfig | None = None,
               device_type: str | None = None):
    """The (dp, fsdp, tp) DeviceMesh over every rank of the process group,
    tp innermost (adjacent ranks share a host's fastest links), armed as
    the ambient mesh.  Without a process group there is no mesh: a config
    that resolves to one device returns None (the single-process path),
    any other raises."""
    config = config or MeshConfig()
    if not (dist.is_available() and dist.is_initialized()):
        try:
            config.resolve(1)
        except ValueError as e:
            n = int(np.prod([max(s, 1) for s in (config.dp, config.fsdp,
                                                 config.tp)]))
            raise ValueError(
                f"{e}: a mesh of {n} devices runs one process a device "
                f"(torchrun --nproc_per_node {n} -m ...)") from None
        set_kernel_mesh(None)
        return None
    shape = config.resolve(dist.get_world_size())
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh(device_type, shape, mesh_dim_names=MESH_AXES)
    set_kernel_mesh(mesh)
    return mesh


def mesh_shape(mesh) -> dict[str, int]:
    """{axis: size} of a DeviceMesh (or a dict already of that form)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def logical_to_spec(logical: Sequence[str | None],
                    rules: Mapping[str, str | None] | None = None) -> tuple:
    """Logical axis names -> the mesh axis of each tensor dim (None where
    replicated): the JAX ``PartitionSpec``'s entries."""
    rules = rules or DEFAULT_RULES
    spec = []
    for name in logical:
        if name is None:
            spec.append(None)
        else:
            if name not in rules:
                raise KeyError(f"no sharding rule for logical axis {name!r}")
            spec.append(rules[name])
    return tuple(spec)


def spec_placements(spec: Sequence, mesh_axes: Sequence[str] = MESH_AXES):
    """A per-tensor-dim spec (each entry None, an axis, or a tuple of axes)
    -> the DTensor placement on each mesh axis, in ``mesh_axes`` order."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in mesh_axes:
        dims = [d for d, entry in enumerate(spec)
                if entry == axis or (isinstance(entry, tuple)
                                     and axis in entry)]
        if len(dims) > 1:
            raise ValueError(f"mesh axis {axis!r} shards two dims of {spec}")
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def logical_to_mesh_axes(logical: Sequence[str | None],
                         rules: Mapping[str, str | None] | None = None,
                         mesh_axes: Sequence[str] = MESH_AXES):
    """Logical axis names -> the DTensor placements, one per mesh axis."""
    return spec_placements(logical_to_spec(logical, rules), mesh_axes)


def _is_logical(x) -> bool:
    return isinstance(x, tuple)


def _map_logical(fn, tree, logical_tree):
    if isinstance(tree, dict):
        return {k: _map_logical(fn, v, logical_tree[k])
                for k, v in tree.items()}
    return None if tree is None else fn(tree, logical_tree)


def pytree_shardings(logical_tree: Any, mesh,
                     rules: Mapping[str, str | None] | None = None) -> Any:
    """The placements tree of a logical-axis tree on ``mesh``."""
    names = mesh.mesh_dim_names
    if _is_logical(logical_tree):
        return logical_to_mesh_axes(logical_tree, rules, names)
    return {k: pytree_shardings(v, mesh, rules)
            for k, v in logical_tree.items()}


def shard_pytree(tree: Any, logical_tree: Any, mesh,
                 rules: Mapping[str, str | None] | None = None) -> Any:
    """Every leaf of ``tree`` as a DTensor placed by the parallel
    ``logical_tree``.  Every rank holds the same full tensors (the same
    seed or checkpoint) and keeps a copy of its own shard, so that the
    caller can free the full ones: nothing is sent."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    names = mesh.mesh_dim_names

    def place(t, logical):
        d = distribute_tensor(
            t.detach(), mesh, list(logical_to_mesh_axes(logical, rules,
                                                        names)),
            src_data_rank=None)
        return DTensor.from_local(d.to_local().clone(), mesh, d.placements,
                                  run_check=False, shape=d.shape,
                                  stride=d.stride())

    return _map_logical(place, tree, logical_tree)


# Batch keys whose LEADING dim is the example batch (split over dp x fsdp);
# every other key -- the host-precomputed vision index plans -- replicates.
_BATCH_LEADING_KEYS = frozenset({
    "input_ids", "labels", "segment_ids", "attention_mask",
    "prompt_ids", "prompt_segments", "prompt_positions",
    "completion_ids", "completion_mask", "completion_positions",
    "advantages", "old_logps", "ref_logps", "rewards",
    "chosen_ids", "rejected_ids", "chosen_labels", "rejected_labels",
    "mrope_deltas",
})


def batch_shardings(mesh, batch: Mapping[str, Any]) -> dict:
    """The placements of each array of a training or rollout batch:
    token-shaped arrays split their batch dim over (dp, fsdp) when it
    divides (replicated otherwise); ``position_ids`` of M-RoPE, [3, B, T],
    split dim 1; every vision auxiliary replicates.  ``mesh`` is a
    DeviceMesh or {axis: size}."""
    shape = mesh_shape(mesh)
    n_batch = shape["dp"] * shape["fsdp"]
    names = tuple(shape)
    data = spec_placements((("dp", "fsdp"),), names)
    mrope = spec_placements((None, ("dp", "fsdp")), names)
    rep = spec_placements((), names)

    def spec_for(key, v):
        dims = getattr(v, "shape", None)
        if dims is None:
            return rep
        if key == "position_ids":
            if len(dims) == 3:  # [sections, B, T] M-RoPE layout
                return mrope if dims[1] % n_batch == 0 else rep
            key = "input_ids"
        if key in _BATCH_LEADING_KEYS and len(dims) and \
                dims[0] % n_batch == 0:
            return data
        return rep

    return {k: spec_for(k, v) for k, v in batch.items()}


def shard_batch(mesh, batch: Mapping[str, Any]) -> dict:
    """The global batch (the same on every rank) as DTensors placed by
    ``batch_shardings``; each rank keeps its own rows."""
    from torch.distributed.tensor import distribute_tensor

    placements = batch_shardings(mesh, batch)
    return {k: distribute_tensor(torch.as_tensor(v).to(mesh.device_type),
                                 mesh, list(placements[k]),
                                 src_data_rank=None)
            for k, v in batch.items()}


def constrain_replicated(x):
    """A no-op.  In JAX it pins a small index plan to one layout on both
    sides of a ``jax.checkpoint`` so that XLA's per-program sharding
    guesses agree; here a rank's aux arrays are plain tensors of its own
    rows, replicated over tp by construction, and nothing guesses."""
    return x


def constrain_batch_aux(x):
    """A no-op, for the reason ``constrain_replicated`` gives: the rope
    tables are made from this rank's own rows."""
    return x


def constrain_scan_chunks(x):
    """A no-op, for the reason ``constrain_replicated`` gives: the chunked
    CE's blocks are this rank's own rows, and under tp the head product
    takes whatever layout DTensor gives it (the vocabulary sharded)."""
    return x


# ---------------------------------------------------------------------------
# the training step on a mesh
# ---------------------------------------------------------------------------


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local(t):
    """A DTensor's local shard (the same storage); any other tensor as it
    is."""
    return t.to_local() if is_dtensor(t) else t


def full(t):
    """A DTensor gathered whole on every rank (a collective: every rank of
    its mesh must call it); any other tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def batch_coordinate(mesh=None) -> tuple[int, int]:
    """(this rank's index among the dp x fsdp batch slices, their
    count); (0, 1) without a mesh."""
    mesh = kernel_mesh() if mesh is None else mesh
    if mesh is None:
        return 0, 1
    shape = mesh_shape(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    return coord["dp"] * shape["fsdp"] + coord["fsdp"], \
        shape["dp"] * shape["fsdp"]


_TP_MESHES: dict = {}
_BATCH_GROUPS: dict = {}


def tp_submesh(mesh):
    key = id(mesh)
    if key not in _TP_MESHES:
        _TP_MESHES[key] = (mesh, mesh["tp"])
    return _TP_MESHES[key][1]


def batch_group(mesh=None):
    """The process group of this rank's batch ranks (its dp x fsdp
    peers at its tp index), made on first use by every rank together."""
    mesh = kernel_mesh() if mesh is None else mesh
    key = id(mesh)
    if key not in _BATCH_GROUPS:
        ranks = mesh.mesh.reshape(-1, mesh_shape(mesh)["tp"])
        mine = None
        for t in range(ranks.shape[1]):
            group = dist.new_group([int(r) for r in ranks[:, t]])
            if dist.get_rank() in ranks[:, t].tolist():
                mine = group
        _BATCH_GROUPS[key] = (mesh, mine)
    return _BATCH_GROUPS[key][1]


def _compute_leaf(t):
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not is_dtensor(t):
        return t
    mesh = t.device_mesh
    tp_at = mesh.mesh_dim_names.index("tp")
    tp_pl = t.placements[tp_at]
    gathered = [p if i == tp_at else Replicate()
                for i, p in enumerate(t.placements)]
    grads = [p if i == tp_at else Partial()
             for i, p in enumerate(t.placements)]
    piece = t.redistribute(mesh, gathered).to_local(grad_placements=grads)
    if mesh.shape[tp_at] == 1:
        return piece
    return DTensor.from_local(piece, tp_submesh(mesh), [tp_pl],
                              run_check=False, shape=t.shape,
                              stride=t.stride())


# the decoder's layer-stacked subtrees (a text model's, a VLM's under
# "text"): ``compute_view`` of the whole tree leaves them sharded, and the
# decoder (models/qwen2.py, models/shared_prompt.py) gathers a layer at a
# time inside its checkpoints
DECODER_LAYERS = (("layers",), ("text", "layers"))


def compute_view(tree, _path=()):
    """The parameters as the forward reads them on a mesh: each DTensor
    leaf gathered over dp and fsdp, its tp shard kept, as a DTensor over
    the tp submesh when tp > 1 and as a plain tensor otherwise (as FSDP2
    unshards a module's parameters for its forward); differentiable, the
    gradients reduced back into the leaves' placements.  The decoder's
    stacked layers (DECODER_LAYERS) stay sharded: the decoder gathers each
    layer as it runs it.  A tree of plain tensors comes back as it is."""
    if isinstance(tree, dict):
        if _path in DECODER_LAYERS:
            return tree
        return {k: compute_view(v, _path + (k,)) for k, v in tree.items()}
    return None if tree is None else _compute_leaf(tree)


def mesh_scope():
    """The context of a forward and backward on the mesh: plain tensors
    (the batch, masks, positions) meet the DTensor parameters as
    replicated over tp.  A null context without a mesh or at tp = 1."""
    mesh = kernel_mesh()
    if mesh is None or mesh_shape(mesh)["tp"] == 1:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def run_replicated(fn, *args):
    """``fn`` on plain tensors: each DTensor argument (over the tp
    submesh) made replicated and read locally, and the tensor result
    replicated again; differentiable.  For an op that writes into a plain
    buffer in place, which DTensor cannot take; the tp ranks hold the same
    activations, so each computes the same result.  ``fn(*args)`` when no
    argument is a DTensor."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = next((a.device_mesh for a in args if is_dtensor(a)), None)
    if mesh is None:
        return fn(*args)
    rep = [Replicate()] * mesh.ndim
    out = fn(*(a.redistribute(mesh, rep).to_local() if is_dtensor(a) else a
               for a in args))
    return DTensor.from_local(out, mesh, rep, run_check=False)


def mesh_device(mesh=None) -> torch.device:
    """The device this rank's collectives on ``mesh`` take."""
    mesh = kernel_mesh() if mesh is None else mesh
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def batch_total(x):
    """``x`` (a tensor or a number) summed over the batch ranks, no
    gradient: the global count of a rank's local one.  Itself without a
    mesh, or with one batch rank."""
    mesh = kernel_mesh()
    if mesh is None or batch_coordinate(mesh)[1] == 1:
        return x
    if not isinstance(x, torch.Tensor):
        t = torch.tensor(x, device=mesh_device(mesh))
        dist.all_reduce(t, group=batch_group(mesh))
        return type(x)(t.item())
    x = full(x).detach().clone()
    dist.all_reduce(x, group=batch_group(mesh))
    return x


def batch_share(x):
    """Differentiable: the batch ranks' sum of ``x``, on every rank (the
    backward sums the cotangents over them too).  For a statistic that
    must be global before a nonlinear loss (the MoE router's)."""
    mesh = kernel_mesh()
    if mesh is None or batch_coordinate(mesh)[1] == 1:
        return x
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x, group=batch_group(mesh))


def batch_ranks() -> int:
    """The number of batch ranks (1 without a mesh)."""
    return batch_coordinate()[1]


def rank_share(x):
    """A value every batch rank holds whole (a global statistic) as this
    rank's share of the sum the step's metrics take over the batch ranks
    (``train/sft.py mesh_metrics``); ``x`` itself with one batch rank."""
    n = batch_ranks()
    return x if n == 1 else x / n


def global_mean(x):
    """The mean of every element of ``x`` over the batch ranks' rows, no
    gradient, the same on every rank; ``x.mean()`` without a mesh."""
    if batch_ranks() == 1:
        return x.mean()
    return batch_total(x.detach().sum()) / batch_total(
        torch.tensor(float(x.numel()), device=local(x).device))


def replicated_axes(tree):
    """The logical-axis tree that replicates every leaf of ``tree``: a
    head added to a sharded model (``shard_pytree`` of the tree under it
    places each leaf on every rank, as JAX's ``create_sharded_state``
    places an unannotated leaf)."""
    if isinstance(tree, dict):
        return {k: replicated_axes(v) for k, v in tree.items()}
    return None if tree is None else (None,) * tree.dim()


def batch_mean(x):
    """The mean over dim 0 of ``x`` as this rank's share: its rows' sum
    over the global row count on a mesh, ``x.mean()`` without one."""
    if batch_ranks() == 1:
        return x.mean()
    return x.sum() / batch_total(torch.tensor(float(x.shape[0]),
                                              device=local(x).device))


def all_done(done: torch.Tensor) -> bool:
    """Whether every row of every batch rank is done: a rank that stops
    decoding while another still runs would hang the group's next
    collective."""
    flag = done.all()
    if batch_ranks() == 1:
        return bool(flag)
    flag = flag.to(torch.int32)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN,
                    group=batch_group(kernel_mesh()))
    return bool(flag)


def gather_host_rows(rows: np.ndarray) -> np.ndarray:
    """The batch ranks' rows of a host array (as float64) concatenated in
    rank order, the global batch's order; ``rows`` itself with one batch
    rank."""
    if batch_ranks() == 1:
        return rows
    t = torch.as_tensor(np.asarray(rows).astype(np.float64),
                        device=mesh_device())
    return gather_batch_rows(t).cpu().numpy()


def gather_batch_rows(x: torch.Tensor) -> torch.Tensor:
    """The batch ranks' rows of ``x`` concatenated in rank order (the
    global batch's order); ``x`` itself with one batch rank."""
    if batch_ranks() == 1:
        return x
    group = batch_group(kernel_mesh())
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)
