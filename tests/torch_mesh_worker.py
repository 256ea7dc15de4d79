"""One rank of a multi-process Gloo run of the port (pytest does not
collect this file: tests/test_torch_distributed.py starts it once a rank).

    python tests/torch_mesh_worker.py CASE WORLD RANK INIT_FILE OUT_DIR ARGS

``ARGS`` is a JSON object.  The process joins the group through
``file://INIT_FILE`` (no port to race for), runs the case on the CPU and
writes what the test reads into ``OUT_DIR`` (``rank{RANK}.json`` and the
files the case names).  It imports nothing of JAX.
"""

import functools
import inspect
import json
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))
torch.set_num_threads(1)


def _f32_compute(patch=setattr):
    """The registry's bundles compute in f32, as the JAX side is run."""
    from iadr1_tpu_torch.core.precision import FULL_PRECISION
    from iadr1_tpu_torch.models import registry

    for name in ("bundle_from_hf_config", "bundle_from_pretrained"):
        patch(registry, name, functools.partial(getattr(registry, name),
                                                precision=FULL_PRECISION))


def _kernel_shapes() -> dict:
    from iadr1_tpu_torch.kernels import decode_attention, flash_attention

    return {"flash_calls": flash_attention.MESH_CALLS.calls,
            "flash_shapes": flash_attention.MESH_CALLS.local_shapes,
            "decode_calls": decode_attention.MESH_CALLS.calls,
            "decode_shapes": decode_attention.MESH_CALLS.local_shapes}


def record_tokens(patch=setattr) -> list:
    """Record every rollout's completion ids (this rank's rows; a
    mixture's rollout too) into the returned list; ``patch`` is
    ``setattr`` or a test's ``monkeypatch.setattr``."""
    from iadr1_tpu_torch.train.rollout import RolloutEngine

    seen, inner = [], RolloutEngine._generate

    def generate(self, *args, **kw):
        out = inner(self, *args, **kw)
        seen.append(out["completion_ids"].cpu())
        return out

    patch(RolloutEngine, "_generate", generate)
    return seen


def f32_cache(patch=setattr) -> None:
    """Every RolloutEngine keeps its KV cache in f32: a tp decode's
    row-parallel sums round otherwise than one process's, and a bf16 cache
    turns that 1e-7 into a 2^-8 difference wherever a value crosses a
    rounding boundary, enough to move a draw over the whole vocabulary."""
    from iadr1_tpu_torch.train.rollout import RolloutEngine

    inner = RolloutEngine.__init__

    def init(self, *a, **kw):
        inner(self, *a, **dict(kw, cache_dtype=torch.float32))

    patch(RolloutEngine, "__init__", init)


def length_reward(patch=setattr) -> None:
    """Every GRPO run's reward list becomes one reward that varies with
    the completion's length, so that the advantages are not all 0."""
    import iadr1_tpu_torch.rewards as rewards

    def length_reward(completions, **kw):
        return [float(len(c[0]["content"]) % 5) for c in completions]

    patch(rewards, "get_reward_funcs", lambda names: [length_reward])


def count_layer_gathers(patch=setattr) -> list:
    """Count the decoder's gathers of one layer's shards (``compute_view``
    called by models/qwen2.py on DTensors); returns the one-item count."""
    from iadr1_tpu_torch.core.mesh import is_dtensor
    from iadr1_tpu_torch.models import qwen2
    from iadr1_tpu_torch.train.state import tree_leaves

    count, inner = [0], qwen2.compute_view

    def counted(tree):
        leaves = tree_leaves(tree) if isinstance(tree, dict) else [tree]
        count[0] += any(is_dtensor(t) and t.device_mesh.ndim == 3
                        for t in leaves)
        return inner(tree)

    patch(qwen2, "compute_view", counted)
    return count


# the modules whose block loops gather a tower block at a time
TOWER_MODULES = ("qwen2_vl", "qwen25_vl", "siglip", "internvl", "pixtral")


def _mesh_bytes(tree) -> int:
    """The global bytes of the leaves of ``tree`` that are DTensors on the
    (dp, fsdp, tp) mesh (the shards a gather reads whole)."""
    from iadr1_tpu_torch.core.mesh import is_dtensor
    from iadr1_tpu_torch.train.state import tree_leaves

    leaves = tree_leaves(tree) if isinstance(tree, dict) else [tree]
    return sum(t.numel() * t.element_size() for t in leaves
               if is_dtensor(t) and t.device_mesh.ndim == 3)


# the block functions of the tower modules (each module has some of them)
TOWER_BLOCKS = ("_block", "_block_save_flash", "_block_save_acts",
                "_tower_block", "_tower_block_save_acts")


def count_tower_gathers(patch=setattr) -> dict:
    """The towers' gathers of their blocks' shards (``compute_view``,
    ``compute_view_of`` and ``view_gathered_again`` called by the tower
    modules on mesh DTensors): {"calls", "largest": the most bytes one
    call gathered, "block": the bytes of one block of the largest tower
    stack the run's train state holds, "held": the most bytes of the
    weights that earlier blocks' dense layers read (each kernel as the
    layer casts it) still alive when a block starts, so kept for the
    backward}."""
    import importlib
    import weakref

    from iadr1_tpu_torch.core.mesh import TOWER_LAYERS, local
    from iadr1_tpu_torch.train import state

    seen = {"calls": 0, "largest": 0, "block": 0, "held": 0}
    read, inside = [], []

    def counted(fn):
        def call(tree, *keys):
            n = _mesh_bytes({k: tree[k] for k in keys} if keys else tree)
            if n:
                seen["calls"] += 1
                seen["largest"] = max(seen["largest"], n)
            return fn(tree, *keys)
        return call

    def recorded(dense):
        def call(x, kernel, bias=None):
            if inside and isinstance(kernel, torch.Tensor):
                kernel = kernel.to(x.dtype)
                read.append((weakref.ref(kernel), local(kernel).nbytes))
            return dense(x, kernel, bias)
        return call

    def block(fn):
        def call(*args, **kw):
            read[:] = [(r, n) for r, n in read if r() is not None]
            seen["held"] = max(seen["held"], sum(n for _, n in read))
            inside.append(fn)
            try:
                return fn(*args, **kw)
            finally:
                inside.pop()
        return call

    for name in TOWER_MODULES:
        mod = importlib.import_module(f"iadr1_tpu_torch.models.{name}")
        for fn in ("compute_view", "compute_view_of", "view_gathered_again"):
            if hasattr(mod, fn):
                patch(mod, fn, counted(getattr(mod, fn)))
        patch(mod, "dense", recorded(mod.dense))
        for fn in TOWER_BLOCKS:
            if hasattr(mod, fn):
                patch(mod, fn, block(getattr(mod, fn)))
    create = state.create_train_state

    def created(params, optimizer):
        for path in TOWER_LAYERS:
            node = params
            for key in path:
                node = node.get(key) if isinstance(node, dict) else None
            leaves = state.tree_leaves(node) if node else []
            if leaves:
                seen["block"] = max(seen["block"],
                                    _mesh_bytes(node) // leaves[0].shape[0])
        return create(params, optimizer)

    patch(state, "create_train_state", created)
    return seen


def record_base(patch=setattr) -> dict:
    """Snapshot (whole) the frozen base a LoRA GRPOTrainer is given, and
    compare it at the end: {"check": () -> whether it is bitwise unchanged
    on this rank}."""
    from iadr1_tpu_torch.core.mesh import full
    from iadr1_tpu_torch.train.grpo import GRPOTrainer
    from iadr1_tpu_torch.train.state import tree_leaves

    seen, inner = {}, GRPOTrainer.__init__

    def init(self, *a, **kw):
        inner(self, *a, **kw)
        seen["trainer"] = self
        seen["before"] = [full(t).clone() for t in tree_leaves(
            self.ref_params)]

    def check():
        after = [full(t) for t in tree_leaves(seen["trainer"].ref_params)]
        return len(after) > 0 and all(
            torch.equal(a, b) for a, b in zip(after, seen["before"]))

    def sharded():
        return [type(t).__name__ == "DTensor"
                for t in tree_leaves(seen["trainer"].ref_params)]

    patch(GRPOTrainer, "__init__", init)
    return {"check": check, "sharded": sharded}


def record_pissa(path: str, patch=setattr) -> None:
    """Save what ``pissa_init`` gives the GRPO CLI, gathered whole, to
    ``path``: {"lora": {name: tensor}, "residual": {name: tensor}}."""
    from iadr1_tpu_torch.core.mesh import full
    from iadr1_tpu_torch.train import adapters
    from iadr1_tpu_torch.train.state import named_leaves

    inner = adapters.pissa_init

    def pissa_init(params, cfg, **kw):
        lora, residual = inner(params, cfg, **kw)
        torch.save({side: {name: full(t).detach().clone()
                           for name, t in named_leaves(tree)}
                    for side, tree in (("lora", lora),
                                       ("residual", residual))}, path)
        return lora, residual

    patch(adapters, "pissa_init", pissa_init)


def record_writes(root: str, patch=setattr) -> dict:
    """The files this process opens for writing under ``root``, and its
    calls of the chain's export and eval stage: {"files": [...],
    "exports": n, "evals": n}."""
    import builtins

    from iadr1_tpu_torch.cli import pipeline

    seen = {"files": [], "exports": 0, "evals": 0}
    inner_open = builtins.open

    def opened(file, mode="r", *a, **kw):
        if any(c in mode for c in "wax") and str(file).startswith(root):
            seen["files"].append(os.path.relpath(str(file), root))
        return inner_open(file, mode, *a, **kw)

    def counted(key, fn):
        def call(*a, **kw):
            seen[key] += 1
            return fn(*a, **kw)
        return call

    patch(builtins, "open", opened)
    patch(pipeline, "export_run", counted("exports", pipeline.export_run))
    patch(pipeline, "_eval_stage", counted("evals", pipeline._eval_stage))
    return seen


def given_heads(path: str, patch=setattr) -> None:
    """The preference launcher's added heads (RM's value head, PRM's head)
    read from ``path`` (``torch.save`` of {"value_head": ..., "prm_head":
    ...}, the JAX launcher's draws) instead of drawn from the port's
    generator."""
    from iadr1_tpu_torch.train import preference

    heads = torch.load(path)
    patch(preference, "init_value_head",
          lambda *a, **k: {n: t.clone() for n, t in heads["value_head"].items()})
    patch(preference, "init_prm_head",
          lambda *a, **k: {n: t.clone() for n, t in heads["prm_head"].items()})


def jax_kl_pairing(patch=setattr) -> None:
    """KTO's KL row i made the JAX launcher's way (ROADMAP C.R23): the
    prompt of row i - 1 with its own completion, the whole target row
    i - 1, instead of the prompt of row i with the completion of row
    i - 1."""
    from iadr1_tpu_torch.cli import train_pref

    inner = train_pref.kl_rows

    def kl_rows(prompts, completions, cutoff_len):
        return inner([prompts[i - 1] for i in range(len(prompts))],
                     completions, cutoff_len)

    patch(train_pref, "kl_rows", kl_rows)


def record_kto_batches(patch=setattr) -> list:
    """Every batch a KTO step is given (numpy), in order."""
    import numpy as np

    from iadr1_tpu_torch.train import preference

    seen, make = [], preference.make_kto_step

    def wrapped(*a, **kw):
        step = make(*a, **kw)

        def run(state, ref, batch):
            seen.append({k: np.asarray(v) for k, v in batch.items()})
            return step(state, ref, batch)
        return run

    patch(preference, "make_kto_step", wrapped)
    return seen


def record_leaf_kinds(patch=setattr) -> dict:
    """Whether every leaf of each train state the run creates, and of a
    GKD teacher, is a DTensor: {"state": [bool, ...], "teacher": [...]}."""
    from torch.distributed.tensor import DTensor

    from iadr1_tpu_torch.train import gkd, state
    from iadr1_tpu_torch.train.state import tree_leaves

    kinds = {"state": [], "teacher": []}
    create, init = state.create_train_state, gkd.GKDTrainer.__init__

    def all_dtensors(tree):
        return all(isinstance(t, DTensor) for t in tree_leaves(tree))

    def created(params, optimizer):
        kinds["state"].append(all_dtensors(params))
        return create(params, optimizer)

    def gkd_init(self, *a, **kw):
        init(self, *a, **kw)
        kinds["teacher"].append(all_dtensors(self.teacher_params))

    patch(state, "create_train_state", created)
    patch(gkd.GKDTrainer, "__init__", gkd_init)
    return kinds


def fused_ce(patch=setattr) -> None:
    """Every SFT step the run makes uses the fused chunked CE
    (``train/sft.py`` ``make_fused_chunked_ce``)."""
    from iadr1_tpu_torch.train import sft

    make = sft.make_chunked_sft_step
    patch(sft, "make_chunked_sft_step",
          lambda *a, **kw: make(*a, **dict(kw, fused_ce=True)))


def case_cli(args, patch=setattr) -> dict:
    """One of the training CLIs' ``main`` on a config with a mesh."""
    import importlib

    if args.get("f32"):
        _f32_compute(patch)
    if args.get("heads"):
        given_heads(args["heads"], patch)
    if args.get("jax_kl_pairing"):
        jax_kl_pairing(patch)
    kto_batches = (record_kto_batches(patch) if args.get("record_kto")
                   else None)
    kinds = record_leaf_kinds(patch)
    tokens = record_tokens(patch) if args.get("record_tokens") else None
    if args.get("length_reward"):
        length_reward(patch)
    if args.get("f32_cache"):
        f32_cache(patch)
    if args.get("fused_ce"):
        fused_ce(patch)
    if args.get("record_pissa"):
        record_pissa(os.path.join(
            args["out"], f"pissa{dist.get_rank() if dist.is_initialized() else 0}.pt"),
            patch)
    base = record_base(patch) if args.get("record_base") else None
    gathers = count_layer_gathers(patch)
    towers = count_tower_gathers(patch)
    main = importlib.import_module(
        f"iadr1_tpu_torch.cli.{args['cli']}").main
    rc = main(["--config", args["config"], "--device", "cpu"]
              + args.get("overrides", []))
    from iadr1_tpu_torch.core.mesh import kernel_mesh, mesh_shape

    mesh = kernel_mesh()
    out = {"rc": rc, "mesh": None if mesh is None else mesh_shape(mesh),
           **_kernel_shapes(),
           "layer_gathers": gathers[0], "tower_gathers": towers,
           "leaf_kinds": kinds}
    if tokens is not None:
        out["tokens"] = [t.tolist() for t in tokens]
    if base is not None:
        out["base_unchanged"] = base["check"]()
        out["base_sharded"] = base["sharded"]()
    if kto_batches is not None:
        out["kto_batches"] = [{k: v.tolist() for k, v in b.items()}
                              for b in kto_batches]
    return out


def case_fused_ce(args) -> dict:
    """The fused CE's loop (``train/sft.py`` ``_fused_ce``) on this tp
    rank's columns of the head, its statistics reduced over the mesh's tp
    group (``MeshTP``): the loss, correct and label counts, d_hidden part
    and d_W columns written for the test to hold to one rank's loop."""
    from iadr1_tpu_torch.core.tensor_parallel import MeshTP
    from iadr1_tpu_torch.train.sft import _fused_ce

    group = MeshTP(_mesh(args["mesh"]))
    hidden, kernel, labels = torch.load(args["inputs"])
    V = kernel.shape[1]
    per = -(-V // group.size)
    lo = group.rank * per
    out = _fused_ce(hidden, kernel[:, lo:lo + per], labels, args["chunk"],
                    torch.float32, True, (group, lo, V))
    torch.save(out, os.path.join(args["out"],
                                 f"fused_ce{dist.get_rank()}.pt"))
    return {}


def _mesh(shape):
    from iadr1_tpu_torch.core.mesh import MeshConfig, build_mesh

    return build_mesh(MeshConfig(*shape))


def case_kernels(args) -> dict:
    """K1-K3 (dlse != 0) and K4 twins behind the sharding rule on
    DTensors replicated over the mesh, gathered back whole: every rank
    writes its results for the test to hold to the unsharded calls."""
    from torch.distributed.tensor import DTensor, Replicate

    from iadr1_tpu_torch.kernels.decode_attention import decode_attention
    from iadr1_tpu_torch.kernels.flash_attention import flash_attention

    mesh = _mesh(args["mesh"])
    inputs = torch.load(args["inputs"])
    rep = [Replicate()] * mesh.ndim

    def dt(t, grad=False):
        d = DTensor.from_local(t.clone(), mesh, rep, run_check=False)
        return d.requires_grad_(grad)

    q, k, v = (dt(inputs[n], True) for n in ("q", "k", "v"))
    out, lse = flash_attention(q, k, v, segment_ids=dt(inputs["seg"]),
                               kv_segment_ids=dt(inputs["seg"]),
                               causal=True)
    torch.autograd.backward([out, lse], [dt(inputs["do"]),
                                         dt(inputs["dlse"])])
    dec = decode_attention(dt(inputs["dq"]), dt(inputs["ck"]),
                           dt(inputs["cv"]), dt(inputs["cseg"]),
                           inputs["length"])
    result = {name: t.full_tensor().detach() for name, t in (
        ("out", out), ("lse", lse), ("dq", q.grad), ("dk", k.grad),
        ("dv", v.grad), ("decode", dec))}
    torch.save(result, os.path.join(args["out"], f"kernels{dist.get_rank()}.pt"))
    return _kernel_shapes()


def opt_state_bytes(state) -> int:
    """The bytes of an optimizer state this rank holds: every tensor of
    its per-leaf lists, a DTensor's local shard."""
    from iadr1_tpu_torch.core.mesh import local

    return sum(local(t).nbytes for v in state.values() if isinstance(v, list)
               for t in v if t is not None)


def state_placed_as_params(state, leaves) -> bool:
    """Whether every state tensor shaped like its parameter is a DTensor
    with the parameter's placements."""
    from torch.distributed.tensor import DTensor

    return all(isinstance(t, DTensor) and t.placements == p.placements
               for v in state.values() if isinstance(v, list)
               for t, p in zip(v, leaves)
               if t is not None and t.shape == p.shape)


def case_optimizer(args) -> dict:
    """Two updates of each optimizer of ``args["optims"]`` on a small tree
    sharded by its logical axes: the parameters after them, gathered, from
    rank 0 ({name: [leaves]}); each rank's optimizer-state bytes after each
    update, whether the state lies as the parameters, and the matrices the
    updates gathered (``core/mesh.py`` MATRIX_GATHERS)."""
    from torch.distributed.tensor import distribute_tensor

    from iadr1_tpu_torch.core.mesh import MATRIX_GATHERS, shard_pytree
    from iadr1_tpu_torch.train.optimizers import (
        OptimizerConfig,
        global_norm,
        make_optimizer,
    )
    from iadr1_tpu_torch.train.state import create_train_state, tree_leaves

    mesh = _mesh(args["mesh"])
    inputs = torch.load(args["inputs"])
    updated, sharded, out = {}, True, {}
    for name, optim in args["optims"].items():
        params = shard_pytree(inputs["params"], inputs["axes"], mesh)
        opt, _ = make_optimizer(OptimizerConfig(**optim))
        state = create_train_state(params, opt)
        leaves = tree_leaves(state.params)
        MATRIX_GATHERS.__init__()
        state_bytes, norms = [], []
        for step_grads in inputs["grads"]:
            grads = [distribute_tensor(g, p.device_mesh, p.placements,
                                       src_data_rank=None)
                     for g, p in zip(step_grads, leaves)]
            norms.append(float(global_norm(grads)))
            state = state.apply_gradients(grads, opt)
            state_bytes.append(opt_state_bytes(state.opt_state))
        updated[name] = [p.full_tensor().detach().clone() for p in leaves]
        sharded &= all(type(p).__name__ == "DTensor" for p in leaves)
        out[name] = {"state_bytes": state_bytes, "grad_norms": norms,
                     "placed": state_placed_as_params(state.opt_state,
                                                      leaves),
                     "gathers": MATRIX_GATHERS.calls,
                     "largest_gather": MATRIX_GATHERS.largest}
    if dist.get_rank() == 0:
        torch.save(updated, os.path.join(args["out"], "params.pt"))
    return {"dtensor": sharded, "optims": out}


def fill_state(state) -> None:
    """Every tensor of an optimizer state's per-leaf lists set to values
    drawn from a seed (in [0.1, 1.1): a second moment's square root is
    taken), the same whole tensors on every rank and on one process, each
    rank keeping its shard; the count set to 1."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    for k, key in enumerate(sorted(k for k, v in state.items()
                                   if isinstance(v, list))):
        for i, t in enumerate(state[key]):
            if t is None:
                continue
            gen = torch.Generator().manual_seed(1000 * k + i)
            whole = (torch.rand(t.shape, generator=gen) + 0.1).to(t.dtype)
            if isinstance(t, DTensor):
                whole = distribute_tensor(whole, t.device_mesh, t.placements,
                                          src_data_rank=None).to_local()
                t = t.to_local()
            t.copy_(whole)
    state["count"] = 1


def case_checkpoint(args) -> dict:
    """A state sharded by its logical axes saved through CheckpointManager
    (rank 0 writes), then restored onto the same mesh; a tiny Qwen2's
    sharded parameters exported by ``save_pretrained``.  Then each
    optimizer of ``args["optims"]``: its state filled (``fill_state``),
    saved at step 1, restored into a fresh mesh state, which takes the
    second update of ``case_optimizer``'s gradients: its parameters after
    it, gathered, from rank 0 (``params_{name}.pt``)."""
    from iadr1_tpu_torch.core.mesh import shard_pytree
    from iadr1_tpu_torch.train.checkpoint import CheckpointManager
    from iadr1_tpu_torch.train.optimizers import OptimizerConfig, make_optimizer
    from iadr1_tpu_torch.train.state import create_train_state, tree_leaves

    mesh = _mesh(args["mesh"])
    inputs = torch.load(args["inputs"])
    opt, _ = make_optimizer(OptimizerConfig(total_steps=4))
    state = create_train_state(
        shard_pytree(inputs["params"], inputs["axes"], mesh), opt)
    for t, m in zip(state.opt_state["mu"], inputs["mu"]):
        t.to_local().copy_(torch.distributed.tensor.distribute_tensor(
            m, t.device_mesh, t.placements, src_data_rank=None).to_local())
    state.opt_state["count"] = 3
    state = state._replace(step=3)
    mgr = CheckpointManager(args["dir"])
    mgr.save(3, state)
    fresh = create_train_state(
        shard_pytree(zeros_like_tree(inputs["params"]), inputs["axes"],
                     mesh), opt)
    fresh = mgr.restore(fresh)
    same = all(torch.equal(a.full_tensor(), b.full_tensor()) for a, b in zip(
        tree_leaves(fresh.params) + fresh.opt_state["mu"],
        tree_leaves(state.params) + state.opt_state["mu"]))
    from iadr1_tpu_torch.models.params_export import save_pretrained
    from iadr1_tpu_torch.models.registry import bundle_from_hf_config

    bundle = bundle_from_hf_config(args["hf"])
    params = bundle.init_params(seed=0, dtype=torch.float32, device="cpu")
    save_pretrained(bundle, shard_pytree(params, bundle.logical_axes(), mesh),
                    args["export"])
    restored = {}
    for name, optim in args.get("optims", {}).items():
        restored[name] = _optimizer_checkpoint(name, optim, inputs, mesh,
                                               args)
    return {"restored": same, "step": fresh.step,
            "count": fresh.opt_state["count"], "optims": restored}


def _optimizer_checkpoint(name, optim, inputs, mesh, args) -> bool:
    """``case_checkpoint``'s round trip of one optimizer's state; whether
    the restored state equals the saved one, tensor for tensor."""
    from torch.distributed.tensor import distribute_tensor

    from iadr1_tpu_torch.core.mesh import full, shard_pytree
    from iadr1_tpu_torch.train.checkpoint import CheckpointManager
    from iadr1_tpu_torch.train.optimizers import OptimizerConfig, make_optimizer
    from iadr1_tpu_torch.train.state import create_train_state, tree_leaves

    opt, _ = make_optimizer(OptimizerConfig(**optim))
    state = create_train_state(
        shard_pytree(inputs["params"], inputs["axes"], mesh), opt)
    fill_state(state.opt_state)
    mgr = CheckpointManager(os.path.join(args["dir"], name))
    mgr.save(1, state._replace(step=1))
    fresh = mgr.restore(create_train_state(
        shard_pytree(zeros_like_tree(inputs["params"]), inputs["axes"],
                     mesh), opt))
    same = fresh.opt_state["count"] == 1 and all(
        torch.equal(full(a), full(b))
        for key, v in state.opt_state.items() if isinstance(v, list)
        for a, b in zip(fresh.opt_state[key], v) if b is not None)
    leaves = tree_leaves(fresh.params)
    fresh.apply_gradients(
        [distribute_tensor(g, p.device_mesh, p.placements, src_data_rank=None)
         for g, p in zip(inputs["grads"][1], leaves)], opt)
    after = [full(p).detach() for p in leaves]
    if dist.get_rank() == 0:
        torch.save(after, os.path.join(args["out"], f"params_{name}.pt"))
    return same


def case_tower_views(args) -> dict:
    """``compute_view`` of each family's whole parameter tree (tiny HF
    configs ``args["families"]``, f32 from a seed) sharded on the mesh:
    {family: {"stacks": the TOWER_LAYERS paths the tree holds, "sharded":
    whether their leaves come back as the mesh's own DTensors, "gathered":
    whether every leaf outside them and the decoder's stack
    (DECODER_LAYERS) comes back a plain tensor (tp = 1)}}."""
    from iadr1_tpu_torch.core.mesh import (
        DECODER_LAYERS,
        TOWER_LAYERS,
        compute_view,
        is_dtensor,
        shard_pytree,
    )
    from iadr1_tpu_torch.models.registry import bundle_from_hf_config
    from iadr1_tpu_torch.train.state import named_leaves

    mesh = _mesh(args["mesh"])
    out = {}
    for family, hf in args["families"].items():
        bundle = bundle_from_hf_config(hf)
        params = shard_pytree(bundle.init_params(
            seed=0, dtype=torch.float32, device="cpu"), bundle.logical_axes(),
            mesh)
        view = dict(named_leaves(compute_view(params), sep="/"))
        stacks = ["/".join(p) for p in TOWER_LAYERS
                  if any(n.startswith("/".join(p) + "/") for n in view)]
        decoder = ["/".join(p) for p in DECODER_LAYERS]

        def under(n, paths):
            return any(n.startswith(p + "/") for p in paths)

        whole = dict(named_leaves(params, sep="/"))
        out[family] = {
            "stacks": stacks,
            "sharded": all(view[n] is whole[n] for n in view
                           if under(n, stacks)),
            "gathered": all(not is_dtensor(view[n]) for n in view
                            if not under(n, stacks + decoder))}
    return out


def case_tower_remat(args) -> dict:
    """The towers of tiny Qwen2-VL and LLaVA-OneVision (SigLIP)
    (``args["families"]``: family -> HF config), f32 parameters from a
    seed sharded on the mesh, computing in bf16 (the default precision),
    on inputs from a seed, under each remat mode of ``REMATS``: rank 0
    saves each one's output and the parameters' gradients gathered
    ({family: {mode: [output, *grads]}}, ``towers.pt``); every rank
    returns each run's ``count_tower_gathers`` records."""
    from iadr1_tpu_torch.core.mesh import (
        compute_view,
        full,
        mesh_scope,
        shard_pytree,
    )
    from iadr1_tpu_torch.models import qwen2_vl, siglip
    from iadr1_tpu_torch.models.registry import bundle_from_hf_config
    from iadr1_tpu_torch.train.state import tree_leaves

    mesh = _mesh(args["mesh"])
    gen = torch.Generator().manual_seed(11)
    saved, records = {}, {}
    for family, hf in args["families"].items():
        bundle = bundle_from_hf_config(hf)
        cfg, precision = bundle.cfg.vision, bundle.precision
        params = {"vision": shard_pytree(bundle.init_params(
            seed=0, dtype=torch.float32, device="cpu"),
            bundle.logical_axes(), mesh)["vision"]}
        if family == "qwen2_vl":
            P = 16
            inputs = (torch.randn(P, cfg.patch_dim, generator=gen),
                      torch.randn(P, cfg.head_dim, generator=gen),
                      torch.randn(P, cfg.head_dim, generator=gen),
                      torch.tensor([1] * 8 + [2] * 8))

            def tower(view, remat, inputs=inputs, cfg=cfg):
                return qwen2_vl.apply_vision(view, cfg, *inputs,
                                             precision=precision,
                                             remat=remat)
        else:
            tiles = torch.randn(2, (cfg.image_size // cfg.patch_size) ** 2,
                                3 * cfg.patch_size ** 2, generator=gen)

            def tower(view, remat, tiles=tiles, cfg=cfg):
                return siglip.apply(view, cfg, tiles, precision, remat)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        saved[family], records[family] = {}, {}
        for remat in REMATS:
            undo = []

            def patch(obj, name, value):
                undo.append((obj, name, getattr(obj, name)))
                setattr(obj, name, value)

            seen = count_tower_gathers(patch)
            try:
                with mesh_scope():
                    out = tower(compute_view(params)["vision"], remat)
                    grads = torch.autograd.grad(
                        out.float().square().sum(), leaves)
            finally:
                for obj, name, value in reversed(undo):
                    setattr(obj, name, value)
            saved[family][str(remat)] = [full(out).detach()] + [
                g.full_tensor() for g in grads]
            records[family][str(remat)] = seen
    if dist.get_rank() == 0:
        torch.save(saved, os.path.join(args["out"], "towers.pt"))
    return records


# the tower remat modes ``case_tower_remat`` runs
REMATS = ("save_acts", False)


def case_batch(args) -> dict:
    """The global batch's placements on the mesh: each rank's local shapes
    from ``shard_batch`` and ``make_global_batch``, its rows by
    ``host_batch_slice``, and a parameter tree's placements."""
    import numpy as np

    from iadr1_tpu_torch.core.distributed import (
        host_batch_slice,
        make_global_batch,
    )
    from iadr1_tpu_torch.core.mesh import (
        kernel_mesh,
        kernel_mesh_scope,
        pytree_shardings,
        shard_batch,
    )

    mesh = _mesh(args["mesh"])
    B, T = 4, 6
    batch = {"input_ids": np.arange(B * T).reshape(B, T),
             "position_ids": np.zeros((3, B, T), np.int64),
             "patches": np.ones((5, 3), np.float32)}
    sharded = shard_batch(mesh, batch)
    rows = host_batch_slice(B, mesh)
    glob = make_global_batch({"input_ids": batch["input_ids"][rows]}, mesh)
    with kernel_mesh_scope(None):
        unarmed = kernel_mesh() is None
    placements = pytree_shardings({"w": ("embed", "mlp"), "n": ("norm",)},
                                  mesh)
    return {"local": {k: list(v.to_local().shape) for k, v in sharded.items()},
            "first_id": int(sharded["input_ids"].to_local()[0, 0]),
            "rows": [rows.start, rows.stop],
            "global": list(glob["input_ids"].shape),
            "global_equal": bool(torch.equal(
                glob["input_ids"].full_tensor(),
                torch.as_tensor(batch["input_ids"]))),
            "unarmed": unarmed, "armed": kernel_mesh() is mesh,
            "placements": {k: [str(p) for p in v]
                           for k, v in placements.items()}}


def case_lora_sft(args) -> dict:
    """LoRA SFT through the library on a mesh: the checkpoint loaded
    sharded, the adapters drawn whole and placed by their logical axes,
    ``args["steps"]`` chunked-CE steps on this rank's rows of a fixed text
    batch; the metrics, the adapters after (gathered, from rank 0) and
    whether the base is bitwise unchanged."""
    import numpy as np

    from iadr1_tpu_torch.cli.train_sft import load_checkpoint
    from iadr1_tpu_torch.core.distributed import host_batch_slice
    from iadr1_tpu_torch.core.mesh import full
    from iadr1_tpu_torch.models.registry import bundle_from_pretrained
    from iadr1_tpu_torch.train.state import named_leaves

    _f32_compute()
    mesh = _mesh(args["mesh"])
    bundle = bundle_from_pretrained(args["ckpt"])
    base = load_checkpoint(bundle, args["ckpt"], torch.float32, "cpu", mesh)
    before = [full(t).clone() for _, t in named_leaves(base)]
    state, step, batches = lora_sft_setup(bundle, base, args, mesh)
    rows = host_batch_slice(len(batches[0]["input_ids"]), mesh)
    metrics = []
    for batch in batches:
        state, m = step(state, {k: np.asarray(v)[rows]
                                for k, v in batch.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    lora = {name: full(t).detach() for name, t in named_leaves(state.params)}
    if dist.get_rank() == 0:
        torch.save(lora, os.path.join(args["out"], "lora.pt"))
    same = all(torch.equal(full(t), b) for (_, t), b in
               zip(named_leaves(base), before))
    return {"metrics": metrics, "base_unchanged": same,
            "sharded": all(type(t).__name__ == "DTensor"
                           for _, t in named_leaves(state.params))}


def lora_sft_setup(bundle, base, args, mesh=None):
    """(state, step, batches) of ``case_lora_sft`` (the test's one-process
    run calls it too): LoRA rank 4 (alpha 8) on every decoder projection,
    AdamW, and ``args["steps"]`` batches of 4 packed text rows drawn from
    a seed."""
    import numpy as np

    from iadr1_tpu_torch.cli.train_grpo import shard_adapters
    from iadr1_tpu_torch.train.adapters import (
        TuningConfig,
        init_lora_params,
        lora_training_fns,
    )
    from iadr1_tpu_torch.train.optimizers import OptimizerConfig, make_optimizer
    from iadr1_tpu_torch.train.sft import make_chunked_sft_step
    from iadr1_tpu_torch.train.state import create_train_state

    tuning = TuningConfig(finetuning_type="lora", lora_rank=4,
                          lora_alpha=8.0, use_dora=args.get("dora", False))
    lora = init_lora_params(torch.Generator().manual_seed(1), base, tuning)
    # B = 0 would leave the first step's loss the base's: start elsewhere
    for leaf in _adapter_bs(lora):
        leaf.add_(0.01)
    lora = shard_adapters(bundle, lora, mesh)
    opt, schedule = make_optimizer(OptimizerConfig(
        learning_rate=1e-2, warmup_ratio=0.0, total_steps=4))
    hidden_fn, head_fn = lora_training_fns(bundle, base, tuning, remat=True)
    step = make_chunked_sft_step(hidden_fn, head_fn, opt, schedule,
                                 chunk_size=64)
    rng = np.random.default_rng(3)
    vocab = getattr(bundle.cfg, "text", bundle.cfg).vocab_size
    B, T = 4, 32
    batches = []
    for _ in range(args["steps"]):
        ids = rng.integers(3, vocab, (B, T))
        seg = np.ones((B, T), np.int32)
        seg[1, 20:] = 2
        seg[3, 25:] = 0
        labels = np.where(seg > 0, ids, -100)
        pos = np.where(seg == 2, np.arange(T) - 20, np.arange(T))
        batches.append({"input_ids": ids, "labels": labels,
                        "segment_ids": seg, "position_ids": pos})
    return create_train_state(lora, opt), step, batches


def _adapter_bs(tree):
    if isinstance(tree, dict):
        if "b" in tree and "a" in tree:
            return [tree["b"]]
        return [b for v in tree.values() for b in _adapter_bs(v)]
    return []


def case_load(args) -> dict:
    """The sharded load of a checkpoint onto the mesh, held to
    ``shard_pytree`` of the whole converted tree; each rank's local
    shapes and the sizes ``load_sharded`` measured."""
    from iadr1_tpu_torch.core.mesh import shard_pytree
    from iadr1_tpu_torch.models.params_io import (
        load_safetensors_path,
        load_sharded,
    )
    from iadr1_tpu_torch.models.registry import bundle_from_pretrained
    from iadr1_tpu_torch.train.state import named_leaves

    mesh = _mesh(args["mesh"])
    bundle = bundle_from_pretrained(args["ckpt"])
    stats = {}
    got = load_sharded(bundle.convert_hf, args["ckpt"],
                       bundle.logical_axes(), mesh, torch.bfloat16, "cpu",
                       stats)
    whole = bundle.convert_hf(load_safetensors_path(args["ckpt"]),
                              dtype=torch.bfloat16, device="cpu")
    want = shard_pytree(whole, bundle.logical_axes(), mesh)
    pairs = list(zip(named_leaves(got), named_leaves(want)))
    return {
        "names_equal": all(a[0] == b[0] for a, b in pairs),
        "mismatched": [a[0] for a, b in pairs if not (
            torch.equal(a[1].to_local(), b[1].to_local())
            and a[1].placements == b[1].placements
            and a[1].shape == b[1].shape)],
        "local": {a[0]: list(a[1].to_local().shape) for a, _ in pairs},
        "stats": stats,
        "whole_leaf_bytes": max(t.numel() * t.element_size()
                                for _, t in named_leaves(whole)),
        "largest_shard_bytes": max(
            t.to_local().numel() * t.to_local().element_size()
            for _, t in named_leaves(want)),
    }


def zeros_like_tree(tree):
    if isinstance(tree, dict):
        return {k: zeros_like_tree(v) for k, v in tree.items()}
    return torch.zeros_like(tree)



def case_pipeline(args, patch=setattr) -> dict:
    """The one-call chain's ``main`` on every rank; what this rank wrote
    under the chain's output directory (``record_writes``)."""
    from iadr1_tpu_torch.cli import pipeline

    if args.get("length_reward"):
        length_reward(patch)
    seen = record_writes(args["root"], patch)
    rc = pipeline.main(["--config", args["config"], "--device", "cpu"])
    return {"rc": rc, **seen}


def case_jobs(args) -> dict:
    """Several cases in one process group, one after another, each with
    its patches undone after it (one spawn for a test file's cases):
    {job name: the case's result}.  Each job's ``out`` is its own
    subdirectory."""
    from iadr1_tpu_torch.kernels import decode_attention, flash_attention

    results = {}
    for job in args["jobs"]:
        undo = []

        def patch(obj, name, value, undo=undo):
            undo.append((obj, name, getattr(obj, name)))
            setattr(obj, name, value)

        out = os.path.join(args["out"], job["name"])
        os.makedirs(out, exist_ok=True)
        for calls in (flash_attention.MESH_CALLS,
                      decode_attention.MESH_CALLS):
            calls.__init__()
        fn = CASES[job["case"]]
        kw = ({"patch": patch}
              if "patch" in inspect.signature(fn).parameters else {})
        try:
            results[job["name"]] = fn(dict(job["args"], out=out), **kw)
        finally:
            for obj, name, value in reversed(undo):
                setattr(obj, name, value)
        if dist.is_initialized():
            dist.barrier()
    return results


CASES = {"cli": case_cli, "pipeline": case_pipeline, "kernels": case_kernels, "batch": case_batch,
         "optimizer": case_optimizer, "checkpoint": case_checkpoint,
         "lora_sft": case_lora_sft, "load": case_load,
         "fused_ce": case_fused_ce, "tower_views": case_tower_views,
         "tower_remat": case_tower_remat}


def main():
    """``ARGS["no_group"]``: one process with no process group (a
    one-process reference run in a worker's environment)."""
    case, world, rank, init_file, out_dir, args = sys.argv[1:7]
    args = dict(json.loads(args), out=out_dir)
    group = not args.get("no_group")
    if group:
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=int(rank), world_size=int(world))
    try:
        result = (case_jobs(args) if case == "jobs"
                  else CASES[case](args))
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
    finally:
        if group:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
