"""One rank of a multi-process Gloo run of the port (pytest does not
collect this file: tests/test_torch_distributed.py starts it once a rank).

    python tests/torch_mesh_worker.py CASE WORLD RANK INIT_FILE OUT_DIR ARGS

``ARGS`` is a JSON object.  The process joins the group through
``file://INIT_FILE`` (no port to race for), runs the case on the CPU and
writes what the test reads into ``OUT_DIR`` (``rank{RANK}.json`` and the
files the case names).  It imports nothing of JAX.
"""

import functools
import json
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))
torch.set_num_threads(1)


def _f32_compute():
    """The registry's bundles compute in f32, as the JAX side is run."""
    from iadr1_tpu_torch.core.precision import FULL_PRECISION
    from iadr1_tpu_torch.models import registry

    for name in ("bundle_from_hf_config", "bundle_from_pretrained"):
        setattr(registry, name, functools.partial(getattr(registry, name),
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


def count_layer_gathers() -> list:
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

    qwen2.compute_view = counted
    return count


def record_base() -> dict:
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

    GRPOTrainer.__init__ = init
    return {"check": check, "sharded": sharded}


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


def case_cli(args) -> dict:
    """One of the training CLIs' ``main`` on a config with a mesh."""
    import importlib

    if args.get("f32"):
        _f32_compute()
    if args.get("heads"):
        given_heads(args["heads"])
    if args.get("jax_kl_pairing"):
        jax_kl_pairing()
    kto_batches = record_kto_batches() if args.get("record_kto") else None
    kinds = record_leaf_kinds()
    tokens = record_tokens() if args.get("record_tokens") else None
    if args.get("length_reward"):
        length_reward()
    if args.get("f32_cache"):
        f32_cache()
    if args.get("fused_ce"):
        fused_ce()
    base = record_base() if args.get("record_base") else None
    gathers = count_layer_gathers()
    main = importlib.import_module(
        f"iadr1_tpu_torch.cli.{args['cli']}").main
    try:
        rc = main(["--config", args["config"], "--device", "cpu"]
                  + args.get("overrides", []))
    except NotImplementedError as e:
        return {"refused": str(e)}
    from iadr1_tpu_torch.core.mesh import kernel_mesh, mesh_shape

    out = {"rc": rc, "mesh": mesh_shape(kernel_mesh()), **_kernel_shapes(),
           "layer_gathers": gathers[0], "leaf_kinds": kinds}
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


def case_optimizer(args) -> dict:
    """One update of each optimizer of ``args["optims"]`` on a small tree
    sharded by its logical axes: the parameters after it, gathered, from
    rank 0 ({name: [leaves]})."""
    from torch.distributed.tensor import distribute_tensor

    from iadr1_tpu_torch.core.mesh import shard_pytree
    from iadr1_tpu_torch.train.optimizers import OptimizerConfig, make_optimizer
    from iadr1_tpu_torch.train.state import create_train_state, tree_leaves

    mesh = _mesh(args["mesh"])
    inputs = torch.load(args["inputs"])
    updated, sharded = {}, True
    for name, optim in args["optims"].items():
        params = shard_pytree(inputs["params"], inputs["axes"], mesh)
        opt, _ = make_optimizer(OptimizerConfig(**optim))
        state = create_train_state(params, opt)
        leaves = tree_leaves(state.params)
        grads = [distribute_tensor(g, p.device_mesh, p.placements,
                                   src_data_rank=None)
                 for g, p in zip(inputs["grads"], leaves)]
        state.apply_gradients(grads, opt)
        updated[name] = [p.full_tensor().detach().clone() for p in leaves]
        sharded &= all(type(p).__name__ == "DTensor" for p in leaves)
    if dist.get_rank() == 0:
        torch.save(updated, os.path.join(args["out"], "params.pt"))
    return {"dtensor": sharded}


def case_checkpoint(args) -> dict:
    """A state sharded by its logical axes saved through CheckpointManager
    (rank 0 writes), then restored onto the same mesh; a tiny Qwen2's
    sharded parameters exported by ``save_pretrained``."""
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
    return {"restored": same, "step": fresh.step,
            "count": fresh.opt_state["count"]}


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



CASES = {"cli": case_cli, "kernels": case_kernels, "batch": case_batch,
         "optimizer": case_optimizer, "checkpoint": case_checkpoint,
         "lora_sft": case_lora_sft, "load": case_load,
         "fused_ce": case_fused_ce}


def main():
    case, world, rank, init_file, out_dir, args = sys.argv[1:7]
    args = dict(json.loads(args), out=out_dir)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=int(rank), world_size=int(world))
    try:
        result = CASES[case](args)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
