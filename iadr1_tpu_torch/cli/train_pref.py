"""Preference-stage launcher (counterpart of iadr1_tpu/cli/train_pref.py):
DPO (sigmoid/hinge/ipo/orpo/simpo/cpo), KTO, BCO, the pairwise reward
model (rm), the process reward model (prm), PPO, RLOO, online DPO, XPO,
Nash-MD and GKD, over ranking, feedback, stepwise, prompt or conversation
datasets; runs on the card unless given ``--device cpu``.

* dpo / rm rows: {"messages": [...prompt turns...], "chosen": "...",
  "rejected": "..."} (chosen/rejected may be {"role", "content"} dicts)
* kto / bco rows: {"messages": [...full conversation...], "label": bool}
* prm rows: {"prompt": str | messages, "completions": [str, ...],
  "labels": [bool, ...]}
* ppo / rloo / online_dpo / xpo / nash_md rows: {"messages":
  [...prompt turns...], "solution": "..."}: prompts only; the completions
  come from the in-program rollout and are scored by ``pref.reward_funcs``
* gkd rows: {"messages": [...]}: a final assistant turn is the dataset
  completion; the teacher is ``pref.teacher_model_name_or_path``, a local
  HF checkpoint that shares the student's vocabulary, read in the
  student's dtype

Usage:
    python -m iadr1_tpu_torch.cli.train_pref --config dpo.yaml \
        stage=dpo pref.beta=0.1 train.max_steps=100 [--device cpu]

Two departures from the JAX launcher, both where its code departs from
its own documentation: a ranking pair shares one cut of its prompt
(``encode_pairwise_example``, ROADMAP C.R22), and KTO's KL rows pair the
prompt of row i with the completion of row i - 1 of the sampled batch
(C.R23).

Every stage runs on a ``(dp, fsdp, tp)`` mesh (``torchrun --nproc_per_node
N -m iadr1_tpu_torch.cli.train_pref`` with a ``mesh:`` section): the
policy, the reference and GKD's teacher are sharded by their families'
logical axes (each rank loads its own shards), and the heads added to the
model (RM's and PPO's value heads, PRM's head) are replicated.  Every rank
draws the same step's rows.  DPO and RM collate this rank's share of the
pairs; KTO, BCO and PRM collate the whole batch (KTO's KL rows pair
neighbours of it) and keep their share; the rollout stages and GKD hand
the whole list to the trainer, which takes its share by whole prompts and
rolls out on the mesh (``train/rollout.py``).  Each loss and metric is the
whole batch's, on every rank.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np

from iadr1_tpu_torch.cli.train_sft import (
    add_device_argument,
    load_checkpoint,
    mesh_refusals,
    shard_for_mesh,
)
from iadr1_tpu_torch.data.tokenize import IGNORE_INDEX, infer_seqlen

STAGES = ("dpo", "kto", "rm", "ppo", "rloo", "online_dpo", "xpo",
          "nash_md", "bco", "prm", "gkd")
ROLLOUT_STAGES = ("rloo", "online_dpo", "xpo", "nash_md")


@dataclasses.dataclass
class PrefSection:
    beta: float = 0.1                 # pref_beta
    loss_type: str = "sigmoid"        # sigmoid|hinge|ipo|orpo|simpo|cpo
    label_smoothing: float = 0.0
    simpo_gamma: float = 0.5
    ftx: float = 0.0
    # rloo / online_dpo (TRL's rloo and online_dpo config defaults)
    num_generations: int = 4          # rloo_k
    max_completion_length: int = 128
    kl_coef: float = 0.05             # rloo KL (through the k3 beta)
    missing_eos_penalty: float = 0.0  # online_dpo; 0 disables
    xpo_alpha: float = 1e-5           # xpo's exploration coefficient
    mixture_coef: float = 0.5         # nash_md's mixture opponent weight
    step_separator: str = "\n\n"      # prm step separator
    gkd_beta: float = 0.5             # gkd's JSD interpolant
    gkd_lmbda: float = 0.5            # gkd's on-policy share
    gkd_temperature: float = 0.9
    teacher_model_name_or_path: str = ""   # gkd's teacher checkpoint
    desirable_weight: float = 1.0     # kto
    undesirable_weight: float = 1.0   # kto
    ref_dtype: str = "bfloat16"
    reward_funcs: tuple = ("format", "accuracy")


@dataclasses.dataclass
class PrefDataSection:
    dataset_name: str = ""
    template: str = "qwen2_vl"
    cutoff_len: int = 1024
    max_samples: int | None = None


@dataclasses.dataclass
class PrefJobConfig:
    stage: str = "dpo"
    model: dict = dataclasses.field(default_factory=dict)
    data: PrefDataSection = dataclasses.field(default_factory=PrefDataSection)
    pref: PrefSection = dataclasses.field(default_factory=PrefSection)
    mesh: dict = dataclasses.field(default_factory=dict)
    optim: dict = dataclasses.field(default_factory=dict)
    train: dict = dataclasses.field(default_factory=dict)
    ppo: dict = dataclasses.field(default_factory=dict)  # PPOConfig fields


def require_ported(job: PrefJobConfig) -> None:
    """Raise for a stage the launcher does not know (a ValueError, as in
    JAX); every stage runs on one card and on a mesh."""
    if job.stage not in STAGES:
        raise ValueError(f"unknown stage {job.stage!r}; one of {STAGES}")


def place_replicated(tree, mesh):
    """A head added to the sharded model (RM's and PPO's value heads,
    PRM's head) placed on every rank of ``mesh``, so that the optimizer,
    ``compute_view`` and the checkpoint see one kind of leaf; as it is
    without a mesh."""
    if mesh is None:
        return tree
    from iadr1_tpu_torch.core.mesh import replicated_axes, shard_pytree

    return shard_pytree(tree, replicated_axes(tree), mesh)


def rank_rows(batch: dict, mesh) -> dict:
    """This rank's dp x fsdp share of a collated batch's rows (every
    array's leading dim); the batch as it is without a mesh."""
    if mesh is None:
        return batch
    from iadr1_tpu_torch.core.distributed import host_batch_slice

    rows = host_batch_slice(len(batch["input_ids"]), mesh)
    return {k: v[rows] for k, v in batch.items()}


def _content(x) -> str:
    return x["content"] if isinstance(x, dict) else str(x)


def _messages(row):
    return row.get("messages", row.get("conversations"))


def _pad_rows(rows, pad_id, length):
    """Right-pad encoded (ids, labels) rows into [N, length] arrays:
    ids, labels, segment ids and 1-D positions."""
    ids = np.full((len(rows), length), pad_id, np.int64)
    labels = np.full((len(rows), length), IGNORE_INDEX, np.int64)
    segs = np.zeros((len(rows), length), np.int64)
    pos = np.zeros((len(rows), length), np.int64)
    for i, (seq, lab) in enumerate(rows):
        n = min(len(seq), length)
        ids[i, :n] = seq[:n]
        labels[i, :n] = lab[:n]
        segs[i, :n] = 1
        pos[i, :n] = np.arange(n)
    return ids, labels, segs, pos


def _rows_batch(rows, pad_id, length, prefix=""):
    ids, labels, segs, pos = _pad_rows(rows, pad_id, length)
    return {f"{prefix}input_ids": ids, f"{prefix}labels": labels,
            f"{prefix}segment_ids": segs, f"{prefix}position_ids": pos}


def split_last_turn(messages, template, tokenizer, system=None):
    """(prompt_ids, completion_ids) of a conversation: every turn before
    the last response, and that response."""
    pairs = template.encode_multiturn(tokenizer, messages, system)
    prompt = [t for src, tgt in pairs[:-1] for t in src + tgt]
    return prompt + pairs[-1][0], pairs[-1][1]


def kl_rows(prompts, completions, cutoff_len):
    """KTO's KL rows: the prompt of row i with the completion of row
    i - 1 (the first row takes the last's), cut as a one-turn example and
    only the completion labeled."""
    rows = []
    for i, prompt in enumerate(prompts):
        completion = completions[i - 1]
        src, tgt = infer_seqlen(len(prompt), len(completion), cutoff_len)
        rows.append((prompt[:src] + completion[:tgt],
                     [IGNORE_INDEX] * src + completion[:tgt]))
    return rows


def prompt_examples(raw, template, tokenizer) -> list[dict]:
    """Prompt rows (the rollout stages): the conversation less a final
    assistant turn, encoded, plus the row's other columns."""
    examples = []
    for row in raw:
        messages = _messages(row)
        if messages and messages[-1].get("role") == "assistant":
            messages = messages[:-1]
        ex = {k: v for k, v in row.items()
              if k not in ("messages", "conversations")}
        ex["prompt_ids"] = template.encode_prompt(
            tokenizer, messages, system=row.get("system"))
        examples.append(ex)
    return examples


def gkd_examples(raw, template, tokenizer) -> list[dict]:
    """GKD's rows: the prompt (every turn before a final assistant turn)
    and that turn's text as the dataset completion ("" without one)."""
    examples = []
    for row in raw:
        messages = _messages(row)
        completion = ""
        if messages and messages[-1].get("role") == "assistant":
            completion = messages[-1]["content"]
            messages = messages[:-1]
        examples.append({
            "prompt_ids": template.encode_prompt(
                tokenizer, messages, system=row.get("system")),
            "completion_ids": tokenizer.encode(completion,
                                               add_special_tokens=False)})
    return examples


def make_collate(stage, raw, cfg: PrefJobConfig, template, tokenizer,
                 pad_id):
    """idx -> the step's batch (numpy) for the offline stages."""
    from iadr1_tpu_torch.data.tokenize import (
        encode_pairwise_example,
        encode_supervised_example,
    )

    T = cfg.data.cutoff_len
    if stage in ("dpo", "rm"):
        pairs = [encode_pairwise_example(
            _messages(row), _content(row["chosen"]),
            _content(row["rejected"]), template, tokenizer,
            system=row.get("system"), cutoff_len=T) for row in raw]

        def collate(idx):
            return _rows_batch([pairs[i][0] for i in idx]
                               + [pairs[i][1] for i in idx], pad_id, T)
        return collate
    if stage == "prm":
        from iadr1_tpu_torch.train.preference import encode_prm_example

        sep_ids = tokenizer.encode(cfg.pref.step_separator,
                                   add_special_tokens=False)
        encoded = []
        for row in raw:
            prompt = row["prompt"]
            prompt_ids = (template.encode_prompt(tokenizer, prompt)
                          if isinstance(prompt, list)
                          else tokenizer.encode(prompt,
                                                add_special_tokens=False))
            ids, labels = encode_prm_example(
                prompt_ids, [tokenizer.encode(c, add_special_tokens=False)
                             for c in row["completions"]],
                row["labels"], sep_ids)
            encoded.append((ids[:T], labels[:T]))

        def collate(idx):
            return _rows_batch([encoded[i] for i in idx], pad_id, T)
        return collate

    # kto / bco: feedback rows {messages, label}
    encoded, prompts, completions = [], [], []
    for row in raw:
        messages = _messages(row)
        encoded.append(encode_supervised_example(
            messages, template, tokenizer, system=row.get("system"),
            cutoff_len=T))
        if stage == "kto":
            prompt, completion = split_last_turn(messages, template,
                                                 tokenizer, row.get("system"))
            prompts.append(prompt)
            completions.append(completion)
    tags = np.asarray([bool(row.get("label", row.get("kto_tag", True)))
                       for row in raw])

    def collate(idx):
        batch = _rows_batch([encoded[i] for i in idx], pad_id, T)
        batch["tags"] = tags[idx].astype(np.int64)
        if stage == "kto":
            batch.update(_rows_batch(
                kl_rows([prompts[i] for i in idx],
                        [completions[i] for i in idx], T), pad_id, T,
                prefix="kl_"))
        return batch
    return collate


def reward_fn_of(funcs, extra_keys):
    """PPO's ``reward_fn(texts, examples)``: the summed reward functions
    over the examples' columns."""
    def reward_fn(texts, batch_examples):
        completions = [[{"role": "assistant", "content": t}] for t in texts]
        kwargs = {k: [ex.get(k) for ex in batch_examples]
                  for k in extra_keys}
        total = np.zeros(len(texts))
        for fn in funcs:
            total += np.asarray(
                fn(completions=completions, current_step=0, **kwargs),
                np.float64)
        return total
    return reward_fn


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True)
    add_device_argument(parser)
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    import torch
    from transformers import AutoTokenizer

    from iadr1_tpu_torch.core.config import dataclass_from_dict, load_config
    from iadr1_tpu_torch.core.device import resolve_device
    from iadr1_tpu_torch.core.distributed import (
        host_batch_slice,
        maybe_initialize_distributed,
    )
    from iadr1_tpu_torch.core.mesh import build_mesh, mesh_config
    from iadr1_tpu_torch.data.template import get_template
    from iadr1_tpu_torch.models.registry import (
        bundle_from_hf_config,
        bundle_from_pretrained,
    )
    from iadr1_tpu_torch.train.checkpoint import CheckpointManager
    from iadr1_tpu_torch.train.grpo import bundle_score_fn
    from iadr1_tpu_torch.train.loop import JsonlLogger, LoopConfig
    from iadr1_tpu_torch.train.optimizers import OptimizerConfig, make_optimizer
    from iadr1_tpu_torch.train.state import (
        create_train_state,
        named_leaves,
        unflatten,
    )

    # a multi-process launch: wire the ranks together before any device use
    maybe_initialize_distributed(args.device)
    cfg = load_config(PrefJobConfig, args.config, args.overrides)
    require_ported(cfg)
    if cfg.stage == "gkd" and not cfg.pref.teacher_model_name_or_path:
        raise ValueError("stage=gkd needs pref.teacher_model_name_or_path")
    device = resolve_device(args.device)
    mesh = build_mesh(mesh_config(cfg.mesh))
    loop_cfg = dataclass_from_dict(LoopConfig, cfg.train)
    opt_cfg = dataclass_from_dict(OptimizerConfig, cfg.optim)
    if not opt_cfg.total_steps:
        opt_cfg = dataclasses.replace(opt_cfg, total_steps=loop_cfg.max_steps)

    model_cfg = cfg.model
    dtype = getattr(torch, model_cfg.get("dtype", "float32"))
    attention = model_cfg.get("attention", "auto")
    if model_cfg.get("hf_config"):
        bundle = bundle_from_hf_config(model_cfg["hf_config"],
                                       attention=attention)
    else:
        bundle = bundle_from_pretrained(model_cfg["model_name_or_path"],
                                        attention=attention)
    mesh_refusals(bundle, mesh)
    if model_cfg.get("hf_config"):
        params = bundle.init_params(seed=model_cfg.get("seed", 0),
                                    dtype=dtype, device=device)
    else:
        params = load_checkpoint(bundle, model_cfg["model_name_or_path"],
                                 dtype, device, mesh)
    tokenizer = AutoTokenizer.from_pretrained(model_cfg["model_name_or_path"])
    template = get_template(cfg.data.template)
    pad_id = tokenizer.pad_token_id or tokenizer.eos_token_id
    hidden_size = getattr(bundle.cfg, "text", bundle.cfg).hidden_size

    with open(cfg.data.dataset_name) as f:
        raw = json.load(f)
    if cfg.data.max_samples:
        raw = raw[: cfg.data.max_samples]
    T = cfg.data.cutoff_len
    optimizer, schedule = make_optimizer(opt_cfg)
    params = shard_for_mesh(bundle, params, mesh)

    def reference():
        # a frozen copy in ref_dtype, never the policy's own tensors (the
        # policy is updated in place)
        ref_dtype = getattr(torch, cfg.pref.ref_dtype)
        return unflatten({name: p.detach().to(ref_dtype, copy=True)
                          for name, p in named_leaves(params)})

    def head_generator():
        return torch.Generator(device=device).manual_seed(1)

    trainer = step = None
    if cfg.stage in ROLLOUT_STAGES + ("ppo",):
        from iadr1_tpu_torch.rewards import get_reward_funcs

        examples = prompt_examples(raw, template, tokenizer)
        funcs = get_reward_funcs(list(cfg.pref.reward_funcs))
        common = dict(schedule=schedule, device=device, seed=loop_cfg.seed)
        if cfg.stage == "ppo":
            from iadr1_tpu_torch.train.ppo import (
                PPOConfig,
                PPOTrainer,
                make_ppo_state_params,
            )

            ref_params = reference()
            ppo_params = make_ppo_state_params(params, hidden_size,
                                               head_generator())
            ppo_params["vhead"] = place_replicated(ppo_params["vhead"], mesh)
            state = create_train_state(ppo_params, optimizer)
            extra = {k for ex in examples for k in ex if k != "prompt_ids"}
            trainer = PPOTrainer(
                bundle, tokenizer, optimizer,
                dataclass_from_dict(PPOConfig, cfg.ppo),
                reward_fn_of(funcs, extra), state, ref_params, **common)
        elif cfg.stage == "rloo":
            from iadr1_tpu_torch.train.grpo import GRPOConfig
            from iadr1_tpu_torch.train.online_rl import RLOOTrainer

            gcfg = GRPOConfig(
                num_generations=cfg.pref.num_generations,
                beta=cfg.pref.kl_coef, max_prompt_length=T,
                max_completion_length=cfg.pref.max_completion_length)
            ref_params = reference()
            trainer = RLOOTrainer(
                bundle, tokenizer, optimizer, gcfg, funcs,
                create_train_state(params, optimizer), ref_params, **common)
        elif cfg.stage in ("xpo", "nash_md"):
            from iadr1_tpu_torch.train import online_rl

            ref_params = reference()
            if cfg.stage == "xpo":
                cls, stage_cfg = online_rl.XPOTrainer, online_rl.XPOConfig(
                    beta=cfg.pref.beta, alpha=cfg.pref.xpo_alpha)
            else:
                cls, stage_cfg = (online_rl.NashMDTrainer,
                                  online_rl.NashMDConfig(
                                      beta=cfg.pref.beta,
                                      mixture_coef=cfg.pref.mixture_coef))
            trainer = cls(
                bundle, tokenizer, optimizer, stage_cfg, funcs,
                create_train_state(params, optimizer), ref_params,
                max_prompt_length=T,
                max_completion_length=cfg.pref.max_completion_length,
                **common)
        else:
            from iadr1_tpu_torch.train.online_rl import OnlineDPOTrainer
            from iadr1_tpu_torch.train.preference import DPOConfig

            dcfg = DPOConfig(beta=cfg.pref.beta,
                             loss_type=cfg.pref.loss_type,
                             label_smoothing=cfg.pref.label_smoothing)
            ref_params = reference() if dcfg.use_ref_model else {}
            trainer = OnlineDPOTrainer(
                bundle, tokenizer, optimizer, dcfg, funcs,
                create_train_state(params, optimizer), ref_params,
                max_prompt_length=T,
                max_completion_length=cfg.pref.max_completion_length,
                missing_eos_penalty=cfg.pref.missing_eos_penalty or None,
                **common)
        del ref_params
        n = len(examples)
    elif cfg.stage == "gkd":
        from iadr1_tpu_torch.train.gkd import GKDConfig, GKDTrainer

        teacher_path = cfg.pref.teacher_model_name_or_path
        teacher_bundle = bundle_from_pretrained(teacher_path,
                                                attention=attention)
        # on a mesh each rank loads its own shards of the teacher
        teacher_params = load_checkpoint(teacher_bundle, teacher_path, dtype,
                                         device, mesh)
        examples = gkd_examples(raw, template, tokenizer)
        trainer = GKDTrainer(
            bundle, teacher_bundle, tokenizer, optimizer, GKDConfig(
                beta=cfg.pref.gkd_beta, temperature=cfg.pref.gkd_temperature,
                lmbda=cfg.pref.gkd_lmbda, max_prompt_length=T,
                max_completion_length=cfg.pref.max_completion_length),
            create_train_state(params, optimizer), teacher_params,
            schedule=schedule, seed=loop_cfg.seed, device=device)
        del teacher_params
        n = len(examples)
    else:
        from iadr1_tpu_torch.train import preference as pref

        collate = make_collate(cfg.stage, raw, cfg, template, tokenizer,
                               pad_id)
        n = len(raw)
        ref_params = None
        if cfg.stage == "rm":
            state = create_train_state({
                "model": params,
                "value_head": place_replicated(pref.init_value_head(
                    head_generator(), hidden_size, dtype), mesh)}, optimizer)
            step = pref.make_rm_step(
                lambda p, b: bundle.hidden_fn(p, b), optimizer, schedule)
        elif cfg.stage == "prm":
            state = create_train_state({
                "model": params,
                "prm_head": place_replicated(pref.init_prm_head(
                    head_generator(), hidden_size, dtype=dtype), mesh)},
                optimizer)
            step = pref.make_prm_step(
                lambda p, b: bundle.hidden_fn(p, b), optimizer, schedule)
        elif cfg.stage == "bco":
            ref_params = reference()
            state = create_train_state(params, optimizer)
            step = pref.make_bco_step(
                bundle_score_fn(bundle), optimizer,
                pref.BCOConfig(beta=cfg.pref.beta), schedule)
        elif cfg.stage == "dpo":
            dcfg = pref.DPOConfig(
                beta=cfg.pref.beta, loss_type=cfg.pref.loss_type,
                label_smoothing=cfg.pref.label_smoothing,
                simpo_gamma=cfg.pref.simpo_gamma, ftx=cfg.pref.ftx)
            ref_params = reference() if dcfg.use_ref_model else {}
            state = create_train_state(params, optimizer)
            step = pref.make_dpo_step(bundle_score_fn(bundle), optimizer,
                                      dcfg, schedule)
        else:       # kto
            ref_params = reference()
            state = create_train_state(params, optimizer)
            step = pref.make_kto_step(
                bundle_score_fn(bundle), optimizer,
                pref.KTOConfig(beta=cfg.pref.beta,
                               desirable_weight=cfg.pref.desirable_weight,
                               undesirable_weight=cfg.pref.undesirable_weight),
                schedule)
        running = pref.RunningMoments() if cfg.stage == "bco" else None
    del params

    logger = JsonlLogger(loop_cfg.output_dir, loop_cfg.max_steps)
    ckpt = CheckpointManager(
        os.path.join(loop_cfg.output_dir, "checkpoints"),
        max_to_keep=loop_cfg.keep_checkpoints)
    rng = np.random.default_rng(loop_cfg.seed)
    bs = max(loop_cfg.batch_size, 1)
    try:
        for step_idx in range(1, loop_cfg.max_steps + 1):
            idx = rng.choice(n, size=min(bs, n), replace=False)
            if trainer is not None:
                # every rank hands over the whole list and takes its share
                metrics = trainer.step([examples[i] for i in idx])
                state = trainer.state
            elif cfg.stage in ("dpo", "rm"):
                if mesh is not None:    # this rank's share of the pairs
                    idx = idx[host_batch_slice(len(idx), mesh)]
                batch = collate(idx)
                state, metrics = (step(state, batch) if cfg.stage == "rm"
                                  else step(state, ref_params, batch))
            else:
                # the rows collated over the whole sampled batch (KTO's KL
                # rows pair neighbours of it), then this rank's share
                batch = rank_rows(collate(idx), mesh)
                if cfg.stage == "prm":
                    state, metrics = step(state, batch)
                elif cfg.stage == "bco":
                    # BCO's reward shift: one host sync a step, as in JAX;
                    # the metrics are the whole batch's on every rank
                    state, metrics = step(state, ref_params, batch,
                                          running.mean)
                    running.update(float(metrics["reward_mean"]),
                                   float(metrics["reward_var"]),
                                   float(metrics["reward_count"]))
                else:
                    state, metrics = step(state, ref_params, batch)
            if step_idx % max(loop_cfg.logging_steps, 1) == 0:
                logger.log(step_idx, {k: float(v) for k, v in metrics.items()})
            if loop_cfg.save_steps and step_idx % loop_cfg.save_steps == 0:
                ckpt.save(step_idx, state)
        ckpt.save(loop_cfg.max_steps, state)
        ckpt.wait()
    finally:
        logger.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
