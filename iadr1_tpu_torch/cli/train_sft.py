"""PA-SFT launcher (counterpart of iadr1_tpu/cli/train_sft.py): a yaml or
json config plus dotted overrides; runs on the card unless given
``--device cpu``.

Usage:
    python -m iadr1_tpu_torch.cli.train_sft --config sft.yaml \
        train.max_steps=20 optim.learning_rate=1e-4 [--device cpu]

``predict.do_predict`` generates on the dataset's prompts after training
(``run_predict``: generated_predictions.jsonl, then the ROUGE/BLEU scores
in predict_results.json, which need ``jieba`` and ``nltk``;
``--no-predict-scores`` skips the scores).  On a mesh (``torchrun
--nproc_per_node N -m iadr1_tpu_torch.cli.train_sft --config ...`` with a
``mesh:`` section, ``core/mesh.py``) the parameters and moments are
sharded by the family's logical axes, each rank collates its dp x fsdp
share of every step's rows, and rank 0 logs and writes; each rank loads
only its own shards of the checkpoint (``load_checkpoint``); every
family runs at any (dp, fsdp, tp), the MoE with its experts split over
tp (``models/qwen2_moe.py``).  Context
extension runs as in JAX: ``model.rope_scaling`` with
``model.model_max_length`` rewrites the config (into its ``text_config``
where it has one, ROADMAP C.R18), ``model.shift_attn`` trains with
LongLoRA's shift-short attention over ``model.attention``.  A Qwen2-MoE
model adds its router's load-balancing loss (``router_aux_loss_coef``).
``prepare_rows`` prepends PaliGemma's image runs to the encoded ids, and
raises where they leave the text no room under ``cutoff_len`` (the JAX
package clamps the text's budget at 8 tokens, and packing drops the
over-long row: ROADMAP C.R4).
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import math
import os


@dataclasses.dataclass
class ModelSection:
    model_name_or_path: str = ""       # HF checkpoint dir (config+safetensors)
    hf_config: dict | None = None      # inline config -> random init
    attention: str = "auto"            # auto | flash | xla
    dtype: str = "float32"             # parameter dtype
    seed: int = 0
    rope_scaling: str | None = None    # linear | dynamic | llama3
    model_max_length: int | None = None
    shift_attn: bool = False           # LongLoRA shift-short attention
    remat: str = "true"                # true | save_qkv | full | false
    tower_remat: str = "default"       # default | save_acts | full | false


@dataclasses.dataclass
class PredictSection:
    """After training, greedy-generate on the dataset rows and write
    generated_predictions.jsonl."""
    do_predict: bool = False
    max_samples: int = 0               # 0 = all rows
    max_new_tokens: int = 128
    temperature: float = 0.0
    batch_size: int = 4


@dataclasses.dataclass
class DataSection:
    dataset: str = ""                  # name in dataset_info.json, or a .json path
    dataset_info: str | None = None
    image_dir: str | None = None
    template: str = "qwen2_vl"
    cutoff_len: int = 2048
    packing: bool = True
    tokenized_path: str | None = None  # cache of the packed, tokenized rows
    max_samples: int | None = None
    patch_budget: int = 4096
    min_pixels: int = 56 * 56
    max_pixels: int = 480000
    ce_chunk: int = 1024               # rows of one chunked-CE LM-head block
    ce_logits_dtype: str = "float32"   # stored dtype of each logits block


@dataclasses.dataclass
class MeshSection:
    dp: int = 1
    fsdp: int = -1                     # -1: every device left over
    tp: int = 1


@dataclasses.dataclass
class SFTJobConfig:
    stage: str = "sft"                 # sft | pt (continued pretraining)
    model: ModelSection = dataclasses.field(default_factory=ModelSection)
    data: DataSection = dataclasses.field(default_factory=DataSection)
    mesh: MeshSection = dataclasses.field(default_factory=MeshSection)
    optim: dict = dataclasses.field(default_factory=dict)
    train: dict = dataclasses.field(default_factory=dict)
    predict: PredictSection = dataclasses.field(default_factory=PredictSection)


def mesh_devices(mesh: dict) -> int:
    """Devices a mesh section asks for beyond the one card (fsdp -1 fills
    what is left, which on one card is 1)."""
    n = 1
    for axis in ("dp", "fsdp", "tp"):
        n *= max(int(mesh.get(axis, 1)), 1)
    return n


def require_ported(job: SFTJobConfig) -> None:
    """Raise for an option the port cannot run yet, naming its item: none
    of the SFT job's is left, on one card or on a mesh."""


def shard_for_mesh(bundle, params, mesh):
    """The parameters as DTensors placed by the family's logical axes on
    ``mesh``; as they are without one, or when they are sharded already
    (``load_checkpoint``)."""
    from iadr1_tpu_torch.core.mesh import is_dtensor, shard_pytree
    from iadr1_tpu_torch.train.state import tree_leaves

    if mesh is None or any(is_dtensor(t) for t in tree_leaves(params)):
        return params
    return shard_pytree(params, bundle.logical_axes(), mesh)


def load_checkpoint(bundle, path: str, dtype, device, mesh=None):
    """A checkpoint's parameters: converted whole onto ``device`` without
    a mesh; on one, the sharded load (``models/params_io.py
    load_sharded``): one leaf at a time converted on the host from the
    memory-mapped files, each rank putting only its own shards on its
    card."""
    from iadr1_tpu_torch.models.params_io import (
        load_safetensors_path,
        load_sharded,
    )

    if mesh is None:
        return bundle.convert_hf(load_safetensors_path(path), dtype=dtype,
                                 device=device)
    return load_sharded(bundle.convert_hf, path, bundle.logical_axes(), mesh,
                        dtype, device)


def rank_collate(collate, mesh):
    """``collate`` over this rank's dp x fsdp share of a step's rows."""
    if mesh is None:
        return collate
    from iadr1_tpu_torch.core.distributed import host_batch_slice

    return lambda rows: collate(rows[host_batch_slice(len(rows), mesh)])


def context_extension(model: ModelSection, hf_config: dict):
    """(the HF config, the attention kind) after the model section's
    context extension: ``rope_scaling`` rewrites the config
    (``configure_rope_scaling``), ``shift_attn`` trains with LongLoRA's
    shift-short attention over the selected kind."""
    if model.rope_scaling:
        from iadr1_tpu_torch.models.registry import configure_rope_scaling

        hf_config = configure_rope_scaling(hf_config, model.rope_scaling,
                                           model.model_max_length)
    attention = model.attention
    if model.shift_attn and not attention.startswith("longlora"):
        attention = ("longlora" if attention == "auto"
                     else f"longlora_{attention}")
    return hf_config, attention


def predict_generate(bundle, params, tokenizer, template,
                     data_cfg: DataSection, pred_cfg: PredictSection,
                     output_dir: str, device=None):
    """Generate on the dataset prompts and write generated_predictions.jsonl
    ({"prompt", "label", "predict"} per row -- the reference's
    save_predictions schema, train/sft/trainer.py:137-171); returns (path,
    predictions, labels)."""
    from iadr1_tpu_torch.data.aligner import align_rows
    from iadr1_tpu_torch.data.registry import (
        DatasetAttr,
        load_dataset_registry,
        load_json_dataset,
    )
    from iadr1_tpu_torch.eval.generator import GeneratorConfig, VLMGenerator

    if data_cfg.dataset.endswith((".json", ".jsonl")):
        attr = DatasetAttr(
            name="inline", file_name=data_cfg.dataset, formatting="sharegpt",
            messages="messages", images="images",
            role_tag="role", content_tag="content",
            user_tag="user", assistant_tag="assistant",
        )
    else:
        attr = load_dataset_registry(data_cfg.dataset_info)[data_cfg.dataset]
    records = align_rows(load_json_dataset(attr), attr, data_cfg.image_dir)
    if pred_cfg.max_samples:
        records = records[: pred_cfg.max_samples]

    gen = VLMGenerator(
        bundle, params, tokenizer, template,
        GeneratorConfig(
            max_prompt_length=data_cfg.cutoff_len,
            max_new_tokens=pred_cfg.max_new_tokens,
            temperature=pred_cfg.temperature,
            batch_size=pred_cfg.batch_size,
            min_pixels=data_cfg.min_pixels, max_pixels=data_cfg.max_pixels,
        ),
        device=device,
    )
    requests, prompts, labels = [], [], []
    for rec in records:
        msgs = rec["messages"]
        label = msgs[-1]["content"] if msgs[-1]["role"] == "assistant" else ""
        prompt_msgs = msgs[:-1] if label else msgs
        requests.append({"messages": prompt_msgs, "images": rec["images"]})
        prompts.append(
            template.render_conversation(prompt_msgs,
                                         add_generation_prompt=True))
        labels.append(label)
    preds = gen.generate(requests)
    path = os.path.join(output_dir, "generated_predictions.jsonl")
    os.makedirs(output_dir, exist_ok=True)
    with open(path, "w") as f:
        for prompt, label, predict in zip(prompts, labels, preds):
            f.write(json.dumps(
                {"prompt": prompt, "label": label, "predict": predict},
                ensure_ascii=False) + "\n")
    print(f"predictions saved to {path}")
    return path, preds, labels


def predict_scores(preds, labels, output_dir: str) -> dict:
    """predict_results.json: the ROUGE/BLEU similarity scores (the
    reference's ComputeSimilarity metrics logged by
    CustomSeq2SeqTrainer.predict) under ``predict_<metric>`` keys."""
    from iadr1_tpu_torch.train.metrics_text import similarity_scores

    scores = similarity_scores(preds, labels)
    with open(os.path.join(output_dir, "predict_results.json"), "w") as f:
        json.dump({f"predict_{k}": v for k, v in scores.items()}, f, indent=1)
    print("similarity: "
          + ", ".join(f"{k}={v:.2f}" for k, v in scores.items()))
    return scores


def run_predict(bundle, params, tokenizer, template, data_cfg: DataSection,
                pred_cfg: PredictSection, output_dir: str,
                device=None) -> str:
    """``predict_generate`` then ``predict_scores``; returns the
    predictions' path."""
    path, preds, labels = predict_generate(bundle, params, tokenizer,
                                           template, data_cfg, pred_cfg,
                                           output_dir, device=device)
    predict_scores(preds, labels, output_dir)
    return path


def load_tokenizer(path: str):
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(path)


def prepare_rows(cfg: DataSection, tokenizer, template, bundle,
                 stage: str = "sft") -> list[dict]:
    """registry/json -> aligned -> (image tokens expanded) -> encoded ->
    packed rows.

    stage "pt": raw-text language modeling -- message contents are
    concatenated, every token (plus EOS) is labeled, no template or
    masking."""
    from iadr1_tpu_torch.data.aligner import align_rows
    from iadr1_tpu_torch.data.mm import (
        expand_image_tokens,
        prepend_image_tokens,
    )
    from iadr1_tpu_torch.data.packing import pack_examples
    from iadr1_tpu_torch.data.registry import (
        DatasetAttr,
        load_dataset_registry,
        load_json_dataset,
    )
    from iadr1_tpu_torch.data.tokenize import encode_supervised_example

    if cfg.dataset.endswith((".json", ".jsonl")):
        # a sharegpt file of ``messages`` (role/content) and ``images``
        attr = DatasetAttr(
            name="inline", file_name=cfg.dataset, formatting="sharegpt",
            messages="messages", images="images",
            role_tag="role", content_tag="content",
            user_tag="user", assistant_tag="assistant",
        )
    else:
        attr = load_dataset_registry(cfg.dataset_info)[cfg.dataset]
    rows = load_json_dataset(attr)
    if cfg.max_samples:
        rows = rows[: cfg.max_samples]

    pad_id = tokenizer.pad_token_id
    if pad_id is None:
        pad_id = tokenizer.eos_token_id

    if stage == "pt":
        # raw-text LM: read text straight off the rows (a "text" column or
        # concatenated message contents) -- the conversation aligner would
        # drop response-less rows
        encoded = []
        for row in rows:
            if "text" in row:
                text = row["text"]
            else:
                msgs = row.get(attr.messages or "messages",
                               row.get("messages", []))
                text = "\n".join(
                    m.get(attr.content_tag or "content", m.get("content", ""))
                    for m in msgs
                )
            ids = tokenizer.encode(text, add_special_tokens=False)
            ids = ids[: cfg.cutoff_len - 2] + [tokenizer.eos_token_id]
            encoded.append({"input_ids": ids, "labels": list(ids)})
        return pack_examples(encoded, cfg.cutoff_len, pad_id)

    encoded = []
    for rec in align_rows(rows, attr, cfg.image_dir):
        messages = rec["messages"]
        extras = {}
        if bundle.multimodal and rec["images"]:
            from PIL import Image

            patches, grids, seqlens = [], [], []
            for img in rec["images"]:
                pil = Image.open(img) if isinstance(img, str) else img
                flat, grid, seqlen = bundle.preprocess_image(
                    pil, min_pixels=cfg.min_pixels, max_pixels=cfg.max_pixels)
                patches.append(flat)
                grids.append(grid)
                seqlens.append(seqlen)
            messages = expand_image_tokens(
                messages, seqlens, template.mm_style, template.image_token)
            extras = {"patches": patches, "grid_thw": grids}
        elif rec["images"]:
            # text model given image data: strip placeholders
            messages = [
                {**m, "content": m["content"].replace("<image>", "")}
                for m in messages
            ]
        cut = cfg.cutoff_len - 1
        prefix = extras and template.mm_style == "paligemma"
        if prefix:
            # the image runs go ahead of the encoded ids: the text gets
            # what they leave, and a row they leave no room in raises
            cut -= sum(seqlens)
            if cut < 1:
                raise ValueError(
                    f"{sum(seqlens)} image tokens leave the text no room "
                    f"under cutoff_len={cfg.cutoff_len}; raise cutoff_len")
        input_ids, labels = encode_supervised_example(
            messages, template, tokenizer,
            system=rec.get("system"), cutoff_len=cut)
        if prefix:
            input_ids, labels = prepend_image_tokens(
                input_ids, labels, seqlens, bundle.cfg.image_token_id)
        ex = {"input_ids": input_ids, "labels": labels}
        if extras:
            ex["extras"] = extras
        encoded.append(ex)

    return pack_examples(encoded, cfg.cutoff_len, pad_id)


def _remat(mode: str):
    return {"true": True, "false": False}.get(mode, mode)


def add_device_argument(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default=None,
                        help="default: the CUDA card; 'cpu' runs the plain "
                        "PyTorch path")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True)
    add_device_argument(parser)
    parser.add_argument("--predict-scores", default=True,
                        action=argparse.BooleanOptionalAction,
                        help="with predict.do_predict: also write the "
                        "ROUGE/BLEU scores (needs jieba and nltk); "
                        "--no-predict-scores writes the predictions only")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    import torch

    from iadr1_tpu_torch.core.config import dataclass_from_dict, load_config
    from iadr1_tpu_torch.core.device import resolve_device
    from iadr1_tpu_torch.core.distributed import maybe_initialize_distributed
    from iadr1_tpu_torch.core.mesh import build_mesh, mesh_config
    from iadr1_tpu_torch.core.metrics import (
        H100_PEAK_BF16_FLOPS,
        ThroughputMeter,
        transformer_flops_per_token,
    )
    from iadr1_tpu_torch.data.cache import load_tokenized, save_tokenized
    from iadr1_tpu_torch.data.collator import VLMBatchBuilder, text_batch
    from iadr1_tpu_torch.data.template import get_template
    from iadr1_tpu_torch.models.registry import bundle_from_hf_config
    from iadr1_tpu_torch.train.checkpoint import CheckpointManager
    from iadr1_tpu_torch.train.loop import (
        LoopConfig,
        batch_iterator,
        run_sft_loop,
    )
    from iadr1_tpu_torch.train.optimizers import OptimizerConfig, make_optimizer
    from iadr1_tpu_torch.train.sft import make_chunked_sft_step
    from iadr1_tpu_torch.train.state import create_train_state

    # a multi-process launch: wire the ranks together before any device use
    maybe_initialize_distributed(args.device)
    cfg = load_config(SFTJobConfig, args.config, args.overrides)
    require_ported(cfg)
    device = resolve_device(args.device)
    mesh = build_mesh(mesh_config(cfg.mesh))
    loop_cfg = dataclass_from_dict(LoopConfig, cfg.train)
    opt_cfg = dataclass_from_dict(OptimizerConfig, cfg.optim)

    dtype = getattr(torch, cfg.model.dtype)
    if cfg.model.hf_config:
        hf_cfg_dict = cfg.model.hf_config
    else:
        with open(os.path.join(cfg.model.model_name_or_path,
                               "config.json")) as f:
            hf_cfg_dict = json.load(f)
    hf_cfg_dict, attention = context_extension(cfg.model, hf_cfg_dict)
    bundle = bundle_from_hf_config(hf_cfg_dict, attention=attention)
    if cfg.model.hf_config:
        params = shard_for_mesh(bundle, bundle.init_params(
            seed=cfg.model.seed, dtype=dtype, device=device), mesh)
    else:
        params = load_checkpoint(bundle, cfg.model.model_name_or_path, dtype,
                                 device, mesh)

    tokenizer = load_tokenizer(cfg.model.model_name_or_path)
    template = get_template(cfg.data.template)

    rows = None
    if cfg.data.tokenized_path:
        rows = load_tokenized(cfg.data.tokenized_path)
        if rows is not None:
            print(f"loaded {len(rows)} tokenized rows from "
                  f"{cfg.data.tokenized_path}")
    if rows is None:
        rows = prepare_rows(cfg.data, tokenizer, template, bundle,
                            stage=cfg.stage)
        if cfg.data.tokenized_path and save_tokenized(
                cfg.data.tokenized_path, rows):
            print(f"tokenized dataset saved to {cfg.data.tokenized_path}")
    print(f"packed {len(rows)} rows of length {cfg.data.cutoff_len}")

    if not opt_cfg.total_steps:
        opt_cfg = dataclasses.replace(opt_cfg, total_steps=loop_cfg.max_steps)
    optimizer, schedule = make_optimizer(opt_cfg)
    state = create_train_state(params, optimizer)
    del params
    remat_mode = _remat(cfg.model.remat)
    tower_kw = {}
    if cfg.model.tower_remat != "default":
        if "tower_remat" not in inspect.signature(bundle.apply).parameters:
            raise ValueError(
                f"model.tower_remat={cfg.model.tower_remat!r} set but the "
                f"{bundle.family} family has no vision-tower remat knob")
        tower_kw["tower_remat"] = _remat(cfg.model.tower_remat)

    # a MoE bundle adds the router's load-balancing loss
    aux_coef = (bundle.cfg.router_aux_loss_coef
                if bundle.family == "qwen2_moe" else 0.0)

    def hidden_fn(params, batch):
        if aux_coef:
            h, _, aux = bundle.apply(params, batch, remat=remat_mode,
                                     return_aux=True)
            return h, aux
        return bundle.hidden_fn(params, batch, remat=remat_mode, **tower_kw)

    # chunked CE: never materializes [B, T, V] logits
    step = make_chunked_sft_step(
        hidden_fn, bundle.head_kernel_fn, optimizer, schedule,
        chunk_size=cfg.data.ce_chunk, aux_loss_coef=aux_coef,
        logits_dtype=getattr(torch, cfg.data.ce_logits_dtype))

    ckpt = CheckpointManager(
        os.path.join(loop_cfg.output_dir, "checkpoints"),
        max_to_keep=loop_cfg.keep_checkpoints)
    start_step = 0
    if loop_cfg.resume:
        latest = ckpt.latest_step()
        if latest is not None:
            state = ckpt.restore(state)
            start_step = latest
            print(f"resumed from checkpoint step {latest}")

    if bundle.multimodal and any(r.get("extras") for r in rows):
        collate = VLMBatchBuilder(
            bundle=bundle, patch_budget=cfg.data.patch_budget,
            min_pixels=cfg.data.min_pixels, max_pixels=cfg.data.max_pixels)
    else:
        # text-only data through a VLM checkpoint (e.g. the pt stage):
        # the tower is skipped and M-RoPE broadcasts the 1-D positions
        collate = text_batch
    batches = batch_iterator(rows, loop_cfg.batch_size, loop_cfg.seed,
                             rank_collate(collate, mesh), skip=start_step)

    tcfg = getattr(bundle.cfg, "text", bundle.cfg)
    meter = ThroughputMeter(
        flops_per_token_fwd=transformer_flops_per_token(
            hidden=tcfg.hidden_size, intermediate=tcfg.intermediate_size,
            num_layers=tcfg.num_hidden_layers, vocab=tcfg.vocab_size,
            seq_len=cfg.data.cutoff_len,
            num_heads=tcfg.num_attention_heads,
            num_kv_heads=tcfg.num_key_value_heads),
        # MFU against the H100's peak; a CPU run reports 0 (not measured)
        peak_flops=H100_PEAK_BF16_FLOPS if device.type == "cuda"
        else math.inf)
    state, history = run_sft_loop(state, step, batches, loop_cfg, ckpt,
                                  meter, start_step=start_step)
    print(json.dumps({"final": history[-1] if history else {}}))
    if cfg.predict.do_predict:
        from iadr1_tpu_torch.core.distributed import is_primary
        from iadr1_tpu_torch.core.mesh import full, kernel_mesh_scope
        from iadr1_tpu_torch.train.state import named_leaves, unflatten

        params = state.params
        if mesh is not None:
            # every rank gathers the whole parameters; rank 0 generates
            # alone, off the mesh (the engine's collectives span the batch
            # ranks)
            params = unflatten({name: full(leaf)
                                for name, leaf in named_leaves(params)})
        if is_primary():
            predict = run_predict if args.predict_scores else predict_generate
            with kernel_mesh_scope(None):
                predict(bundle, params, tokenizer, template, cfg.data,
                        cfg.predict, loop_cfg.output_dir, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
