"""PA-SFT launcher (counterpart of iadr1_tpu/cli/train_sft.py): a yaml or
json config plus dotted overrides; runs on the card unless given
``--device cpu``.

Usage:
    python -m iadr1_tpu_torch.cli.train_sft --config sft.yaml \
        train.max_steps=20 optim.learning_rate=1e-4 [--device cpu]

``require_ported`` names the ROADMAP item each option the port cannot run
yet waits for: a mesh of more than one device (A.11), rope scaling and
LongLoRA (A.13), ``do_predict`` (A.15); the PaliGemma branch of
``prepare_rows`` raises naming A.13.
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
    """Raise for an option the port cannot run yet, naming its item."""
    if mesh_devices(dataclasses.asdict(job.mesh)) > 1:
        raise NotImplementedError(
            f"a mesh of more than one device ({job.mesh}) is not ported yet "
            "(ROADMAP A.11)")
    if job.model.rope_scaling or job.model.shift_attn:
        raise NotImplementedError(
            "rope scaling and LongLoRA are not ported yet (ROADMAP A.13)")
    if job.predict.do_predict:
        raise NotImplementedError(
            "do_predict is not ported yet (ROADMAP A.15)")


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
    from iadr1_tpu_torch.data.mm import expand_image_tokens
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
            if template.mm_style == "paligemma":
                raise NotImplementedError(
                    "PaliGemma's prepended image tokens are not ported yet "
                    "(ROADMAP A.13)")
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
        input_ids, labels = encode_supervised_example(
            messages, template, tokenizer,
            system=rec.get("system"), cutoff_len=cfg.cutoff_len - 1)
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
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    import torch

    from iadr1_tpu_torch.core.config import dataclass_from_dict, load_config
    from iadr1_tpu_torch.core.device import resolve_device
    from iadr1_tpu_torch.core.metrics import (
        H100_PEAK_BF16_FLOPS,
        ThroughputMeter,
        transformer_flops_per_token,
    )
    from iadr1_tpu_torch.data.cache import load_tokenized, save_tokenized
    from iadr1_tpu_torch.data.collator import VLMBatchBuilder, text_batch
    from iadr1_tpu_torch.data.template import get_template
    from iadr1_tpu_torch.models.params_io import load_safetensors_path
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

    cfg = load_config(SFTJobConfig, args.config, args.overrides)
    require_ported(cfg)
    device = resolve_device(args.device)
    loop_cfg = dataclass_from_dict(LoopConfig, cfg.train)
    opt_cfg = dataclass_from_dict(OptimizerConfig, cfg.optim)

    dtype = getattr(torch, cfg.model.dtype)
    if cfg.model.hf_config:
        hf_cfg_dict = cfg.model.hf_config
    else:
        with open(os.path.join(cfg.model.model_name_or_path,
                               "config.json")) as f:
            hf_cfg_dict = json.load(f)
    bundle = bundle_from_hf_config(hf_cfg_dict, attention=cfg.model.attention)
    if cfg.model.hf_config:
        params = bundle.init_params(seed=cfg.model.seed, dtype=dtype,
                                    device=device)
    else:
        params = bundle.convert_hf(
            load_safetensors_path(cfg.model.model_name_or_path), dtype=dtype,
            device=device)

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

    def hidden_fn(params, batch):
        return bundle.hidden_fn(params, batch, remat=remat_mode, **tower_kw)

    # chunked CE: never materializes [B, T, V] logits
    step = make_chunked_sft_step(
        hidden_fn, bundle.head_kernel_fn, optimizer, schedule,
        chunk_size=cfg.data.ce_chunk,
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
                             collate, skip=start_step)

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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
