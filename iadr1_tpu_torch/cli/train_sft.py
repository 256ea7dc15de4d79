"""PA-SFT launcher pieces (counterpart of iadr1_tpu/cli/train_sft.py): the
job's config sections, which load every SFT file of ``configs/``.

``main`` and ``prepare_rows`` (dataset rows -> packed examples, the
training entry point, checkpoints) are not ported yet (ROADMAP A.4);
``require_ported`` names the item each option the port cannot run yet
waits for.
"""

from __future__ import annotations

import dataclasses


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
