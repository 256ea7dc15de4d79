"""tp > 1 for the families other than the two tp = 4 recipes' and for
LongLoRA's attention: one fast case each, the SFT CLI on the family's tiny
checkpoint at (dp, fsdp, tp) = (1, 1, 2) on two Gloo processes
(tests/torch_mesh_worker.py), its logged loss, accuracy, label count and
gradient norm within ``LOSS_RTOL`` (1e-5, the mesh tests' own) of the
one-process port run in f32:

* LLaVA-OneVision (the SigLIP tower, one head: replicated under the rule);
* LLaVA-1.5 (CLIP tiles);
* LLaVA-NeXT-Video and Video-LLaVA (their image path; the frames go
  through the same tower);
* InternVL;
* PaliGemma (one KV head: its k and v kernels split inside the head, the
  prefix-LM attention dense over DTensors);
* Pixtral (its packed patch stream, one attention call over every image);
* LongLoRA's shift-short attention over the Qwen2-VL decoder (the halves
  of the heads rolled apart).

The MoE's experts on tp are tests/test_torch_mesh_moe_pissa_chain.py's.
The eight mesh runs are one spawned 2-process job
(``torch_mesh_runs.MeshJobs``), started with the module and running beside
the one-process references; each case stays its own test.
"""

import functools

import pytest
import torch

from helpers import (
    build_iad_sft_dataset,
    build_tiny_vlm_checkpoint,
    tiny_qwen_tokenizer,
)
from iadr1_tpu_torch.models import registry
from torch_mesh_runs import (  # noqa: F401  (f32_port is a fixture)
    LOSS_RTOL,
    MeshJobs,
    _assert_logs_close,
    _log,
    _port_one_process,
    cli_job,
    f32_port,
)
import torch_threads  # noqa: F401  (one intra-op thread)

SFT_KEYS = ("loss", "accuracy", "n_label_tokens", "grad_norm")


def build_tiny_llava_video_checkpoint(dirpath: str, arch: str) -> str:
    """A tiny LLaVA-NeXT-Video or Video-LLaVA HF checkpoint with the tiny
    tokenizer (its ``<image>`` the image token; the video token an id the
    image data never holds): tests/test_torch_llava.py's CLIP tiles and
    decoder shapes."""
    from transformers import (
        LlavaNextVideoConfig,
        LlavaNextVideoForConditionalGeneration,
        VideoLlavaConfig,
        VideoLlavaForConditionalGeneration,
    )

    from test_torch_llava import PINPOINTS, TEXT, VISION

    tok = tiny_qwen_tokenizer()
    tok.save_pretrained(dirpath)
    torch.manual_seed(0)
    kw = dict(vision_config=dict(VISION),
              text_config=dict(TEXT, vocab_size=max(tok.vocab_size, 600),
                               num_attention_heads=8, num_key_value_heads=2),
              image_token_index=tok.convert_tokens_to_ids("<image>"),
              video_token_index=tok.convert_tokens_to_ids("<|vision_end|>"),
              vision_feature_layer=-2,
              vision_feature_select_strategy="default")
    if arch == "llava_next_video":
        model = LlavaNextVideoForConditionalGeneration(LlavaNextVideoConfig(
            **kw, image_grid_pinpoints=PINPOINTS, spatial_pool_mode="average",
            spatial_pool_stride=2))
    else:
        model = VideoLlavaForConditionalGeneration(VideoLlavaConfig(**kw))
    model.save_pretrained(dirpath)
    return dirpath


def _builder(module, name, *args):
    def build(path):
        mod = __import__(module)
        return getattr(mod, name)(path, *args)

    return build


# case -> (checkpoint builder, cutoff_len, patch budget, model overrides)
CASES = {
    "llava_onevision": (_builder("test_torch_llava_onevision",
                                 "build_tiny_llava_ov_checkpoint"),
                        384, 1024, {}),
    "llava": (_builder("test_torch_llava", "build_tiny_llava_checkpoint",
                       "llava"), 512, 1024, {}),
    "llava_next_video": (functools.partial(
        build_tiny_llava_video_checkpoint, arch="llava_next_video"),
        512, 1024, {}),
    "video_llava": (functools.partial(build_tiny_llava_video_checkpoint,
                                      arch="video_llava"), 512, 1024, {}),
    "internvl": (_builder("test_torch_internvl",
                          "build_tiny_internvl_checkpoint"), 256, 1024, {}),
    "paligemma": (_builder("test_torch_paligemma",
                           "build_tiny_paligemma_checkpoint"), 128, 64, {}),
    "pixtral": (_builder("test_torch_pixtral",
                         "build_tiny_pixtral_checkpoint"), 256, 1024, {}),
    "longlora": (build_tiny_vlm_checkpoint, 128, 64, {"shift_attn": True}),
}


TP2 = {"dp": 1, "fsdp": 1, "tp": 2}


def _cfg(case, ckpt, template, data, out_dir):
    _, cutoff, budget, model = CASES[case]
    return {"model": {"model_name_or_path": ckpt, **model},
            "data": {"dataset": data[0], "image_dir": data[1],
                     "template": template, "cutoff_len": cutoff,
                     "patch_budget": budget, "min_pixels": 56 * 56,
                     "max_pixels": 56 * 56 * 4},
            "optim": {"learning_rate": 1e-4, "warmup_ratio": 0.0,
                      "total_steps": 4},
            "train": {"output_dir": str(out_dir), "max_steps": 2,
                      "batch_size": 4, "logging_steps": 1,
                      "save_steps": 0}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's checkpoint, the dataset, and the mesh runs
    (``MeshJobs``), started at once: {"ckpt": {case: path}, "data": ...,
    "jobs": MeshJobs}."""
    root = tmp_path_factory.mktemp("families")
    data = build_iad_sft_dataset(root / "data")
    ckpts = {case: CASES[case][0](str(root / case)) for case in CASES}
    jobs = MeshJobs(root, [(2, [cli_job(
        case, "train_sft", TP2, _cfg(case, ckpts[case], registry
                                     .bundle_from_pretrained(ckpts[case])
                                     .template, data, root / f"{case}_out"),
        root) for case in CASES])])
    yield {"ckpt": ckpts, "data": data, "jobs": jobs, "root": root}
    jobs.close()


@pytest.mark.parametrize("case", list(CASES))
def test_family_sft_at_tp2_matches_one_process(case, runs, f32_port,
                                               tmp_path):
    cutoff = CASES[case][1]
    ckpt = runs["ckpt"][case]
    family = registry.bundle_from_pretrained(ckpt)
    one = _port_one_process("train_sft", _cfg(
        case, ckpt, family.template, runs["data"], tmp_path / "one"),
        tmp_path / "one.json")
    ranks = runs["jobs"].result(case)
    got = _log(runs["root"] / f"{case}_out")
    _assert_logs_close(got, one, SFT_KEYS, LOSS_RTOL)
    assert got[-1]["loss"] != got[0]["loss"]
    text = getattr(family.cfg, "text", family.cfg)
    H, Hkv = text.num_attention_heads, text.num_key_value_heads
    for r in ranks:
        assert r["mesh"] == {"dp": 1, "fsdp": 1, "tp": 2}
        # the decoder's calls: the 4 rows of the step, cutoff_len long
        decoder = [(q, k) for q, k, _ in r["flash_shapes"]
                   if q[0] == 4 and q[2] == cutoff]
        if case == "paligemma":
            # the prefix-LM attention is dense: no kernel call
            assert decoder == []
        elif case == "longlora":
            # each half of the heads rolled apart; its H / 2 and Hkv / 2
            # heads split where both divide by tp
            assert decoder == [] and any(q[1] == H // 2
                                         for q, _, _ in r["flash_shapes"])
        else:
            # the decoder's heads split: H / tp over Hkv / tp
            assert decoder and all(q[1] == H // 2 and k[1] == Hkv // 2
                                   for q, k in decoder), decoder
