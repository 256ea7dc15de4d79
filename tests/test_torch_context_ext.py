"""Context extension in the port: RoPE scaling and LongLoRA, against the
JAX package and transformers.

RoPE scaling: the inverse frequencies of the three types (linear, dynamic
NTK, llama3) against JAX's ``scaled_rope_inv_freq`` and transformers'
``ROPE_INIT_FUNCTIONS`` (rtol 1e-6), the cos/sin tables and a tiny Qwen2
decoder's logits against JAX's (f32, atol 1e-4).  ``configure_rope_scaling``
against JAX's on a text config (equal dicts), and ROADMAP C.R18 pinned on
both sides: JAX writes the scaling at the top level, where the LLaVA
families never read it and where it replaces Qwen2-VL's M-RoPE sections;
the port writes it into ``text_config`` and refuses an M-RoPE decoder.

LongLoRA: the shift-short attention against JAX's
``make_longlora_attention`` over the dense attention (f32, atol 1e-5,
gradients too), and over the flash twin against JAX's over the Pallas
kernel in interpret mode (atol 2e-5, as tests/test_torch_flash_attention.py);
the decoder's K1 calls under the remat modes; the SFT CLI with
``model.rope_scaling`` and ``model.shift_attn`` against the JAX CLI (rtol
1e-5).
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iadr1_tpu.cli.train_sft import main as jax_sft_main
from iadr1_tpu.core.precision import FULL_PRECISION as JAX_FULL
from iadr1_tpu.models import attention as jattn
from iadr1_tpu.models import common as jcommon
from iadr1_tpu.models import qwen2 as jq
from iadr1_tpu.models import registry as jax_registry
from iadr1_tpu_torch.cli.train_sft import main as sft_main
from iadr1_tpu_torch.core.precision import FULL_PRECISION
from iadr1_tpu_torch.models import attention as tattn
from iadr1_tpu_torch.models import common as tcommon
from iadr1_tpu_torch.models import qwen2 as tq
from iadr1_tpu_torch.models import registry
from iadr1_tpu_torch.models.params_io import params_from_jax
from tests.helpers import build_iad_sft_dataset, tiny_qwen_tokenizer
import torch_threads  # noqa: F401  (one intra-op thread)

TEXT = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            rms_norm_eps=1e-6, rope_theta=10000.0, tie_word_embeddings=False,
            max_position_embeddings=32, architectures=["Qwen2ForCausalLM"])
SCALINGS = {
    "linear": {"rope_type": "linear", "factor": 2.0},
    "dynamic": {"rope_type": "dynamic", "factor": 2.0},
    "llama3": {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0,
               "original_max_position_embeddings": 16},
}


@pytest.mark.parametrize("kind", list(SCALINGS))
def test_inv_freq_matches_jax_and_transformers(kind):
    from transformers import LlamaConfig
    from transformers.modeling_rope_utils import ROPE_INIT_FUNCTIONS

    hf = dict(TEXT, rope_scaling=SCALINGS[kind])
    scaling = registry._parse_rope_scaling(hf)
    jscaling = jax_registry._parse_rope_scaling(hf)
    assert scaling.__dict__ == jscaling.__dict__
    D = 16
    for seq_len in (20, 32, 80):            # dynamic grows past 32 only
        got = tcommon.scaled_rope_inv_freq(
            D, 1e4, scaling, "cpu", torch.tensor(seq_len)).numpy()
        want = np.asarray(jcommon.scaled_rope_inv_freq(
            D, 1e4, jscaling, jnp.asarray(seq_len)))
        np.testing.assert_allclose(got, want, rtol=1e-6)
        cfg = LlamaConfig(hidden_size=64, num_attention_heads=4,
                          rope_theta=1e4, max_position_embeddings=32,
                          rope_scaling=dict(SCALINGS[kind]))
        inv, _ = ROPE_INIT_FUNCTIONS[kind](cfg, "cpu", seq_len=seq_len)
        np.testing.assert_allclose(got, inv.numpy(), rtol=1e-6)
    pos = np.arange(70)[None].repeat(2, 0)
    got = tcommon.rope_cos_sin(torch.as_tensor(pos), D, 1e4, scaling)
    want = jcommon.rope_cos_sin(jnp.asarray(pos), D, 1e4, scaling=jscaling)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


@pytest.mark.parametrize("kind", list(SCALINGS))
def test_scaled_decoder_logits_match_jax(kind):
    hf = dict(TEXT, rope_scaling=SCALINGS[kind])
    jb = jax_registry.bundle_from_hf_config(hf, attention="xla",
                                            precision=JAX_FULL)
    tb = registry.bundle_from_hf_config(hf, precision=FULL_PRECISION)
    assert tb.cfg.rope_scaling.__dict__ == jb.cfg.rope_scaling.__dict__
    jparams = jb.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    ids = rng.integers(1, 512, (2, 48))
    pos = np.broadcast_to(np.arange(48), (2, 48))
    batch = {"input_ids": ids, "position_ids": pos}
    h, _ = jb.apply(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    want = np.asarray(jb.logits_fn(jparams, h))
    tparams = params_from_jax(jparams, device="cpu")
    with torch.no_grad():
        h, _ = tb.apply(tparams, {k: torch.as_tensor(v)
                                  for k, v in batch.items()})
        got = tb.logits_fn(tparams, h).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_configure_rope_scaling_equals_jax_on_a_text_config():
    for kind in SCALINGS:
        for length in (None, 16, 100):
            assert (registry.configure_rope_scaling(TEXT, kind, length)
                    == jax_registry.configure_rope_scaling(TEXT, kind,
                                                           length))


LLAVA = dict(
    architectures=["LlavaForConditionalGeneration"], model_type="llava",
    vision_config=dict(hidden_size=128, intermediate_size=96,
                       num_hidden_layers=3, num_attention_heads=2,
                       image_size=56, patch_size=14, hidden_act="quick_gelu",
                       layer_norm_eps=1e-5),
    text_config=dict(model_type="llama", vocab_size=600, hidden_size=64,
                     intermediate_size=96, num_hidden_layers=2,
                     num_attention_heads=4, num_key_value_heads=4,
                     rope_theta=10000.0, rms_norm_eps=1e-5,
                     max_position_embeddings=1024),
    image_token_index=6, vision_feature_layer=-2,
    vision_feature_select_strategy="default")
QWEN2_VL = dict(
    architectures=["Qwen2VLForConditionalGeneration"], model_type="qwen2_vl",
    text_config=dict(TEXT, max_position_embeddings=1024,
                     rope_scaling={"type": "mrope",
                                   "mrope_section": [2, 3, 3]}),
    vision_config=dict(depth=2, embed_dim=64, hidden_size=64, num_heads=4,
                       patch_size=14, spatial_merge_size=2,
                       temporal_patch_size=2),
    image_token_id=7, video_token_id=8, vision_start_token_id=5)


def test_jax_rope_scaling_misses_vlm_decoders():
    """C.R18, the JAX side: the scaling lands at the top level; the LLaVA
    decoder (read from text_config) keeps no scaling, and a Qwen2-VL
    config whose M-RoPE sections sit at the top level loses them."""
    out = jax_registry.configure_rope_scaling(LLAVA, "linear", 2048)
    # keyed to the top level's maximum too (absent: 32768), not the
    # decoder's 1024
    assert out["rope_scaling"] == {"rope_type": "linear", "factor": 1.0}
    jb = jax_registry.bundle_from_hf_config(out, attention="xla")
    assert jb.cfg.text.rope_scaling is None
    top = {**QWEN2_VL["text_config"], **QWEN2_VL}
    del top["text_config"]
    cfg = jax_registry._qwen2_text_cfg(
        jax_registry.configure_rope_scaling(top, "linear", 8192))
    assert cfg.mrope_section is None
    assert cfg.rope_scaling == jq.RopeScaling(
        type="linear", factor=8.0, original_max_position_embeddings=8192)


def test_port_rope_scaling_reaches_vlm_decoders_and_refuses_mrope():
    """C.R18, the port's side."""
    out = registry.configure_rope_scaling(LLAVA, "linear", 2048)
    assert "rope_scaling" not in out and "rope_scaling" not in LLAVA[
        "text_config"]
    assert out["text_config"]["max_position_embeddings"] == 2048
    tb = registry.bundle_from_hf_config(out)
    assert tb.cfg.text.rope_scaling == tq.RopeScaling(
        type="linear", factor=2.0, original_max_position_embeddings=2048)
    assert tb.cfg.text.max_position_embeddings == 2048
    top = {**QWEN2_VL["text_config"], **QWEN2_VL}
    del top["text_config"]
    for hf in (QWEN2_VL, top):
        with pytest.raises(ValueError, match="C.R18"):
            registry.configure_rope_scaling(hf, "linear", 8192)


def _qkv(B, T, H, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    r = rng.standard_normal((B, T, H, D)).astype(np.float32)
    segs = np.ones((B, T), np.int32)
    segs[0, T // 3:] = 2                     # packed: a second segment
    segs[1, 5 * T // 8:] = 2
    return q, k, v, r, segs


def _both(jinner, tinner, B, T, H, Hkv, D, seed):
    """(out, dq, dk, dv) of LongLoRA over the two inner attentions, with
    the loss sum(out * r)."""
    q, k, v, r, segs = _qkv(B, T, H, Hkv, D, seed)
    jfn = jattn.make_longlora_attention(jinner)

    def jloss(q, k, v):
        out = jfn(q, k, v, q_segments=jnp.asarray(segs),
                  kv_segments=jnp.asarray(segs), causal=True)
        return jnp.sum(out * r), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tfn = tattn.make_longlora_attention(tinner)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    tout = tfn(*leaves, q_segments=torch.as_tensor(segs),
               kv_segments=torch.as_tensor(segs), causal=True)
    tgrads = torch.autograd.grad((tout * torch.as_tensor(r)).sum(), leaves)
    return ([np.asarray(jout)] + [np.asarray(g) for g in jgrads],
            [tout.detach().numpy()] + [g.numpy() for g in tgrads])


def test_longlora_matches_jax_over_the_dense_attention():
    want, got = _both(jattn.xla_attn, tattn.xla_attn, 2, 64, 4, 2, 16, 0)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=name)


def test_longlora_flash_twin_matches_the_pallas_path():
    """Each head half one K1 call on the [B*T/g, g, H/2, D] views (the
    twin here), against JAX over the Pallas kernel in interpret mode:
    GQA 2, g = 128, the rolled half's segments wrapped."""
    jflash = functools.partial(jattn.flash_attn, interpret=True)
    want, got = _both(jflash, tattn.flash_attn, 2, 512, 4, 2, 64, 1)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=2e-5, err_msg=name)


def test_longlora_refuses_odd_groups_and_heads():
    fn = tattn.default_attention("longlora_xla")
    x = torch.zeros((1, 9, 4, 8))
    with pytest.raises(ValueError, match="LongLoRA needs"):
        fn(x, x, x, causal=True)                  # 9 % 2 != 0
    with pytest.raises(ValueError, match="LongLoRA needs"):
        fn(torch.zeros((1, 8, 3, 8)), x[:, :8, :3], x[:, :8, :3])


@pytest.mark.parametrize("remat,calls", [(True, 2), ("save_qkv", 2),
                                         ("full", 4)])
def test_longlora_decoder_trains_and_keeps_k1_out_of_checkpoints(
        monkeypatch, remat, calls):
    """The decoder with attention="longlora": logits equal JAX's
    "longlora_xla" (atol 1e-4); under remat True and "save_qkv" each
    layer makes its two K1 calls once (outside every checkpoint), under
    "full" the backward replays them; a cached prefill raises."""
    jb = jax_registry.bundle_from_hf_config(TEXT, attention="longlora_xla",
                                            precision=JAX_FULL)
    tb = registry.bundle_from_hf_config(TEXT, attention="longlora",
                                        precision=FULL_PRECISION)
    jparams = jb.init_params(jax.random.PRNGKey(0))
    ids, _, _, _, segs = _qkv(2, 64, 1, 1, 1, 2)
    ids = np.random.default_rng(2).integers(1, 512, (2, 64))
    pos = np.concatenate([np.arange(64)[None]] * 2)
    batch = {"input_ids": ids, "position_ids": pos, "segment_ids": segs}
    h, _ = jb.apply(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    want = np.asarray(jb.logits_fn(jparams, h))
    tparams = params_from_jax(jparams, device="cpu")
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    n = {"calls": 0}
    inner = tattn.flash_attention

    def counted(*a, **kw):
        n["calls"] += 1
        return inner(*a, **kw)

    monkeypatch.setattr(tattn, "flash_attention", counted)
    leaves = [p.requires_grad_(True)
              for p in jax.tree_util.tree_leaves(tparams)]
    h = tb.hidden_fn(tparams, tbatch, remat=remat)
    got = tb.logits_fn(tparams, h)
    live = segs.astype(bool)
    np.testing.assert_allclose(got.detach().numpy()[live], want[live],
                               atol=1e-4, rtol=0)
    torch.autograd.grad(got.sum(), leaves)
    assert n["calls"] == calls * TEXT["num_hidden_layers"]
    cache = tq.init_cache(tb.cfg, 2, 64, torch.float32, "cpu")
    with pytest.raises(ValueError, match="training only"):
        tb.apply(tparams, tbatch, cache=cache, cache_mode="prefill")


def test_vision_towers_take_no_longlora():
    """JAX runs the LLaVA, OneVision, InternVL, PaliGemma and Pixtral
    towers apart from the decoder's attention: LongLoRA stays out."""
    assert tattn.tower_attention("longlora") is tattn.flash_attn
    assert tattn.tower_attention("longlora_xla") is tattn.xla_attn
    assert tattn.tower_attention("flash") is tattn.flash_attn


def _tiny_text_checkpoint(path: str) -> str:
    from transformers import Qwen2Config, Qwen2ForCausalLM

    tok = tiny_qwen_tokenizer()
    tok.save_pretrained(path)
    torch.manual_seed(0)
    Qwen2ForCausalLM(Qwen2Config(**{k: v for k, v in TEXT.items()
                                    if k != "architectures"})
                     ).save_pretrained(path)
    return path


@pytest.fixture
def f32_compute(monkeypatch):
    monkeypatch.setattr(jax_registry, "bundle_from_hf_config",
                        functools.partial(jax_registry.bundle_from_hf_config,
                                          precision=JAX_FULL))
    monkeypatch.setattr(registry, "bundle_from_hf_config", functools.partial(
        registry.bundle_from_hf_config, precision=FULL_PRECISION))


def test_sft_cli_context_extension_matches_the_jax_cli(tmp_path, f32_compute):
    """``model.rope_scaling: linear`` with ``model_max_length`` 64 over 32
    positions (factor 2) and ``model.shift_attn`` (groups of 16 in rows
    of 64): steps 1-3 of both CLIs, loss, accuracy, grad norm and learning
    rate within rtol 1e-5."""
    path = _tiny_text_checkpoint(str(tmp_path / "ckpt"))
    data_path, img_dir = build_iad_sft_dataset(tmp_path)
    logs = {}
    for side, main, device in (("port", sft_main, "cpu"),
                               ("jax", jax_sft_main, None)):
        out = str(tmp_path / side)
        cfg = {
            "model": {"model_name_or_path": path, "rope_scaling": "linear",
                      "model_max_length": 64, "shift_attn": True,
                      "attention": "auto" if side == "port" else "xla"},
            "data": {"dataset": data_path, "image_dir": img_dir,
                     "template": "qwen2_vl", "cutoff_len": 64},
            "optim": {"learning_rate": 1e-3, "warmup_ratio": 0.0,
                      "total_steps": 3},
            "train": {"output_dir": out, "max_steps": 3, "batch_size": 2,
                      "logging_steps": 1, "save_steps": 0},
        }
        if side == "jax":
            cfg["mesh"] = {"dp": 1, "fsdp": 4, "tp": 2}
        cfg_path = tmp_path / f"{side}.json"
        cfg_path.write_text(json.dumps(cfg))
        argv = ["--config", str(cfg_path)] + (
            ["--device", device] if device else [])
        assert main(argv) == 0
        with open(os.path.join(out, "trainer_log.jsonl")) as f:
            logs[side] = [json.loads(line) for line in f]
    assert len(logs["port"]) == len(logs["jax"]) == 3
    for got, want in zip(logs["port"], logs["jax"]):
        for key in ("loss", "accuracy", "grad_norm", "learning_rate"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       atol=1e-7, err_msg=key)
