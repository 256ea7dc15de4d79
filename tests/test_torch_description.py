"""The description reward's embedding backends in the port against the JAX
package's: the bundle backend's mean-pooled, L2-normalised hidden states
(f32, within 1e-5, a partial last chunk and an empty text), the HF
AutoModel backend on a locally built tiny BERT, and ``description_score``
through a registered backend."""

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, set up by conftest)

from helpers import tiny_qwen_tokenizer
from iadr1_tpu.core.precision import FULL_PRECISION as JAX_FULL
from iadr1_tpu.models import registry as jax_registry
from iadr1_tpu.rewards import description as jdesc
from iadr1_tpu_torch.core.precision import FULL_PRECISION
from iadr1_tpu_torch.models import registry
from iadr1_tpu_torch.models.params_io import params_from_jax
from iadr1_tpu_torch.rewards import description as tdesc
import torch_threads  # noqa: F401  (one intra-op thread)

TINY = dict(vocab_size=600, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, rope_theta=10000.0,
            tie_word_embeddings=True, architectures=["Qwen2ForCausalLM"])

TEXTS = ["a deep scratch", "a deep scratch", "", "totally different",
         "dent at the bottom left of the image", "The quick brown fox "
         "jumps over the lazy dog 0123456789 " * 3, "hole", "x"]


@pytest.fixture(autouse=True)
def _restore_backends():
    yield
    tdesc.register_embedding_backend(None)
    jdesc.register_embedding_backend(None)


@pytest.fixture(scope="module")
def backends():
    tok = tiny_qwen_tokenizer()
    jb = jax_registry.make_qwen2_bundle(TINY, attention="xla",
                                        precision=JAX_FULL)
    jparams = jb.init_params(jax.random.PRNGKey(0))
    tb = registry.make_qwen2_bundle(TINY, precision=FULL_PRECISION)
    tparams = params_from_jax(jparams, device="cpu")
    kw = dict(max_len=16, batch_size=3)
    return (tdesc.make_bundle_embedding_backend(tb, tparams, tok,
                                                device="cpu", **kw),
            jdesc.make_bundle_embedding_backend(jb, jparams, tok, **kw))


@pytest.mark.parametrize("n", [len(TEXTS), 4, 1])
def test_bundle_backend_matches_jax(backends, n):
    """8 texts in chunks of 3 (a partial last chunk whose padding rows
    hold no valid key), 4 and 1; the empty text becomes [pad]."""
    port, ref = backends
    got, want = np.asarray(port(TEXTS[:n])), np.asarray(ref(TEXTS[:n]))
    assert got.shape == want.shape == (n, TINY["hidden_size"])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    if n > 1:
        np.testing.assert_array_equal(got[0], got[1])  # repeated text


def test_transformer_backend_matches_jax(tmp_path):
    """The HF AutoModel path on a tiny BERT written by save_pretrained,
    as tests/test_description_reward.py builds it."""
    import torch
    from transformers import BertConfig, BertModel

    tok = tiny_qwen_tokenizer()
    torch.manual_seed(0)
    cfg = BertConfig(vocab_size=len(tok) + 8, hidden_size=32,
                     num_hidden_layers=2, num_attention_heads=2,
                     intermediate_size=64, max_position_embeddings=512)
    BertModel(cfg).save_pretrained(str(tmp_path))
    tok.save_pretrained(str(tmp_path))
    texts = ["scratch on the surface", "scratch on the surface",
             "a dent", "The quick brown fox jumps over the lazy dog"]
    got = np.asarray(tdesc.make_transformer_embedding_backend(
        str(tmp_path), device="cpu")(texts))
    want = np.asarray(jdesc.make_transformer_embedding_backend(
        str(tmp_path))(texts))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(got[0], got[1])


@pytest.mark.parametrize("pair", [
    ("a deep scratch", "a deep scratch"), ("a deep scratch", "hole"),
    ("dent at the bottom", "totally different"), ("", "hole")])
def test_description_score_uses_the_registered_backend(backends, pair):
    port, ref = backends
    bow = tdesc.description_score(*pair)
    tdesc.register_embedding_backend(port)
    jdesc.register_embedding_backend(ref)
    got, want = tdesc.description_score(*pair), jdesc.description_score(*pair)
    assert got == pytest.approx(want, abs=1e-5)
    assert 0.0 <= got <= 1.0
    if pair[0] == pair[1]:
        assert got == pytest.approx(1.0, abs=1e-5)
    elif pair[0]:
        assert got != bow                       # not the bag-of-words path
