"""The port's optimizers (train/custom_optim.py, through
``make_optimizer``) against the JAX package's, on the CPU.

Each optimizer takes two updates of the same parameter tree with the same
gradients on both sides: the parameters after each within atol 1e-5 (the
learning rate is 1e-2, so that the updates are large against it), and
each update within 1e-3 of the largest JAX update.  The trees are a tiny
Qwen2-VL's (paths as the models name them) and a text Qwen2's, plus a
[2, 128, 256] kernel where Adafactor must factor, each cut to the leaves
that meet every rule the optimizers choose by (JAX compiles each update
over the whole tree: the cut keeps the file cheap).  APOLLO's projections
and BAdam's random block order are JAX's, injected (torch cannot draw
JAX's numbers); BAdam's choice of blocks on a tree whose tower is deeper
than its decoder is pinned on both sides (ROADMAP C.R25).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from iadr1_tpu.models.registry import bundle_from_hf_config as jax_bundle
from iadr1_tpu.train import custom_optim as jco
from iadr1_tpu.train import optimizers as jopt
from iadr1_tpu_torch.models.params_io import params_from_jax
from iadr1_tpu_torch.train import custom_optim as tco
from iadr1_tpu_torch.train import optimizers as topt
from iadr1_tpu_torch.train.adapters import MaskedOptimizer
from iadr1_tpu_torch.train.state import (
    create_train_state,
    leaf_paths,
    named_leaves,
    tree_leaves,
)
from test_torch_grpo import QWEN2, VLM
import torch_threads  # noqa: F401  (one intra-op thread)

# Adam's eps 1e-4, as in tests/test_torch_grpo.py: Adam's first step is
# the sign of each (projected) gradient entry, and with eps 1e-8 an entry
# within f32 noise of 0 (GaLore's SVDs agree to about 1e-4 between JAX and
# torch) takes the full step in either direction
OPT = dict(learning_rate=1e-2, schedule="constant", warmup_steps=0,
           total_steps=10, max_grad_norm=1.0, eps=1e-4)


# the leaves the parity tests keep: an embedding, stacked decoder kernels
# of both projection sides (q's heads for Adam-mini), a 2-D bias and a
# 1-D norm, the tower's patch_embed and fused qkv, a 2-D merger kernel
VLM_LEAVES = ("text/embed/weight", "text/final_norm",
              "text/layers/attn/q/kernel", "text/layers/attn/q/bias",
              "text/layers/attn/k/kernel", "text/layers/mlp/down/kernel",
              "vision/patch_embed/kernel", "vision/blocks/attn/qkv/kernel",
              "vision/blocks/norm1/scale", "vision/merger/fc1/kernel")
TEXT_LEAVES = ("embed/weight", "final_norm", "layers/attn/q/kernel",
               "layers/attn/q/bias", "layers/mlp/down/kernel",
               "layers/input_norm", "extra/kernel")


def _tree(hf, seed=0, extra=False, keep=None):
    params = jax_bundle(hf, attention="xla").init_params(
        jax.random.PRNGKey(seed))
    params = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    if extra:       # a kernel Adafactor factors (two dims >= 128)
        rng = np.random.default_rng(seed)
        params["extra"] = {"kernel": (rng.standard_normal((2, 128, 256))
                                      * 0.02).astype(np.float32)}
    if keep is None:
        return params
    tree: dict = {}
    for path, leaf in _flat(params).items():
        if path in keep:
            *parents, last = path.split("/")
            node = tree
            for key in parents:
                node = node.setdefault(key, {})
            node[last] = leaf
    return tree


def _grads(params, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (rng.standard_normal(x.shape) * scale * 1e-2).astype(
            np.float32), params)


def _port_grads(port_params, jgrads):
    """The JAX gradients in the port's leaf order."""
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_leaves_with_path(jgrads)}
    return [torch.as_tensor(flat[p]) for p in leaf_paths(port_params)]


def run_jax(opt, params, grads_list):
    """Parameters after each update (numpy trees)."""
    state = opt.init(params)
    update = jax.jit(opt.update)
    out = []
    for grads in grads_list:
        updates, state = update(grads, state, params)
        params = optax.apply_updates(params, updates)
        out.append(jax.tree.map(np.asarray, params))
    return out


def run_port(opt, params, grads_list):
    """Parameters after each update ({path: numpy}) through
    create_train_state and TrainState.apply_gradients."""
    state = create_train_state(params_from_jax(params, device="cpu"), opt)
    out = []
    for grads in grads_list:
        g = _port_grads(state.params, grads)
        with torch.no_grad():
            state = state.apply_gradients(g, opt)
        out.append({p: t.detach().numpy().copy() for p, t in zip(
            leaf_paths(state.params), tree_leaves(state.params))})
    return out, state


def assert_same_updates(port_steps, jax_steps, start, msg=""):
    prev_p = {p: np.asarray(v) for p, v in _flat(start).items()}
    prev_j = dict(prev_p)
    for k, (got, want) in enumerate(zip(port_steps, jax_steps)):
        want = _flat(want)
        assert got.keys() == want.keys()
        scale = max(np.abs(want[p] - prev_j[p]).max() for p in want)
        assert scale > 0, msg
        for p in want:
            np.testing.assert_allclose(got[p], want[p], atol=1e-5, rtol=0,
                                       err_msg=f"{msg} update {k} {p}")
            np.testing.assert_allclose(
                got[p] - prev_p[p], want[p] - prev_j[p], rtol=0,
                atol=1e-3 * scale, err_msg=f"{msg} update {k} {p} (delta)")
        prev_p, prev_j = got, want


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def compare(name, params, grads_list, port_hook=None, **cfg):
    jo, _ = jopt.make_optimizer(jopt.OptimizerConfig(**OPT, **cfg))
    to, _ = topt.make_optimizer(topt.OptimizerConfig(**OPT, **cfg))
    if port_hook is not None:
        port_hook(to)
    jax_steps = run_jax(jo, params, grads_list)
    port_steps, state = run_port(to, params, grads_list)
    assert_same_updates(port_steps, jax_steps, params, msg=name)
    return to, state


@pytest.fixture(scope="module")
def whole_vlm_tree():
    return _tree(VLM)


@pytest.fixture(scope="module")
def vlm_tree():
    return _tree(VLM, keep=VLM_LEAVES)


@pytest.fixture(scope="module")
def text_tree():
    return _tree(QWEN2, extra=True, keep=TEXT_LEAVES)


# ---------------------------------------------------------------------------
# each optimizer against JAX
# ---------------------------------------------------------------------------


def _jax_canonical_svd_proj(g, rank, side):
    """JAX's _svd_proj with the port's signs (each singular vector's entry
    of largest magnitude positive); traced, inside JAX's lax.cond."""
    proj = jco._orig_svd_proj(g, rank, side)
    axis = -1 if side == "right" else -2
    idx = jnp.expand_dims(jnp.abs(proj).argmax(axis=axis), axis)
    peak = jnp.take_along_axis(proj, idx, axis=axis)
    return proj * jnp.where(peak < 0, -1.0, 1.0)


@pytest.fixture
def jax_signs_as_the_port(monkeypatch):
    jco._orig_svd_proj = getattr(jco, "_orig_svd_proj", jco._svd_proj)
    monkeypatch.setattr(jco, "_svd_proj", _jax_canonical_svd_proj)


@pytest.mark.parametrize("gap", [1, 2], ids=["refresh", "one_window"])
def test_galore_matches_jax(vlm_tree, gap, jax_signs_as_the_port):
    """gap 1: the second update refreshes the projection and carries the
    moments into it; gap 2: both updates in one window.  JAX's SVD is
    called with the port's sign convention (C.R26: across a refresh the
    update depends on it; within a window it does not)."""
    grads = [_grads(vlm_tree, 1), _grads(vlm_tree, 2)]
    opt, state = compare("galore", vlm_tree, grads, optimizer="galore",
                         galore_update_interval=gap, weight_decay=0.01)
    proj = dict(zip(leaf_paths(state.params), state.opt_state["proj"]))
    assert proj["vision/blocks/attn/qkv/kernel"].shape == (2, 32, 16)
    assert proj["text/layers/attn/q/kernel"].shape == (2, 16, 64)
    assert proj["text/embed/weight"] is None      # not a kernel: Adam


def test_galore_after_a_refresh_depends_on_the_svd_signs_c_r26(vlm_tree):
    """ROADMAP C.R26 on JAX's side alone: its own SVD signs (LAPACK's) and
    the port's convention give the same first update and different
    updates after a refresh, as the moments carry over into a projection
    whose vectors flipped."""
    grads = [_grads(vlm_tree, 1), _grads(vlm_tree, 2)]
    cfg = jopt.OptimizerConfig(**OPT, optimizer="galore",
                               galore_update_interval=1)
    own = run_jax(jopt.make_optimizer(cfg)[0], vlm_tree, grads)
    original = jco._svd_proj
    jco._orig_svd_proj = getattr(jco, "_orig_svd_proj", original)
    try:
        jco._svd_proj = _jax_canonical_svd_proj
        canonical = run_jax(jopt.make_optimizer(cfg)[0], vlm_tree, grads)
    finally:
        jco._svd_proj = original
    key = "text/layers/mlp/down/kernel"
    np.testing.assert_allclose(_flat(own[0])[key], _flat(canonical[0])[key],
                               atol=1e-6)
    assert np.abs(_flat(own[1])[key] - _flat(canonical[1])[key]).max() > 1e-4


@functools.lru_cache(maxsize=None)
def _jax_projection(seed, index, epoch, shape, rank):
    key = jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(seed), index), epoch)
    return np.array(jco._rand_proj(key, shape, rank))


def _jax_apollo_projection(seed=0):
    """The projections JAX's scale_by_apollo draws (``_rand_proj`` of its
    folded key)."""
    def projection(path, index, epoch, shape, rank, device):
        return torch.as_tensor(_jax_projection(seed, index, epoch,
                                               tuple(shape), rank))
    return projection


@pytest.mark.parametrize("gap", [1, 200])
@pytest.mark.parametrize("scale_type", ["channel", "tensor"])
def test_apollo_matches_jax_given_its_projections(vlm_tree, scale_type, gap):
    grads = [_grads(vlm_tree, 3), _grads(vlm_tree, 4, scale=0.5)]
    seen = []
    jax_proj = _jax_apollo_projection()

    def record(*args):
        seen.append(args[:3])
        return jax_proj(*args)

    def hook(opt):
        opt.projection = record

    compare("apollo", vlm_tree, grads, port_hook=hook, optimizer="apollo",
            apollo_scale_type=scale_type, apollo_update_interval=gap)
    # the leaf index counts the target kernels in JAX's sorted-path order
    targets = sorted({path for path, _, _ in seen})
    assert {(p, i) for p, i, _ in seen} == {(p, targets.index(p))
                                            for p in targets}
    assert {e for _, _, e in seen} == ({0, 1} if gap == 1 else {0})


def test_apollo_draws_its_own_projection_from_a_seeded_generator(vlm_tree):
    proj = tco.gaussian_projection(0)
    a = proj("p", 3, 1, (2, 16, 64), 16, "cpu")
    assert torch.equal(a, proj("p", 3, 1, (2, 16, 64), 16, "cpu"))
    assert not torch.equal(a, proj("p", 3, 2, (2, 16, 64), 16, "cpu"))
    assert abs(float(a.var()) - 1 / 16) < 0.01


def _jax_permutation(seed=0):
    def permutation(cycle, n_blocks):
        return np.asarray(jax.random.permutation(jax.random.fold_in(
            jax.random.PRNGKey(seed), cycle), n_blocks)).tolist()
    return permutation


@pytest.mark.parametrize("mode", ["ascending", "descending", "random"])
def test_badam_matches_jax_on_a_decoder(text_tree, mode):
    """A text model (no tower): both packages take the decoder's 2 layers
    and one extra block; switching every step, the two updates touch two
    different blocks."""
    grads = [_grads(text_tree, 5), _grads(text_tree, 6)]

    def hook(opt):
        opt.permutation = _jax_permutation()

    compare("badam", text_tree, grads, port_hook=hook, optimizer="badam",
            badam_switch_interval=1, badam_switch_mode=mode)


def _changed(before, after):
    """{path: rows changed} (rows of a stacked leaf; True for others)."""
    out = {}
    for p in after:
        d = np.abs(after[p] - before[p])
        if d.max() == 0:
            continue
        out[p] = tuple(np.nonzero(d.reshape(d.shape[0], -1).max(1))[0])
    return out


def test_badam_blocks_are_the_decoder_layers_c_r25():
    """ROADMAP C.R25 on a Qwen2-VL tree with 3 tower blocks and 2 decoder
    layers, switching every step.  JAX takes L = 3 from the tower: steps
    0-2 update one tower block each, step 3 the whole decoder with the
    embedding and merger.  The port takes L = 2, the decoder: steps 0-1
    one decoder layer each, step 2 every other leaf, the tower included,
    then layer 0 again."""
    deep = dict(VLM, vision_config=dict(VLM["vision_config"], depth=3))
    params = _tree(deep, keep=("text/embed/weight",
                               "text/layers/attn/q/kernel",
                               "vision/blocks/attn/qkv/kernel",
                               "vision/merger/fc1/kernel"))
    grads = [_grads(params, 10 + k) for k in range(4)]
    cfg = dict(OPT, optimizer="badam", badam_switch_interval=1)
    jax_steps = run_jax(jopt.make_optimizer(jopt.OptimizerConfig(**cfg))[0],
                        params, grads)
    port_steps, _ = run_port(
        topt.make_optimizer(topt.OptimizerConfig(**cfg))[0], params, grads)
    start = _flat(params)
    jax_changed = [_changed(a, b) for a, b in zip(
        [start] + [_flat(s) for s in jax_steps], [_flat(s) for s in
                                                   jax_steps])]
    port_changed = [_changed(a, b) for a, b in zip([start] + port_steps,
                                                   port_steps)]
    tower = "vision/blocks/attn/qkv/kernel"
    decoder = "text/layers/attn/q/kernel"
    for k in range(3):
        assert jax_changed[k][tower] == (k,)
        assert decoder not in jax_changed[k]
        assert "text/embed/weight" not in jax_changed[k]
    assert jax_changed[3][decoder] == (0, 1)
    assert "text/embed/weight" in jax_changed[3]
    assert tower not in jax_changed[3]
    for k, layer in ((0, 0), (1, 1), (3, 0)):
        assert port_changed[k][decoder] == (layer,)
        assert tower not in port_changed[k]
        assert "text/embed/weight" not in port_changed[k]
    assert port_changed[2][tower] == (0, 1, 2)
    assert "text/embed/weight" in port_changed[2]
    assert decoder not in port_changed[2]


@pytest.mark.parametrize("head_dim", [0, 16])
def test_adam_mini_matches_jax(vlm_tree, head_dim):
    grads = [_grads(vlm_tree, 7), _grads(vlm_tree, 8)]
    compare("adam_mini", vlm_tree, grads, optimizer="adam_mini",
            adam_mini_head_dim=head_dim, weight_decay=0.01)


def test_adam_mini_partition_on_a_qwen2_vl_tree(whole_vlm_tree):
    """The second moments' shapes are JAX's leaf by leaf; the substring
    rules also catch the tower's patch_embed (a value per row) and its
    fused attn/qkv (a value per head)."""
    jo = jco.scale_by_adam_mini(head_dim=16)
    want = _flat(jo.init(whole_vlm_tree).v)
    to = tco.AdamMini(lambda c: 1e-2, head_dim=16)
    params = params_from_jax(whole_vlm_tree, device="cpu")
    state = to.init(tree_leaves(params), leaf_paths(params))
    got = dict(zip(leaf_paths(params), state["v"]))
    assert got.keys() == want.keys()
    for p in want:
        assert tuple(got[p].shape) == want[p].shape, p
    kinds = {p: to.block_of(p, t.shape) for p, t in named_leaves(
        params, sep="/")}
    assert kinds["vision/patch_embed/kernel"] == "row"
    assert kinds["text/embed/weight"] == "row"
    assert kinds["vision/blocks/attn/qkv/kernel"] == "head"
    assert kinds["text/layers/attn/q/kernel"] == "head"
    assert kinds["text/layers/attn/v/kernel"] == "neuron"
    assert kinds["text/layers/input_norm"] == "neuron"
    assert kinds["text/final_norm"] == "elementwise"


def test_muon_matches_jax_on_2d_and_3d_leaves(vlm_tree):
    """3-D decoder and tower kernels (the layer axis a batch axis), the
    2-D merger kernels and the 2-D norms take Muon; the embedding,
    patch_embed and 1-D leaves take Nesterov AdamW."""
    grads = [_grads(vlm_tree, 9), _grads(vlm_tree, 10)]
    opt, _ = compare("muon", vlm_tree, grads, optimizer="muon",
                     weight_decay=0.01)
    muon = dict(zip(opt.paths, opt.is_muon))
    assert muon["text/layers/mlp/down/kernel"] and muon[
        "vision/merger/fc1/kernel"]
    assert not muon["text/embed/weight"] and not muon[
        "vision/patch_embed/kernel"] and not muon["text/final_norm"]


def test_adafactor_matches_jax_on_a_factored_leaf(text_tree):
    grads = [_grads(text_tree, 11), _grads(text_tree, 12)]
    opt, state = compare("adafactor", text_tree, grads,
                         optimizer="adafactor")
    v_row = dict(zip(opt.paths, state.opt_state["v_row"]))
    assert tuple(v_row["extra/kernel"].shape) == (2, 128)
    assert v_row["embed/weight"] is None          # 64 < 128: elementwise


@pytest.mark.parametrize("name", ["lion", "sgd"])
def test_lion_and_sgd_match_jax(text_tree, name):
    grads = [_grads(text_tree, 13, scale=20.0), _grads(text_tree, 14)]
    compare(name, text_tree, grads, optimizer=name, weight_decay=0.01)


def _lora_tree(seed=0):
    rng = np.random.default_rng(seed)
    leaf = lambda *shape: (rng.standard_normal(shape) * 0.02).astype(
        np.float32)
    return {"text": {"embed": {"a": leaf(600, 8), "b": leaf(8, 64)},
                     "layers": {"attn": {"q": {"a": leaf(2, 64, 8),
                                               "b": leaf(2, 8, 64)}}}}}


def test_loraplus_matches_jax():
    tree = _lora_tree()
    grads = [_grads(tree, 15), _grads(tree, 16)]
    opt, _ = compare("loraplus", tree, grads, loraplus_lr_ratio=16.0,
                     loraplus_lr_embedding=1e-3, weight_decay=0.01)
    assert dict(zip(opt.paths, opt.groups)) == {
        "text/embed/a": "lora_a", "text/embed/b": "embed",
        "text/layers/attn/q/a": "lora_a", "text/layers/attn/q/b": "lora_b"}


# ---------------------------------------------------------------------------
# make_optimizer: dispatch, chaining, the masked optimizer, checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["galore", "apollo", "badam", "adam_mini"])
def test_chained_weight_decay_and_clipping_match_jax(text_tree, name,
                                                    jax_signs_as_the_port):
    """The custom chain (clip, scaler, weight decay, lr) with a gradient
    of norm far above max_grad_norm, so that the clip acts."""
    grads = [_grads(text_tree, 17, scale=50.0), _grads(text_tree, 18)]

    def hook(opt):
        if name == "apollo":
            opt.projection = _jax_apollo_projection()

    compare(name, text_tree, grads, port_hook=hook, optimizer=name,
            weight_decay=0.1, galore_update_interval=1,
            badam_switch_interval=1)


@pytest.mark.parametrize("name", ["adamw", "adafactor", "lion", "sgd",
                                  "galore", "apollo", "badam", "adam_mini",
                                  "muon", "loraplus"])
def test_make_optimizer_builds_each_name(name):
    cfg = (topt.OptimizerConfig(loraplus_lr_ratio=16.0) if name == "loraplus"
           else topt.OptimizerConfig(optimizer=name))
    opt, schedule = topt.make_optimizer(cfg)
    kind = {"adamw": topt.AdamW, "adafactor": tco.Adafactor,
            "lion": tco.Lion, "sgd": tco.SGD, "galore": tco.GaLore,
            "apollo": tco.Apollo, "badam": tco.BAdam,
            "adam_mini": tco.AdamMini, "muon": tco.Muon,
            "loraplus": tco.LoraPlus}[name]
    assert type(opt) is kind and callable(schedule)


def test_an_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.make_optimizer(topt.OptimizerConfig(optimizer="adagrad"))
    with pytest.raises(ValueError, match="unknown optimizer"):
        jopt.make_optimizer(jopt.OptimizerConfig(optimizer="adagrad"))


def test_masked_optimizer_hands_the_trainable_paths(whole_vlm_tree):
    """Under a mask the inner optimizer sees the trainable leaves and
    their paths; frozen leaves stay exactly as they were."""
    params = params_from_jax(whole_vlm_tree, device="cpu")
    paths = leaf_paths(params)
    mask = [p.startswith("text/layers") for p in paths]
    inner, _ = topt.make_optimizer(topt.OptimizerConfig(
        **OPT, optimizer="adam_mini"))
    opt = MaskedOptimizer(inner, mask)
    state = create_train_state(params, opt)
    assert inner.paths == [p for p, m in zip(paths, mask) if m]
    before = [t.detach().clone() for t in tree_leaves(params)]
    with torch.no_grad():
        state.apply_gradients(_port_grads(params, _grads(whole_vlm_tree,
                                                         19)), opt)
    for m, b, a in zip(mask, before, tree_leaves(params)):
        assert torch.equal(a, b) != m


def test_a_checkpoint_restores_a_custom_optimizer_state(vlm_tree, tmp_path):
    """GaLore's projections and moments (None where a leaf has none) go
    through the checkpoint by path, bit for bit."""
    from iadr1_tpu_torch.train.checkpoint import CheckpointManager

    cfg = topt.OptimizerConfig(**OPT, optimizer="galore")
    opt, _ = topt.make_optimizer(cfg)
    state = create_train_state(params_from_jax(vlm_tree, device="cpu"), opt)
    with torch.no_grad():
        state = state.apply_gradients(_port_grads(
            state.params, _grads(vlm_tree, 20)), opt)
    CheckpointManager(str(tmp_path)).save(1, state)
    opt2, _ = topt.make_optimizer(cfg)
    fresh = create_train_state(params_from_jax(vlm_tree, device="cpu"), opt2)
    restored = CheckpointManager(str(tmp_path)).restore(fresh)
    assert restored.step == 1 and restored.opt_state["count"] == 1
    for key in ("proj", "m", "v"):
        for a, b in zip(state.opt_state[key], restored.opt_state[key]):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a, b)
