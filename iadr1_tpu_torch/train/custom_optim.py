"""Custom optimizers: GaLore, APOLLO, BAdam, Adam-mini, Muon, LoRA+, and
optax's Adafactor, Lion and SGD (the port's own copy of
iadr1_tpu/train/custom_optim.py and of the optax transforms
iadr1_tpu/train/optimizers.py chains).

Each optimizer has the AdamW class's interface (``train/optimizers.py``):
``init`` -> state, ``apply(params, grads, state, grad_norm)`` updating
parameters and state in place, leaf by leaf.  ``init`` takes the leaves'
paths too, in the JAX package's form ("text/layers/attn/q/kernel",
``state.leaf_paths``), since these optimizers choose by path.  A state is a
dict: "count" (the steps taken) and lists parallel to the leaves, None
where a leaf holds no such tensor, which the checkpoint saves by path.

The arithmetic is the JAX package's, step for step: the gradients are
clipped by their global norm first, then the optimizer's scaler, then
decoupled weight decay, then the learning rate read at
``schedule(count)`` before the count is incremented.  Two draws cannot be
JAX's: APOLLO's random projections and BAdam's random block order come
from ``torch.Generator``s seeded by the same integers JAX folds into its
keys; both are arguments (``projection``, ``permutation``) that a caller
may replace.

BAdam departs from the JAX code where it departs from its own docstring
(ROADMAP C.R25): its blocks are the decoder's layers, the leaves under a
``layers`` stack outside the vision tower, and every other leaf (the
tower's included) is the one extra block; JAX takes the deepest stack of
any 3-D kernel, so a tower deeper than the decoder is cycled instead.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from iadr1_tpu_torch.train.optimizers import bias_correction, global_norm


def default_matrix_target(path: str, leaf) -> bool:
    """Every linear layer's kernel of ndim 2 or 3 (LLaMA-Factory's
    galore_target / apollo_target "all")."""
    return path.endswith("kernel") and leaf.dim() in (2, 3)


def seeded_generator(*ints: int, device="cpu") -> torch.Generator:
    """A generator seeded by the integers alone (np.random.SeedSequence)."""
    state = int(np.random.SeedSequence(list(ints)).generate_state(
        1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(state & (2 ** 63 - 1))


def _adam_direction(g, m, v, b1, b2, eps, count):
    """Adam's moments updated in place; returns mhat / (sqrt(vhat) + eps)."""
    m.copy_(b1 * m + (1 - b1) * g)
    v.copy_(b2 * v + (1 - b2) * g.square())
    mhat = m / bias_correction(b1, count)
    vhat = v / bias_correction(b2, count)
    return mhat / (torch.sqrt(vhat) + eps)


class ChainOptimizer:
    """chain(clip_by_global_norm(max_grad_norm), <scaler>,
    add_decayed_weights(weight_decay), scale_by_learning_rate(schedule))
    over a list of leaves, in place.  A subclass is the scaler:
    ``init_leaves`` fills the state's per-leaf lists, ``direction`` turns
    one leaf's f32 gradient into its update direction at step ``count``
    (from 1, optax's incremented count); ``lr_scale`` and ``decays`` set a
    leaf's learning rate and whether it decays."""

    def __init__(self, schedule, weight_decay: float = 0.0,
                 max_grad_norm: float | None = None):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.paths: list[str] = []

    def init(self, params: list[torch.Tensor],
             paths: list[str] | None = None) -> dict:
        self.paths = (list(paths) if paths is not None
                      else [str(i) for i in range(len(params))])
        if len(self.paths) != len(params):
            raise ValueError(f"{len(self.paths)} paths for {len(params)} "
                             "leaves")
        state = {"count": 0}
        state.update(self.init_leaves(params))
        return state

    def init_leaves(self, params) -> dict:
        return {}

    def direction(self, i: int, g: torch.Tensor, p: torch.Tensor,
                  state: dict, count: int) -> torch.Tensor:
        raise NotImplementedError

    def begin(self, count: int) -> None:
        """Per-step work before the leaves (BAdam's active block); ``count``
        the steps taken before this one."""

    def lr_scale(self, i: int, lr: float) -> float:
        return lr

    def decays(self, i: int) -> bool:
        return True

    @torch.no_grad()
    def apply(self, params, grads, state, grad_norm=None) -> None:
        clip = self.max_grad_norm is not None and self.max_grad_norm > 0
        if clip and grad_norm is None:
            grad_norm = global_norm(grads)
        clip = clip and bool(grad_norm >= self.max_grad_norm)
        count = state["count"]
        lr = self.schedule(count)
        self.begin(count)
        for i, (p, g) in enumerate(zip(params, grads)):
            g = g.float()
            if clip:
                g = g / grad_norm * self.max_grad_norm
            update = self.direction(i, g, p, state, count + 1)
            if self.weight_decay and self.decays(i):
                update = update + self.weight_decay * p
            p.copy_(p + (-self.lr_scale(i, lr)) * update)
        state["count"] = count + 1


# ---------------------------------------------------------------------------
# GaLore and APOLLO: Adam moments in a rank-r subspace
# ---------------------------------------------------------------------------


def _project_shapes(shape, rank: int):
    """GaLore's 'std' orientation: project the larger of the last two dims,
    so that the low-rank factor keeps the smaller one whole."""
    *batch, m, n = shape
    r = min(rank, m, n)
    if m >= n:
        # right: proj [*, r, n]; low = g @ proj^T -> [*, m, r]
        return tuple(batch) + (r, n), tuple(batch) + (m, r), "right"
    # left: proj [*, m, r]; low = proj^T @ g -> [*, r, n]
    return tuple(batch) + (m, r), tuple(batch) + (r, n), "left"


def _svd_proj(g: torch.Tensor, rank: int, side: str) -> torch.Tensor:
    """The top ``rank`` singular vectors of each matrix of ``g``: right
    ones [*, rank, n] for "right", left ones [*, m, rank] for "left".
    They are the top eigenvectors of the smaller Gram matrix (g^T g for
    "right", g g^T for "left"), taken in f64: the same subspace as JAX's
    SVD, 5.7x faster than an f32 SVD on an H100 at GaLore's shapes and
    closer to the exact vectors.  Each is signed so that its entry of
    largest magnitude is positive: LAPACK builds (and cuSOLVER) choose
    signs differently, and the moments carried over a refresh read them
    (ROADMAP C.R26)."""
    g = g.double()
    gram = (g.transpose(-1, -2) @ g if side == "right"
            else g @ g.transpose(-1, -2))
    top = torch.linalg.eigh(gram).eigenvectors[..., -rank:].flip(-1).float()
    if side == "right":
        return canonical_signs(top.transpose(-1, -2), dim=-1)
    return canonical_signs(top, dim=-2)


def canonical_signs(vectors: torch.Tensor, dim: int) -> torch.Tensor:
    """``vectors`` (laid along ``dim``) each times the sign of its entry of
    largest magnitude."""
    peak = vectors.gather(dim, vectors.abs().argmax(dim=dim, keepdim=True))
    return (vectors * torch.where(peak < 0, -1.0, 1.0)).contiguous()


def _down(g, proj, side):
    if side == "right":
        return g @ proj.transpose(-1, -2)
    return proj.transpose(-1, -2) @ g


def _up(low, proj, side):
    if side == "right":
        return low @ proj
    return proj @ low


class GaLore(ChainOptimizer):
    """GaLore (GaLoreAdamW as LLaMA-Factory wires it): Adam moments in the
    span of each target kernel's top ``rank`` singular vectors, refreshed
    by an SVD every ``update_proj_gap`` steps; the direction projected
    back and scaled by ``scale``.  Other leaves take plain Adam.  The
    moments carry over a refresh into the new projection, as in JAX; the
    singular vectors' signs are fixed (``canonical_signs``), JAX's are
    LAPACK's.""" 

    def __init__(self, schedule, rank=16, update_proj_gap=200, scale=0.25,
                 b1=0.9, b2=0.999, eps=1e-8,
                 target: Callable = default_matrix_target, **kw):
        super().__init__(schedule, **kw)
        self.rank, self.gap, self.scale = rank, update_proj_gap, scale
        self.b1, self.b2, self.eps = b1, b2, eps
        self.target = target

    def is_target(self, path, p) -> bool:
        return self.target(path, p) and min(p.shape[-2:]) > self.rank

    def init_leaves(self, params) -> dict:
        proj, m, v = [], [], []
        for path, p in zip(self.paths, params):
            f32 = dict(dtype=torch.float32, device=p.device)
            if self.is_target(path, p):
                proj_shape, low_shape, _ = _project_shapes(p.shape, self.rank)
                proj.append(torch.zeros(proj_shape, **f32))
                m.append(torch.zeros(low_shape, **f32))
                v.append(torch.zeros(low_shape, **f32))
            else:
                proj.append(None)
                m.append(torch.zeros(p.shape, **f32))
                v.append(torch.zeros(p.shape, **f32))
        return {"proj": proj, "m": m, "v": v}

    def direction(self, i, g, p, state, count):
        proj = state["proj"][i]
        m, v = state["m"][i], state["v"][i]
        if proj is None:
            return _adam_direction(g, m, v, self.b1, self.b2, self.eps, count)
        _, _, side = _project_shapes(g.shape, self.rank)
        if (count - 1) % self.gap == 0:
            proj.copy_(_svd_proj(g, min(self.rank, *g.shape[-2:]), side))
        low = _down(g, proj, side)
        low_dir = _adam_direction(low, m, v, self.b1, self.b2, self.eps,
                                  count)
        return self.scale * _up(low_dir, proj, side)


def gaussian_projection(seed: int):
    """APOLLO's default projection: N(0, 1/r) entries drawn from a
    generator seeded by (seed, leaf index, epoch), the integers JAX folds
    into its key."""
    def projection(path, index, epoch, shape, rank, device):
        generator = seeded_generator(seed, index, epoch)
        return (torch.randn(shape, generator=generator, dtype=torch.float32)
                / math.sqrt(rank)).to(device)
    return projection


class Apollo(ChainOptimizer):
    """APOLLO (APOLLOAdamW as LLaMA-Factory wires it): Adam moments in a
    rank-r random projection of each target kernel's gradient; the update
    is the raw gradient scaled per channel (``scale_type`` "channel") or
    as a whole ("tensor", APOLLO-mini) by ||Adam direction|| / ||projected
    gradient||, times ``scale``, its norm growth limited to
    ``norm_growth_limit`` a step.  The projection is redrawn every
    ``update_proj_gap`` steps: ``projection(path, index, epoch, shape,
    rank, device)``, ``index`` counting the target leaves in sorted-path
    order (JAX's leaf order)."""

    def __init__(self, schedule, rank=16, update_proj_gap=200, scale=1.0,
                 scale_type="channel", b1=0.9, b2=0.999, eps=1e-8, seed=0,
                 norm_growth_limit=1.01,
                 target: Callable = default_matrix_target,
                 projection: Callable | None = None, **kw):
        super().__init__(schedule, **kw)
        if scale_type not in ("channel", "tensor"):
            raise ValueError(f"unknown APOLLO scale_type {scale_type!r}")
        self.rank, self.gap, self.scale = rank, update_proj_gap, scale
        self.scale_type = scale_type
        self.b1, self.b2, self.eps = b1, b2, eps
        self.norm_growth_limit = norm_growth_limit
        self.target = target
        self.projection = projection or gaussian_projection(seed)

    def init_leaves(self, params) -> dict:
        targets = [i for i, (path, p) in enumerate(zip(self.paths, params))
                   if self.target(path, p) and min(p.shape[-2:]) > self.rank]
        order = sorted(targets, key=lambda i: self.paths[i].split("/"))
        self.index = {i: k for k, i in enumerate(order)}
        m, v, prev = [], [], []
        for i, p in enumerate(params):
            f32 = dict(dtype=torch.float32, device=p.device)
            shape = (_project_shapes(p.shape, self.rank)[1]
                     if i in self.index else p.shape)
            m.append(torch.zeros(shape, **f32))
            v.append(torch.zeros(shape, **f32))
            prev.append(torch.zeros((), **f32) if i in self.index else None)
        return {"m": m, "v": v, "prev_norm": prev}

    def direction(self, i, g, p, state, count):
        m, v = state["m"][i], state["v"][i]
        if i not in self.index:
            return _adam_direction(g, m, v, self.b1, self.b2, self.eps, count)
        proj_shape, _, side = _project_shapes(g.shape, self.rank)
        r = min(self.rank, *g.shape[-2:])
        proj = self.projection(self.paths[i], self.index[i],
                               (count - 1) // self.gap, proj_shape, r,
                               g.device)
        low = _down(g, proj, side)
        low_dir = _adam_direction(low, m, v, self.b1, self.b2, self.eps,
                                  count)
        # channel = the dim not projected: rows for "right" ([*, m, r]),
        # columns for "left" ([*, r, n])
        ch = -1 if side == "right" else -2
        if self.scale_type == "channel":
            s = (torch.linalg.vector_norm(low_dir, dim=ch, keepdim=True)
                 / (torch.linalg.vector_norm(low, dim=ch, keepdim=True)
                    + self.eps))
        else:
            s = (torch.linalg.vector_norm(low_dir)
                 / (torch.linalg.vector_norm(low) + self.eps))
        direction = g * s * self.scale
        norm = torch.linalg.vector_norm(direction)
        prev = state["prev_norm"][i]
        # the norm-growth limiter (APOLLO sec. 3.3)
        limit = torch.where(prev > 0, torch.minimum(
            norm, prev * self.norm_growth_limit), norm)
        direction = direction * torch.where(norm > 0, limit / (norm + 1e-30),
                                            1.0)
        prev.copy_(limit)
        return direction


# ---------------------------------------------------------------------------
# BAdam: block-coordinate Adam over the decoder's layers
# ---------------------------------------------------------------------------


def is_decoder_stack(path: str) -> bool:
    """A leaf of the decoder's stacked layers: under a ``layers`` key and
    outside the vision tower."""
    parts = path.split("/")
    return "layers" in parts and parts[0] != "vision"


def decoder_depth(paths, params) -> int:
    """L: the leading dim of the decoder's stacked 3-D kernels (0 if the
    tree has none)."""
    dims = {p.shape[0] for path, p in zip(paths, params)
            if is_decoder_stack(path) and p.dim() == 3
            and path.endswith("kernel")}
    return max(dims) if dims else 0


def seeded_permutation(seed: int):
    """BAdam's random order: a permutation of the blocks for each cycle,
    drawn from a generator seeded by (seed, cycle)."""
    def permutation(cycle, n_blocks):
        return torch.randperm(n_blocks,
                              generator=seeded_generator(seed, cycle)).tolist()
    return permutation


class BAdam(ChainOptimizer):
    """BAdam (LLaMA-Factory's layer-mode BlockOptimizer): Adam on one block
    at a time, switching every ``switch_interval`` steps in ascending,
    descending or random order.  The blocks are the L decoder layers (a
    row of every decoder leaf stacked [L, ...]) and one extra block of
    every other leaf.  A block's moments restart from zero when it turns
    active, its bias correction counting the steps within the block.
    ``permutation(cycle, n_blocks)`` orders a random cycle."""

    def __init__(self, schedule, num_layers: int | None = None,
                 switch_interval=50, switch_mode="ascending", b1=0.9,
                 b2=0.999, eps=1e-8, seed=0,
                 permutation: Callable | None = None, **kw):
        super().__init__(schedule, **kw)
        if switch_mode not in ("ascending", "descending", "random"):
            raise ValueError(f"unknown switch_mode {switch_mode!r}")
        self.num_layers = num_layers
        self.interval, self.mode = switch_interval, switch_mode
        self.b1, self.b2, self.eps = b1, b2, eps
        self.permutation = permutation or seeded_permutation(seed)

    def init_leaves(self, params) -> dict:
        self.L = self.num_layers or decoder_depth(self.paths, params)
        self.stacked = [is_decoder_stack(path) and p.dim() >= 2
                        and p.shape[0] == self.L
                        for path, p in zip(self.paths, params)]
        return {"m": [torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device) for p in params],
                "v": [torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device) for p in params]}

    def active_block(self, count: int) -> int:
        """The block that step ``count`` (from 0) updates; L is the extra
        block."""
        n_blocks = self.L + 1
        slot = count // self.interval
        pos = slot % n_blocks
        if self.mode == "ascending":
            return pos
        if self.mode == "descending":
            return n_blocks - 1 - pos
        return int(self.permutation(slot // n_blocks, n_blocks)[pos])

    def begin(self, count):
        self.active = self.active_block(count)
        self.fresh = count % self.interval == 0
        self.t_local = float(count % self.interval) + 1.0

    def direction(self, i, g, p, state, count):
        m, v = state["m"][i], state["v"][i]
        L = self.L
        if self.stacked[i]:
            mask = (torch.arange(L, device=g.device) == self.active).float()
            mask = mask.reshape((L,) + (1,) * (g.dim() - 1))
        else:
            mask = torch.tensor(float(self.active == L), device=g.device)
        if self.fresh:
            m.mul_(1 - mask)
            v.mul_(1 - mask)
        m.copy_(m + mask * ((self.b1 - 1) * m + (1 - self.b1) * g))
        v.copy_(v + mask * ((self.b2 - 1) * v + (1 - self.b2) * g.square()))
        t = self.t_local
        mhat = m / bias_correction(self.b1, t)
        vhat = v / bias_correction(self.b2, t)
        return mask * mhat / (torch.sqrt(vhat) + self.eps)


# ---------------------------------------------------------------------------
# Adam-mini: one second moment per block
# ---------------------------------------------------------------------------


class AdamMini(ChainOptimizer):
    """Adam-mini: the second moment is one value per block.  The partition
    is JAX's, by substring of the path: "embed" / "lm_head" leaves a value
    per row; "attn/q" / "attn/k" kernels one per head with ``head_dim``
    (the fused tower "attn/qkv" included, as in JAX), else one per output
    neuron, as every other matrix; 1-D leaves elementwise.  The first
    moments stay whole."""

    def __init__(self, schedule, b1=0.9, b2=0.999, eps=1e-8,
                 head_dim: int | None = None, **kw):
        super().__init__(schedule, **kw)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.head_dim = head_dim

    def block_of(self, path: str, shape) -> str:
        """The partition of a leaf: elementwise, row, head or neuron."""
        if len(shape) <= 1:
            return "elementwise"
        if "embed" in path or "lm_head" in path:
            return "row"
        if self.head_dim and ("attn/q" in path or "attn/k" in path) and (
                shape[-1] % self.head_dim == 0):
            return "head"
        return "neuron"

    def v_reduce(self, path, g):
        g2 = g.square()
        kind = self.block_of(path, g.shape)
        if kind == "elementwise":
            return g2
        if kind == "row":
            return g2.mean(dim=-1, keepdim=True)
        if kind == "head":
            heads = g.shape[-1] // self.head_dim
            shaped = g2.reshape(g.shape[:-1] + (heads, self.head_dim))
            per_head = shaped.mean(dim=(-3, -1))               # [*, heads]
            return per_head.repeat_interleave(self.head_dim,
                                              dim=-1).unsqueeze(-2)
        return g2.mean(dim=-2, keepdim=True)

    def init_leaves(self, params) -> dict:
        return {"m": [torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device) for p in params],
                "v": [torch.zeros_like(self.v_reduce(path, p.detach().float()))
                      for path, p in zip(self.paths, params)]}

    def direction(self, i, g, p, state, count):
        m, v = state["m"][i], state["v"][i]
        m.copy_(self.b1 * m + (1 - self.b1) * g)
        v.copy_(self.b2 * v + (1 - self.b2) * self.v_reduce(self.paths[i], g))
        mhat = m / bias_correction(self.b1, count)
        vhat = v / bias_correction(self.b2, count)
        return mhat / (torch.sqrt(vhat) + self.eps)


# ---------------------------------------------------------------------------
# Muon
# ---------------------------------------------------------------------------

# optax.contrib.muon's Newton-Schulz coefficients (optax 0.2.6)
NS_COEFFS = (3.4445, -4.7750, 2.0315)


def newton_schulz(x: torch.Tensor, steps: int = 5, eps: float = 1e-8):
    """optax's orthogonalize_via_newton_schulz over [batch, m, n]: each
    matrix (transposed when it is taller than wide) divided by its
    Frobenius norm + eps, then ``steps`` quintic iterations."""
    a0, a1, a2 = NS_COEFFS
    transposed = x.shape[-2] > x.shape[-1]
    if transposed:
        x = x.transpose(-1, -2)
    x = x / (torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True) + eps)
    for _ in range(steps):
        a = x @ x.transpose(-1, -2)
        b = a1 * a + (a2 * a) @ a
        x = a0 * x + b @ x
    return x.transpose(-1, -2) if transposed else x


def muon_leaf(path: str, leaf) -> bool:
    """Muon takes the hidden matrices (2-D, or 3-D with the layer axis as
    a batch axis); embeddings, the LM head and 1-D leaves take Adam."""
    if "embed" in path or "lm_head" in path:
        return False
    return leaf.dim() in (2, 3)


class Muon(ChainOptimizer):
    """optax.contrib.muon as the JAX package calls it: on the Muon leaves,
    Nesterov momentum (``beta``) orthogonalized by Newton-Schulz, scaled
    by sqrt(max(1, fan_out / fan_in)), with weight decay; on the others,
    AdamW with Nesterov momentum, optax's eps 1e-8 and no weight decay."""

    def __init__(self, schedule, beta=0.95, weight_decay=0.0, adam_b1=0.9,
                 adam_b2=0.999, eps=1e-8, ns_steps=5, **kw):
        super().__init__(schedule, weight_decay=weight_decay, **kw)
        self.beta, self.eps, self.ns_steps = beta, eps, ns_steps
        self.b1, self.b2 = adam_b1, adam_b2

    def init_leaves(self, params) -> dict:
        self.is_muon = [muon_leaf(path, p)
                        for path, p in zip(self.paths, params)]
        return {"mu": [torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device) for p in params],
                "nu": [None if m else torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device)
                    for m, p in zip(self.is_muon, params)]}

    def decays(self, i):
        return self.is_muon[i]

    def direction(self, i, g, p, state, count):
        mu = state["mu"][i]
        if self.is_muon[i]:
            b = self.beta
            mu.copy_((1 - b) * g + b * mu)
            mu_hat = (b * (mu / bias_correction(b, count + 1))
                      + (1 - b) * (g / bias_correction(b, count)))
            x = mu_hat if mu_hat.dim() == 3 else mu_hat[None]
            out = newton_schulz(x, self.ns_steps, self.eps)
            out = out if mu_hat.dim() == 3 else out[0]
            fan_in, fan_out = g.shape[-2], g.shape[-1]
            return math.sqrt(max(1.0, fan_out / fan_in)) * out
        nu, b1, b2 = state["nu"][i], self.b1, self.b2
        mu.copy_((1 - b1) * g + b1 * mu)
        nu.copy_((1 - b2) * g.square() + b2 * nu)
        mu_hat = (b1 * (mu / bias_correction(b1, count + 1))
                  + (1 - b1) * (g / bias_correction(b1, count)))
        nu_hat = nu / bias_correction(b2, count)
        return mu_hat / (torch.sqrt(nu_hat) + self.eps)


# ---------------------------------------------------------------------------
# LoRA+
# ---------------------------------------------------------------------------


def loraplus_group(path: str) -> str:
    """The B factors ("…/b") step at lr * ratio, those of the embedding at
    lr_embedding; everything else (the A factors) at lr."""
    if path.endswith("/b") or path == "b":
        return "embed" if "embed" in path else "lora_b"
    return "lora_a"


class LoraPlus(ChainOptimizer):
    """LoRA+ (LLaMA-Factory's _create_loraplus_optimizer): AdamW in three
    groups, lora_a at the schedule's lr, lora_b at lr * ``lr_ratio``, the
    embedding adapters' B at the constant ``lr_embedding``."""

    def __init__(self, schedule, lr_ratio=16.0, lr_embedding=1e-6, b1=0.9,
                 b2=0.999, eps=1e-8, **kw):
        super().__init__(schedule, **kw)
        self.lr_ratio, self.lr_embedding = lr_ratio, lr_embedding
        self.b1, self.b2, self.eps = b1, b2, eps

    def init_leaves(self, params) -> dict:
        self.groups = [loraplus_group(path) for path in self.paths]
        return {"mu": [torch.zeros_like(p, dtype=torch.float32)
                       for p in params],
                "nu": [torch.zeros_like(p, dtype=torch.float32)
                       for p in params]}

    def lr_scale(self, i, lr):
        group = self.groups[i]
        if group == "embed":
            return self.lr_embedding
        return lr * self.lr_ratio if group == "lora_b" else lr

    def direction(self, i, g, p, state, count):
        return _adam_direction(g, state["mu"][i], state["nu"][i], self.b1,
                               self.b2, self.eps, count)


# ---------------------------------------------------------------------------
# optax's Adafactor, Lion and SGD
# ---------------------------------------------------------------------------


def _factored_dims(shape, min_dim_size_to_factor: int):
    """optax: the two largest dims, if the second largest is at least
    ``min_dim_size_to_factor``; else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


def _safe_rms(x: torch.Tensor, min_rms: float) -> torch.Tensor:
    return torch.sqrt(x.float().square().mean()).clamp(min=min_rms)


class Adafactor(ChainOptimizer):
    """optax.adafactor(schedule) with its defaults: a factored second
    moment over the two largest dims when both are at least
    ``min_dim_size_to_factor`` (else elementwise), decay 1 - (t+1)^-0.8,
    eps 1e-30, updates clipped to block RMS 1, times the parameter's RMS
    (at least 1e-3), times the lr, descending; no weight decay.  The
    moments take the parameter's dtype, as optax's do."""

    def __init__(self, schedule, min_dim_size_to_factor=128, decay_rate=0.8,
                 eps=1e-30, clipping_threshold=1.0, **kw):
        super().__init__(schedule, **kw)
        self.min_dim = min_dim_size_to_factor
        self.decay_rate, self.eps = decay_rate, eps
        self.clipping_threshold = clipping_threshold

    def init_leaves(self, params) -> dict:
        v_row, v_col, v = [], [], []
        for p in params:
            dims = _factored_dims(tuple(p.shape), self.min_dim)
            if dims is None:
                v_row.append(None)
                v_col.append(None)
                v.append(torch.zeros_like(p))
            else:
                d1, d0 = dims
                v_row.append(torch.zeros(
                    np.delete(p.shape, d0).tolist(), dtype=p.dtype,
                    device=p.device))
                v_col.append(torch.zeros(
                    np.delete(p.shape, d1).tolist(), dtype=p.dtype,
                    device=p.device))
                v.append(None)
        return {"v_row": v_row, "v_col": v_col, "v": v}

    def direction(self, i, g, p, state, count):
        t = torch.tensor(float(count), dtype=torch.float32)
        decay = float(1.0 - t ** (-self.decay_rate))
        grad_sqr = g.square() + self.eps
        dims = _factored_dims(tuple(g.shape), self.min_dim)
        if dims is None:
            v = state["v"][i]
            v.copy_(decay * v + (1.0 - decay) * grad_sqr)
            update = g * v.float() ** -0.5
        else:
            d1, d0 = dims
            v_row, v_col = state["v_row"][i], state["v_col"][i]
            v_row.copy_(decay * v_row + (1.0 - decay) * grad_sqr.mean(dim=d0))
            v_col.copy_(decay * v_col + (1.0 - decay) * grad_sqr.mean(dim=d1))
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = v_row.float().mean(dim=reduced_d1, keepdim=True)
            row_factor = (v_row.float() / row_col_mean) ** -0.5
            col_factor = v_col.float() ** -0.5
            update = (g * row_factor.unsqueeze(d0)
                      * col_factor.unsqueeze(d1))
        # clip_by_block_rms, then the parameter's scale (the lr comes
        # after, in ``apply``: the products commute)
        denom = torch.clamp(torch.sqrt(update.square().mean())
                            / self.clipping_threshold, min=1.0)
        return update / denom * _safe_rms(p, 1e-3)


class Lion(ChainOptimizer):
    """optax.lion(schedule, weight_decay): the sign of (1-b1) g + b1 m,
    then m <- (1-b2) g + b2 m; b1 0.9, b2 0.99."""

    def __init__(self, schedule, b1=0.9, b2=0.99, **kw):
        super().__init__(schedule, **kw)
        self.b1, self.b2 = b1, b2

    def init_leaves(self, params) -> dict:
        return {"mu": [torch.zeros_like(p) for p in params]}

    def direction(self, i, g, p, state, count):
        mu = state["mu"][i]
        update = torch.sign((1.0 - self.b1) * g + self.b1 * mu)
        mu.copy_((1 - self.b2) * g + self.b2 * mu)
        return update


class SGD(ChainOptimizer):
    """optax.sgd(schedule): -lr * g."""

    def direction(self, i, g, p, state, count):
        return g
