"""GaLore's projection on one CUDA card: the port's route
(iadr1_tpu_torch.train.custom_optim._svd_proj, the top eigenvectors of the
f64 Gram matrix) against an f32 ``torch.linalg.svd``, at the target
kernels of chip_smoke.py's phase 33d (Qwen2-VL-2B with 4 decoder layers
and the whole tower): the time of each route over every stack, and how
far each one's top-16 subspace lies from an f64 SVD's.

    python3 tools/bench_galore_projection.py
"""

import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

RANK = 16
# [batch, m, n] of every stacked kernel GaLore targets in phase 33d
SHAPES = [(4, 1536, 1536), (4, 1536, 256), (4, 1536, 8960), (4, 8960, 1536),
          (32, 1280, 3840), (32, 1280, 1280), (32, 1280, 5120),
          (32, 5120, 1280), (5120, 5120), (5120, 1536), (1176, 1280)]


def svd_f32(g, side):
    u, _, vh = torch.linalg.svd(g, full_matrices=False)
    return vh[..., :RANK, :] if side == "right" else u[..., :, :RANK]


def subspace_gap(p, ref, side):
    """max |P P^T - R R^T| over the projectors onto the two subspaces."""
    if side == "left":
        p, ref = p.transpose(-1, -2), ref.transpose(-1, -2)
    p, ref = p.double(), ref.double()
    return float((p.transpose(-1, -2) @ p
                  - ref.transpose(-1, -2) @ ref).abs().max())


def timed(fn):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_galore_projection: no CUDA device", file=sys.stderr)
        return 2
    from iadr1_tpu_torch.train.custom_optim import _svd_proj

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    totals = {"svd_f32": 0.0, "gram_eigh_f64": 0.0}
    for shape in SHAPES:
        side = "right" if shape[-2] >= shape[-1] else "left"
        g = torch.randn(shape, generator=gen, device="cuda") * 1e-3
        ref = svd_f32(g.double(), side)
        parts = []
        for name, fn in (("svd_f32", lambda: svd_f32(g, side)),
                         ("gram_eigh_f64", lambda: _svd_proj(g, RANK, side))):
            proj, secs = timed(fn)
            totals[name] += secs
            parts.append(f"{name} {1e3 * secs:.1f} ms (subspace gap "
                         f"{subspace_gap(proj, ref, side):.1e})")
        print(f"{shape} {side}: " + "; ".join(parts), flush=True)
    print("totals: " + ", ".join(f"{k} {1e3 * v:.1f} ms"
                                 for k, v in totals.items()))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = card.stdout.strip()
    print(f"on {card}; {torch.cuda.device_count()} visible")
    return 0


if __name__ == "__main__":
    sys.exit(main())
