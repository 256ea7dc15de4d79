"""Export a port training checkpoint to an HF-format model directory
(counterpart of iadr1_tpu/cli/export.py).

After PA-SFT or SC-GRPO, write a directory the next stage, the eval
harness, the JAX package or any HF consumer can load.  The checkpoint's
parameters are read onto the card (``--device cpu``: the host), laid out
there in HF's order and copied to the host one tensor at a time.

Usage:
    python -m iadr1_tpu_torch.cli.export --model-path <source HF ckpt> \
        --checkpoint-dir output/run/checkpoints [--step N] --output-dir out/export
"""

from __future__ import annotations

import argparse

from iadr1_tpu_torch.cli.train_sft import add_device_argument


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model-path", required=True,
                        help="source HF checkpoint (config/tokenizer)")
    parser.add_argument("--checkpoint-dir", required=True)
    parser.add_argument("--step", type=int, default=None)
    parser.add_argument("--output-dir", required=True)
    add_device_argument(parser)
    args = parser.parse_args(argv)

    from iadr1_tpu_torch.cli.pipeline import export_run

    export_run(args.model_path, args.checkpoint_dir, args.output_dir,
               step=args.step, device=args.device)
    print(f"exported step {args.step or 'latest'} -> {args.output_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
