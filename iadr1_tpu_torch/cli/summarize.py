"""Accuracy summarizer CLI (counterpart of iadr1_tpu/cli/summarize.py):
answers JSON -> ``*_accuracy.csv`` beside it, the table printed rounded to
2 places.

Usage:
    python -m iadr1_tpu_torch.cli.summarize \
        --answers-json results/answers_0_shot.json \
        [--normal-flag good] [--overkill-miss] [--heatmap]
"""

from __future__ import annotations

import argparse

from iadr1_tpu_torch.eval.summary import summarize_answers_file


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--answers-json", required=True)
    parser.add_argument("--normal-flag", default="good")
    parser.add_argument("--overkill-miss", action="store_true")
    parser.add_argument("--heatmap", action="store_true")
    args = parser.parse_args(argv)

    table = summarize_answers_file(
        args.answers_json, args.normal_flag, args.overkill_miss,
        save_heatmap=args.heatmap,
    )
    print(table.to_string())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
