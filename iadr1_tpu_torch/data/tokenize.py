"""Supervised example encoding: per-turn prompt masking + length budgeting
(the port's own copy of iadr1_tpu/data/tokenize.py; the pairwise encoding
waits for ROADMAP A.14).

Labels are IGNORE_INDEX over every prompt span, responses keep their ids,
and source/target are truncated jointly under the cutoff budget.
"""

from __future__ import annotations

from typing import Sequence

IGNORE_INDEX = -100


def infer_seqlen(source_len: int, target_len: int,
                 cutoff_len: int) -> tuple[int, int]:
    """Split a length budget between prompt and response.

    Short targets keep their full length (truncate source), short sources
    keep theirs (truncate target), otherwise split proportionally.
    """
    if target_len * 2 < cutoff_len:
        max_target_len = cutoff_len
    elif source_len * 2 < cutoff_len:
        max_target_len = cutoff_len - source_len
    else:
        max_target_len = int(cutoff_len * (target_len
                                           / (source_len + target_len)))

    new_target_len = min(max_target_len, target_len)
    max_source_len = max(cutoff_len - new_target_len, 0)
    new_source_len = min(max_source_len, source_len)
    return new_source_len, new_target_len


def encode_supervised_example(
    messages: Sequence[dict],
    template,
    tokenizer,
    system: str | None = None,
    cutoff_len: int = 4096,
    train_on_prompt: bool = False,
    mask_history: bool = False,
) -> tuple[list[int], list[int]]:
    """(input_ids, labels) for a multi-turn conversation.

    ``messages`` alternate user/assistant.  Each turn pair consumes budget
    from ``cutoff_len``; once exhausted, later turns are dropped.  With
    ``mask_history`` only the *last* turn trains (turns processed in
    reverse and prepended).
    """
    encoded_pairs = template.encode_multiturn(tokenizer, messages, system)
    if mask_history:
        encoded_pairs = encoded_pairs[::-1]

    input_ids: list[int] = []
    labels: list[int] = []
    total = 0
    for turn_idx, (source_ids, target_ids) in enumerate(encoded_pairs):
        if total >= cutoff_len:
            break
        src_len, tgt_len = infer_seqlen(
            len(source_ids), len(target_ids), cutoff_len - total)
        source_ids = source_ids[:src_len]
        target_ids = target_ids[:tgt_len]
        total += src_len + tgt_len

        source_label = (source_ids if train_on_prompt
                        else [IGNORE_INDEX] * src_len)
        if mask_history and turn_idx != 0:
            target_label = [IGNORE_INDEX] * tgt_len
        else:
            target_label = list(target_ids)

        if mask_history:
            input_ids = source_ids + target_ids + input_ids
            labels = source_label + target_label + labels
        else:
            input_ids += source_ids + target_ids
            labels += source_label + target_label

    return input_ids, labels
