"""Supervised example encoding: per-turn prompt masking + length budgeting
(the port's own copy of iadr1_tpu/data/tokenize.py).

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


def encode_pairwise_example(
    prompt_messages: Sequence[dict],
    chosen: str,
    rejected: str,
    template,
    tokenizer,
    system: str | None = None,
    cutoff_len: int = 4096,
) -> tuple[tuple[list[int], list[int]], tuple[list[int], list[int]]]:
    """((chosen_ids, chosen_labels), (rejected_ids, rejected_labels)) for a
    ranking example, as the pairwise processor of LLaMA-Factory builds
    them: the prompt turns are encoded once and cut once, against the
    longer response (``infer_seqlen(len(prompt), max(len(chosen),
    len(rejected)), cutoff_len)``), and both responses get the same target
    budget, so that both rows score their responses under one prompt.
    Only the final responses are labeled.

    The JAX package encodes each side as a conversation of its own, so
    where the cutoff binds its two rows keep prompts of different lengths
    (ROADMAP C.R22); where it does not, and the prompt is one user turn,
    the rows are the same."""
    sides = []
    for response in (chosen, rejected):
        pairs = template.encode_multiturn(
            tokenizer, list(prompt_messages)
            + [{"role": "assistant", "content": response}], system)
        prompt = [t for src, tgt in pairs[:-1] for t in src + tgt]
        sides.append((prompt + pairs[-1][0], pairs[-1][1]))
    prompt_ids = sides[0][0]
    src_len, tgt_len = infer_seqlen(
        len(prompt_ids), max(len(sides[0][1]), len(sides[1][1])), cutoff_len)
    prompt_ids = prompt_ids[:src_len]
    out = []
    for _, target in sides:
        target = target[:tgt_len]
        out.append((prompt_ids + target, [IGNORE_INDEX] * src_len + target))
    return tuple(out)
