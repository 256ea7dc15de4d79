"""Structured-control reward functions for SC-GRPO.

Pure CPU functions over decoded completion strings.  They define "correct"
for the whole RL stage and are behavior-compatible with the reference
(train/stage_rl/reward.py, reward_process/{type,location,description}_reward.py),
validated by golden tests generated from the reference implementation.

Batch-level entry points follow the reference calling convention
``fn(completions, solution, **kwargs) -> list[float]`` where ``completions``
is a list of single-message conversations ``[[{"role":..., "content": str}]]``
so they can be registered one-for-one in the GRPO trainer.

The port's own copy of iadr1_tpu/rewards/ (host-side Python, no tensors).
"""

from iadr1_tpu_torch.rewards.structure import extract_tag, extract_answer
from iadr1_tpu_torch.rewards.consistency import (
    consistency_reward,
    score_consistency,
)
from iadr1_tpu_torch.rewards.accuracy import accuracy_reward, score_accuracy
from iadr1_tpu_torch.rewards.type_taxonomy import AnomalyTypeScorer, type_score
from iadr1_tpu_torch.rewards.location import location_cell, location_score
from iadr1_tpu_torch.rewards.description import (
    description_score,
    register_embedding_backend,
)
from iadr1_tpu_torch.rewards.ablations import (
    consistency_reward_cot,
    format_consistency_reward_cot,
    accuracy_reward_cot_wo_type,
    accuracy_reward_cot_wo_location,
    format_reward_cot_base,
    accuracy_reward_cot_base,
    wo_format,
)

# Name -> callable registry, mirroring reward_funcs_registry in the
# reference entry point (train/stage_rl/grpo_ad.py:126-131) plus the
# ablation variants defined in train/stage_rl/reward.py.
REWARD_REGISTRY = {
    "accuracy": accuracy_reward,
    "format": consistency_reward,
    "consistency_cot": consistency_reward_cot,
    "format_consistency_cot": format_consistency_reward_cot,
    "accuracy_wo_type": accuracy_reward_cot_wo_type,
    "accuracy_wo_location": accuracy_reward_cot_wo_location,
    "format_base": format_reward_cot_base,
    "accuracy_base": accuracy_reward_cot_base,
    "wo_format": wo_format,
}


def get_reward_funcs(names):
    """Resolve a list of reward-function names to callables."""
    return [REWARD_REGISTRY[name] for name in names]
