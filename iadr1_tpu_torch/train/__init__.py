"""Training stages of the port: PA-SFT, SC-GRPO and the preference stages
(DPO and its losses, KTO, BCO, RM, PRM, PPO, RLOO, online DPO, XPO,
Nash-MD, GKD).

The exports are those of the JAX package's ``iadr1_tpu.train`` that the
port has; ``make_sft_step`` (the unchunked step) and
``IterativeSFTTrainer`` wait for ROADMAP A.14c.
"""

from iadr1_tpu_torch.train.state import TrainState, create_train_state
from iadr1_tpu_torch.train.optimizers import make_optimizer, OptimizerConfig
from iadr1_tpu_torch.train.sft import sft_loss
from iadr1_tpu_torch.train.grpo import GRPOConfig, GRPOTrainer
from iadr1_tpu_torch.train.online_rl import (
    NashMDConfig,
    NashMDTrainer,
    OnlineDPOTrainer,
    RLOOTrainer,
    XPOConfig,
    XPOTrainer,
    rloo_advantages,
)
from iadr1_tpu_torch.train.gkd import GKDConfig, GKDTrainer
from iadr1_tpu_torch.train.preference import (
    BCOConfig,
    DPOConfig,
    KTOConfig,
    make_bco_step,
    make_dpo_step,
    make_kto_step,
    make_prm_step,
    make_rm_step,
)
