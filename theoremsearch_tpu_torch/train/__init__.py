"""Port of theoremsearch_tpu.train: contrastive fine-tuning (InfoNCE),
LoRA adapters, checkpoints and training pairs."""

from .contrastive import (
    TrainState,
    init_lora_train_state,
    init_sharded_train_state,
    init_train_state,
    make_lora_train_step,
    make_train_step,
    shard_train_state,
)
from .lora import lora_init, lora_merge, lora_num_params

__all__ = [
    "TrainState",
    "init_lora_train_state",
    "init_sharded_train_state",
    "init_train_state",
    "lora_init",
    "lora_merge",
    "lora_num_params",
    "make_lora_train_step",
    "make_train_step",
    "shard_train_state",
]
