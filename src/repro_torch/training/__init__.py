"""Training on the device: AdamW, the train step with gradient
accumulation, and checkpoints in the reference's format."""
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_update, cosine_schedule,
                                            global_norm, init_adamw)
from repro_torch.training.train import (TrainState, init_train_state,
                                        make_train_step, train_loop)

__all__ = ["AdamWConfig", "AdamWState", "TrainState", "adamw_update",
           "cosine_schedule", "global_norm", "init_adamw",
           "init_train_state", "load_checkpoint", "make_train_step",
           "save_checkpoint", "train_loop"]
