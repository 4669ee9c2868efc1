from repro_torch.optim.optimizer import (AdafactorCfg, AdamWCfg, Optimizer,
                                         clip_by_global_norm,
                                         cosine_schedule, global_norm,
                                         make_adafactor, make_adamw,
                                         make_optimizer)

__all__ = ["AdafactorCfg", "AdamWCfg", "Optimizer", "clip_by_global_norm",
           "cosine_schedule", "global_norm", "make_adafactor", "make_adamw",
           "make_optimizer"]
