from repro_torch.optim.optimizer import (AdamWCfg, Optimizer,
                                         clip_by_global_norm,
                                         cosine_schedule, global_norm,
                                         make_adamw, make_optimizer)

__all__ = ["AdamWCfg", "Optimizer", "clip_by_global_norm",
           "cosine_schedule", "global_norm", "make_adamw", "make_optimizer"]
