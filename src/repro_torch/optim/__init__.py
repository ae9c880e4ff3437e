from repro_torch.optim.adamw import (adamw_init, adamw_update, global_norm,
                                     clip_by_global_norm, is_trainable)
from repro_torch.optim.schedule import warmup_cosine, constant_lr

__all__ = ["adamw_init", "adamw_update", "global_norm",
           "clip_by_global_norm", "is_trainable", "warmup_cosine",
           "constant_lr"]
