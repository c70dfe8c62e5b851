from repro_torch.optim.adamw import AdamW, clip_by_global_norm, global_norm
from repro_torch.optim.schedule import constant, warmup_cosine

__all__ = ["AdamW", "clip_by_global_norm", "global_norm", "constant",
           "warmup_cosine"]
