"""Optimizers and learning-rate schedules (the port of ``repro.optim``)."""
from repro_torch.optim.optimizers import (Optimizer, adam, adamw,
                                          apply_updates, clip_by_global_norm,
                                          momentum, sgd)
from repro_torch.optim.schedules import constant, cosine_warmup

__all__ = ["adam", "adamw", "momentum", "sgd", "apply_updates",
           "clip_by_global_norm", "Optimizer", "constant", "cosine_warmup"]
