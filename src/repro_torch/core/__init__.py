"""Stratus core: distributed-training strategies (the paper's Spark/Elephas
modes), the Trainer, and the end-to-end train->deploy->serve pipeline."""
from repro_torch.core.strategies import (ElasticAveraging, LocalSGD,
                                         SyncDataParallel, make_strategy)
from repro_torch.core.trainer import Trainer, worker_batches

__all__ = ["SyncDataParallel", "LocalSGD", "ElasticAveraging",
           "make_strategy", "Trainer", "worker_batches"]
