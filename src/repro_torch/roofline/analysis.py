"""Roofline terms of one step, per device, priced with the H100's
datasheet constants (``repro_torch.launch.mesh``).

The port of ``repro.roofline.analysis``.  Three terms per (arch x shape
x mesh), all PER DEVICE:

    compute_s    = FLOPs / PEAK_FLOPS["bfloat16"]
    memory_s     = bytes / HBM_BYTES_PER_S
    collective_s = sum over collectives of bytes(op) * factor(op)
                   / rate of the slowest link in op's group

Where they come from (``launch/dryrun.py``): the step runs on fake
tensors over a fake process group (``FakeTensorMode``, DTensor), and a
dispatch mode reads each op that runs on one device's shards.

* FLOPs are those ``torch.utils.flop_counter`` has a formula for: the
  matmul-like ops (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions,
  SDPA), at the local shapes.  Elementwise work, reductions and
  softmaxes count nothing.  (XLA's ``flops`` in the reference counts
  elementwise work too, so the two packages' totals meet only through
  ``model_flops`` and the useful ratio.)
* bytes are each dispatched op's local inputs read and outputs written,
  views and collectives excluded: an unfused upper bound (torch has no
  counterpart of XLA's "bytes accessed" after fusion).
* collectives are the functional collectives DTensor issues
  (``_c10d_functional``), each recorded with its kind, its buffer's bytes
  (the result's, as the reference reads the HLO's result shapes) and the
  ranks of its group.  The ring factors are the reference's
  (``_FACTOR``).  A collective is priced by the slowest link its group
  crosses: NVLink 4 if all its ranks sit in one node of
  ``RANKS_PER_NODE``, InfiniBand NDR otherwise (``mesh.link_bytes_per_s``).

Time-recurrent cores (mamba, rwkv6) are counted analytically
(``ssm.recurrence_cost`` / ``rwkv6.recurrence_cost``), as in the
reference: the dry-run does not walk 32,768 sequential steps
(``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.launch.mesh import (HBM_BYTES_PER_S, PEAK_FLOPS,
                                     link_bytes_per_s)

# effective traffic multiplier per collective kind (ring algorithms)
_FACTOR = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def collective_bytes(records: Iterable[Tuple[str, float, Tuple[int, ...]]]
                     ) -> Tuple[float, Dict[str, float], float]:
    """records: (kind, buffer bytes, group ranks) per collective ->
    (weighted bytes, raw bytes per kind, seconds at each group's slowest
    link)."""
    per_kind: Dict[str, float] = {}
    weighted = seconds = 0.0
    for kind, nbytes, ranks in records:
        per_kind[kind] = per_kind.get(kind, 0.0) + nbytes
        w = nbytes * _FACTOR[kind]
        weighted += w
        seconds += w / link_bytes_per_s(ranks)
    return weighted, per_kind, seconds


@dataclasses.dataclass
class RooflineResult:
    flops: float                 # per device
    hbm_bytes: float             # per device
    coll_bytes_weighted: float   # per device
    coll_by_kind: Dict[str, float]
    coll_seconds: float = 0.0    # weighted bytes over their links' rates

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS["bfloat16"]

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BYTES_PER_S

    @property
    def collective_s(self) -> float:
        return self.coll_seconds

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    def terms(self) -> Dict[str, float]:
        return {"compute_s": self.compute_s, "memory_s": self.memory_s,
                "collective_s": self.collective_s, "dominant": self.dominant}


def roofline_terms(flops: float, hbm_bytes: float, records=()
                   ) -> RooflineResult:
    w, kinds, secs = collective_bytes(records)
    return RooflineResult(flops, hbm_bytes, w, kinds, secs)


# ---------------------------------------------------------------- analytic


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """MODEL_FLOPS (GLOBAL): 6*N*D for training, 2*N_active*D for prefill
    and for a decode step (one token a sequence), the reference's
    yardstick of useful work."""
    n_active = cfg.active_param_count()
    if shape.mode == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.mode == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch
