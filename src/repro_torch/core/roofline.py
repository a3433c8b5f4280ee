"""Roofline terms priced on the H100 (the port of ``repro/core/roofline.py``).

  compute    = FLOPs / peak FLOP/s          (per card)
  memory     = HBM bytes / HBM bandwidth    (per card)
  collective = collective bytes / link bandwidth (per card)

The terms are priced with the H100 data sheet (``core.hw``: dense bf16
tensor-core FLOP/s, HBM3 and NVLink 4 bytes/s), not the reference's TPU.
``model_flops`` is the reference's, unchanged.

The reference fills its terms from XLA's compiled artifacts:
``parse_collectives`` and ``scan_aware_collectives`` parse post-SPMD HLO
text, ``cost_analysis_dict`` and ``terms_from_compiled`` read
``compiled.cost_analysis()``.  The port compiles no HLO, so it has no input
for them and leaves them out; a caller fills the terms from its own counts
(``profiling/train_counts``, the dry run's argument bytes).
"""
from __future__ import annotations

from dataclasses import dataclass

from . import hw


@dataclass
class RooflineTerms:
    flops: float = 0.0            # per device
    bytes_hbm: float = 0.0        # per device
    bytes_coll: float = 0.0       # per device

    def times(self):
        return {
            "compute_s": self.flops / hw.H100_PEAK_FLOPS,
            "memory_s": self.bytes_hbm / hw.H100_HBM_BW,
            "collective_s": self.bytes_coll / hw.H100_NVLINK_BW,
        }

    def dominant(self):
        t = self.times()
        return max(t, key=t.get).replace("_s", "")

    def bound_time(self):
        return max(self.times().values())

    def add(self, other, scale: float = 1.0):
        self.flops += other.flops * scale
        self.bytes_hbm += other.bytes_hbm * scale
        self.bytes_coll += other.bytes_coll * scale
        return self


def model_flops(cfg, n_params: int, n_active: int, shape) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (prefill) / 2*N*B (decode step)."""
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # one decode step
