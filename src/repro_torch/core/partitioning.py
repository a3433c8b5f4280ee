"""Compute-unit partitioning: the paper's technique as a config (the port
of ``repro/core/partitioning.py``).

``PartitionConfig`` threads through the training runtime
(``runtime/partition_runtime.py``).  ``tradeoff_report`` prices the
paper's data-reuse-versus-shaping trade for a model: the extra HBM of
per-partition weight replicas and the amortized cross-partition sync
traffic, in H100 data-sheet units (80 GB of HBM a card, NVLink 4's 900
GB/s for the sync) where the reference prices a TPU's.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core import hw


@dataclass(frozen=True)
class PartitionConfig:
    partitions: int = 1          # P: number of asynchronous partitions
    sync_every: int = 1          # W: optimizer steps between cross-partition
                                 #    parameter syncs (W=1 == synchronous DP)
    stagger: str = "uniform"     # phase policy: none|uniform|random|optimized
    compress_sync: bool = False  # int8+EF gradient compression on sync

    def __post_init__(self):
        if self.partitions < 1 or self.sync_every < 1:
            raise ValueError("partitions and sync_every must be >= 1")

    @property
    def is_partitioned(self) -> bool:
        return self.partitions > 1


def weight_replica_bytes(n_params: int, partitions: int,
                         bytes_per_param: int = 2) -> int:
    """Extra HBM for per-partition weight replicas vs fully-sharded storage
    (the paper's 'kernel weights are not shared among partitions')."""
    base = n_params * bytes_per_param
    return base * (partitions - 1)


def sync_bytes_per_step(n_params: int, partitions: int, sync_every: int,
                        bytes_per_param: int = 2,
                        compressed: bool = False) -> float:
    """Amortized cross-partition sync traffic per optimizer step per
    partition (ring all-reduce ~ 2x payload)."""
    if partitions == 1:
        return 0.0
    payload = n_params * (1 if compressed else bytes_per_param)
    return 2.0 * payload / sync_every


def tradeoff_report(n_params: int, pc: PartitionConfig,
                    per_device_hbm: float = hw.H100_HBM_GB * 2**30,
                    chips_per_partition: int = 256) -> dict:
    """The paper's section-3 trade in H100 units: reuse loss (HBM replicas
    and sync traffic) to weigh against the simulated shaping gain.  The
    keys are the reference's; the sync seconds are over NVLink."""
    rep = weight_replica_bytes(n_params, pc.partitions)
    sync = sync_bytes_per_step(n_params, pc.partitions, pc.sync_every,
                               compressed=pc.compress_sync)
    return {
        "partitions": pc.partitions,
        "sync_every": pc.sync_every,
        "replica_bytes_total": rep,
        "replica_bytes_per_device": rep / max(chips_per_partition
                                              * pc.partitions, 1),
        "sync_bytes_per_step": sync,
        "sync_seconds_per_step_dcn": sync / hw.H100_NVLINK_BW,
        "hbm_fraction_per_device": (n_params * 2 / max(chips_per_partition, 1)
                                    ) / per_device_hbm,
    }
