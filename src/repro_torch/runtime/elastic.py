"""Elastic scaling: the batch half of the reference's
``repro/runtime/elastic.py``.  When the fleet shrinks (a partition is
dropped), the global batch is kept by raising gradient accumulation.  The
mesh half (re-planning and re-sharding over a device mesh) waits for the
port's multi-card slice."""
from __future__ import annotations


def accum_for_batch(global_batch: int, old_devices: int, new_devices: int,
                    accum: int) -> int:
    """Keep the global batch when the fleet shrinks: scale microbatching."""
    scale = max(1, round(old_devices / max(new_devices, 1)))
    return accum * scale
