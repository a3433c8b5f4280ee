"""Phase pricing: the analytic and the measured cost model behind one API.

  * ``timer``      — ``PhaseTimer``: wall-clocked device ops folded into
    per-(phase, batch-shape) EMAs (the engine synchronises the card on both
    edges of an op before reading the clock);
  * ``cost_model`` — ``AnalyticCostModel`` (the deterministic default) and
    ``MeasuredCostModel`` (measured durations over analytic bytes/FLOPs,
    analytic fallback while cold), plus JSON profile persistence
    (``save_profile`` / ``load_profile``) so a calibration run replays
    deterministically.

The port's counterpart of ``repro/profiling/__init__.py``, with the same
exports; ``repro_torch.serving.engine`` consumes it via its
``cost_model=`` parameter.
"""
from repro_torch.profiling.cost_model import (COST_MODELS, AnalyticCostModel,
                                              CostModel, MeasuredCostModel,
                                              PhaseCost, decode_cost,
                                              load_profile, make_cost_model,
                                              prefill_cost,
                                              prefill_cost_ragged,
                                              save_profile)
from repro_torch.profiling.timer import (PhaseStat, PhaseTimer,
                                         bucket_tokens, shape_key)

__all__ = [
    "COST_MODELS", "AnalyticCostModel", "CostModel", "MeasuredCostModel",
    "PhaseCost", "PhaseStat", "PhaseTimer", "bucket_tokens", "decode_cost",
    "load_profile", "make_cost_model", "prefill_cost", "prefill_cost_ragged",
    "save_profile", "shape_key",
]
