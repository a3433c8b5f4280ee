"""Per-request lifecycle records: hop timestamps from arrival to retire.

Every stage transition a request goes through is appended as
``(stage, t, info)`` under its rid: ``submit`` / ``reject`` at the queue,
``dispatch`` when the cluster controller assigns it, ``prefill`` when an
engine seats it, ``first_token`` at the first stamped token,
``handoff_export`` / ``handoff_import`` around a PD migration,
``requeue`` on failover, ``retire`` at completion.  All timestamps are
virtual seconds, so the log is deterministic and queryable after a run
(``timeline(rid)``), and ``summary()`` condenses it into the CLI exit
line (stage counts + mean admit→first-token / admit→retire hops).
"""
from __future__ import annotations

from typing import Dict, List, Tuple


class LifecycleLog:
    """Ordered per-request stage records on the virtual clock."""

    def __init__(self):
        self.records: Dict[int, List[Tuple[str, float, dict]]] = {}

    def event(self, rid: int, stage: str, t: float, **info) -> None:
        self.records.setdefault(rid, []).append((stage, float(t), info))

    def timeline(self, rid: int) -> Tuple[Tuple[str, float, dict], ...]:
        """All (stage, t, info) hops for one request, in emission order."""
        return tuple(self.records.get(rid, ()))

    def stage_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for recs in self.records.values():
            for stage, _, _ in recs:
                counts[stage] = counts.get(stage, 0) + 1
        return dict(sorted(counts.items()))

    def _hop(self, recs, a: str, b: str):
        ta = next((t for s, t, _ in recs if s == a), None)
        tb = next((t for s, t, _ in recs if s == b), None)
        return (tb - ta) if ta is not None and tb is not None else None

    def summary(self) -> Dict[str, float]:
        """Stage counts plus mean submit→first_token / submit→retire
        spans over requests that completed both hops."""
        out: Dict[str, float] = {f"n_{k}": v
                                 for k, v in self.stage_counts().items()}
        for key, (a, b) in (("submit_to_first_token", ("submit",
                                                       "first_token")),
                            ("submit_to_retire", ("submit", "retire"))):
            hops = [h for recs in self.records.values()
                    if (h := self._hop(recs, a, b)) is not None]
            if hops:
                out[f"mean_{key}"] = sum(hops) / len(hops)
        return out

    def format_exit_line(self) -> str:
        """One-line digest for the CLI: stage counts and mean hops."""
        s = self.summary()
        counts = " ".join(f"{k[2:]}={int(v)}" for k, v in sorted(s.items())
                          if k.startswith("n_"))
        hops = " ".join(f"{k[5:]}={v:.4g}s" for k, v in sorted(s.items())
                        if k.startswith("mean_"))
        return f"lifecycle: {counts}" + (f" | {hops}" if hops else "")
