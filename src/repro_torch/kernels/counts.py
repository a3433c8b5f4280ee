"""The kernel wrappers' launch counts, read as one record.

Each wrapper in ``kernels/*/ops.py`` counts its launches in a plain
integer, ``<wrapper>.launches``, and the matmul and conv2d wrappers also by
route, in the dict ``<wrapper>.routes``.  A wrapper counts where it issues
its kernel: on the stream, or into a CUDA graph being captured
(``serving/step_graph.py``).  A replay of that graph runs the kernels again
without the wrappers, so it adds nothing; the graph counts its replays
itself.  ``snapshot`` and ``diff`` give what one stretch of work issued.

Pure Python over any objects with those attributes, so the CPU tests drive
it with stand-ins.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

# one wrapper's counts: (launches, launches by route)
Count = Tuple[int, Dict[str, int]]


def snapshot(wrappers: Sequence) -> Tuple[Count, ...]:
    """Each wrapper's ``launches`` and a copy of its ``routes`` (empty for
    a wrapper without one)."""
    return tuple((int(w.launches), dict(getattr(w, "routes", {})))
                 for w in wrappers)


def diff(after: Sequence[Count], before: Sequence[Count]) -> Tuple[Count, ...]:
    """What happened between two snapshots of the same wrappers."""
    if len(after) != len(before):
        raise ValueError(f"snapshots of {len(after)} and {len(before)} "
                         "wrappers")
    return tuple((a - b, {k: v - rb.get(k, 0) for k, v in ra.items()})
                 for (a, ra), (b, rb) in zip(after, before))
