"""Chrome-trace / Perfetto JSON export + schema validation.

``to_chrome`` projects a ``Tracer``'s event list into the Chrome Trace
Event Format (the JSON Perfetto and ``chrome://tracing`` load): each
event group becomes a process (track group), each tid a thread (track),
span begin/end become "B"/"E" slices, instants "i", counter samples "C"
(the aggregate bw-demand curve renders as a counter track — the live
analogue of the paper's Fig. 6 traffic trace), and flows "s"/"f" (the
PD handoff arrow from the source worker's export to the destination's
import).  Virtual seconds become microsecond timestamps.

Export is deterministic: group→pid assignment follows first appearance
in the (time-ordered) event list, metadata events are emitted in pid
order, and ``write_chrome`` serialises with sorted keys — two identical
virtual-clock runs produce byte-identical files (pinned by
``tests/test_torch_obs.py``).

``validate_chrome`` is the schema gate used by ``tools/trace_export.py
--check`` and CI: required fields per phase, numeric non-negative
monotone timestamps, balanced begin/end per track with matching names,
numeric counter series, and flow ids that pair up.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Sequence, Tuple

_US = 1e6  # virtual seconds -> trace microseconds


def to_chrome(events: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Project tracer events into a Chrome-trace JSON document."""
    pids: Dict[str, int] = {}
    tids: Dict[Tuple[int, Any], int] = {}   # (pid, tracer tid) -> int tid
    tid_names: Dict[Tuple[int, int], str] = {}
    out: List[Dict[str, Any]] = []
    open_slices: Dict[Tuple[int, Any], List[Dict[str, Any]]] = {}
    max_ts = 0.0
    for ev in events:
        group = ev["group"]
        pid = pids.setdefault(group, len(pids) + 1)
        # tracer tids may be strings ("0.decode"); chrome wants ints —
        # assign them per process in first-appearance order (deterministic
        # for a deterministic event list) and label via thread_name
        tkey = (pid, ev["tid"])
        tid = tids.get(tkey)
        if tid is None:
            tid = sum(1 for k in tids if k[0] == pid)
            tids[tkey] = tid
            tid_names[(pid, tid)] = f"{group}.{ev['tid']}"
        ts = ev["t"] * _US
        max_ts = max(max_ts, ts)
        rec: Dict[str, Any] = {"name": ev["name"], "ph": ev["ph"],
                               "ts": ts, "pid": pid, "tid": tid,
                               "args": ev.get("args", {})}
        ph = ev["ph"]
        if ph == "i":
            rec["s"] = "t"
        elif ph in ("s", "f"):
            rec["cat"] = "flow"
            rec["id"] = ev["id"]
            if ph == "f":
                rec["bp"] = "e"   # bind to the enclosing slice's end
        elif ph == "B":
            open_slices.setdefault((pid, tid), []).append(rec)
        elif ph == "E":
            stack = open_slices.get((pid, tid))
            if stack:
                stack.pop()
        out.append(rec)
    # auto-close slices still open at the end of the run (a span in
    # flight when the clock stopped), innermost first so nesting stays
    # balanced for strict validators
    for (pid, tid), stack in sorted(open_slices.items(),
                                    key=lambda kv: (kv[0][0], str(kv[0][1]))):
        for rec in reversed(stack):
            out.append({"name": rec["name"], "ph": "E", "ts": max_ts,
                        "pid": pid, "tid": tid,
                        "args": {"auto_closed": True}})
    meta: List[Dict[str, Any]] = []
    for group, pid in pids.items():
        meta.append({"name": "process_name", "ph": "M", "ts": 0.0,
                     "pid": pid, "tid": 0, "args": {"name": group}})
    for (pid, tid), label in sorted(tid_names.items(),
                                    key=lambda kv: (kv[0][0], str(kv[0][1]))):
        meta.append({"name": "thread_name", "ph": "M", "ts": 0.0,
                     "pid": pid, "tid": tid, "args": {"name": label}})
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


def write_chrome(tracer, path: str) -> Dict[str, Any]:
    """Export ``tracer.events`` to ``path``; returns the document.
    Serialisation is canonical (sorted keys, fixed separators) so equal
    event lists write byte-identical files."""
    doc = to_chrome(tracer.events)
    with open(path, "w") as f:
        json.dump(doc, f, sort_keys=True, separators=(",", ":"))
        f.write("\n")
    return doc


# -- validation ---------------------------------------------------------------

_REQUIRED = ("name", "ph", "ts", "pid", "tid")


def validate_chrome(doc: Any) -> List[str]:
    """Schema-check a Chrome-trace document; returns a list of problems
    (empty == valid).  Checks: top-level shape, required fields, numeric
    non-negative timestamps, globally monotone event order (metadata
    excluded), balanced begin/end per (pid, tid) with matching names,
    numeric counter series, paired flow ids."""
    errs: List[str] = []
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        return ["top level must be an object with a traceEvents list"]
    last_ts = None
    stacks: Dict[Tuple[Any, Any], List[str]] = {}
    flow_open: Dict[Any, int] = {}
    for i, ev in enumerate(doc["traceEvents"]):
        if not isinstance(ev, dict):
            errs.append(f"event {i}: not an object")
            continue
        missing = [k for k in _REQUIRED if k not in ev]
        if missing:
            errs.append(f"event {i}: missing fields {missing}")
            continue
        ts, ph = ev["ts"], ev["ph"]
        if not isinstance(ts, (int, float)) or ts < 0:
            errs.append(f"event {i}: bad ts {ts!r}")
            continue
        if ph == "M":
            continue
        if last_ts is not None and ts < last_ts:
            errs.append(f"event {i}: ts {ts} < previous {last_ts} "
                        "(events must be time-ordered)")
        last_ts = ts
        track = (ev["pid"], ev["tid"])
        if ph == "B":
            stacks.setdefault(track, []).append(ev["name"])
        elif ph == "E":
            stack = stacks.get(track)
            if not stack:
                errs.append(f"event {i}: E '{ev['name']}' on {track} "
                            "with no open B")
            elif stack[-1] != ev["name"]:
                errs.append(f"event {i}: E '{ev['name']}' closes "
                            f"'{stack[-1]}' on {track}")
                stack.pop()
            else:
                stack.pop()
        elif ph == "C":
            args = ev.get("args", {})
            if not args or not all(isinstance(v, (int, float))
                                   for v in args.values()):
                errs.append(f"event {i}: counter '{ev['name']}' needs "
                            "numeric args")
        elif ph == "s":
            flow_open[ev.get("id")] = flow_open.get(ev.get("id"), 0) + 1
        elif ph == "f":
            fid = ev.get("id")
            if flow_open.get(fid, 0) <= 0:
                errs.append(f"event {i}: flow finish id={fid!r} without "
                            "a start")
            else:
                flow_open[fid] -= 1
        elif ph == "i":
            pass
        else:
            errs.append(f"event {i}: unknown phase {ph!r}")
    for track, stack in sorted(stacks.items(), key=str):
        if stack:
            errs.append(f"track {track}: {len(stack)} unclosed B "
                        f"(top '{stack[-1]}')")
    return errs


# -- counter-track reconstruction (bench fidelity) ---------------------------

def trace_bw_segments(doc: Dict[str, Any], *, counter: str = "bw",
                      series: str = "demand",
                      ) -> List[Tuple[float, float, float]]:
    """Rebuild the piecewise-constant bandwidth curve from an exported
    trace: each counter sample holds the value from its timestamp to the
    next sample's, clipped to the [first span begin, last span end]
    range so trailing timer-only segments (outside the metrics overlay)
    are excluded.  Returns (t0, t1, value) in virtual seconds — the same
    shape ``core.timeline.bw_samples`` has, so the bench can integrate
    it with the exact metrics weighting."""
    samples: List[Tuple[float, float]] = []
    lo, hi = None, None
    for ev in doc["traceEvents"]:
        ph = ev.get("ph")
        if ph == "C" and ev.get("name") == counter:
            samples.append((ev["ts"] / _US, float(ev["args"][series])))
        elif ph == "B":
            lo = ev["ts"] / _US if lo is None else min(lo, ev["ts"] / _US)
        elif ph == "E":
            hi = ev["ts"] / _US if hi is None else max(hi, ev["ts"] / _US)
    if not samples or lo is None or hi is None:
        return []
    segs: List[Tuple[float, float, float]] = []
    for (t0, v), (t1, _) in zip(samples, samples[1:] + [(hi, 0.0)]):
        a, b = max(t0, lo), min(t1, hi)
        if b > a:
            segs.append((a, b, v))
    return segs
