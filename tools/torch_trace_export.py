"""Inspect and validate the port's exported Chrome-trace files.

The PyTorch port's counterpart of ``tools/trace_export.py`` (which reads
through the JAX package): ``repro_torch.launch.serve --trace PATH`` and
``repro_torch.launch.cluster --trace PATH`` write Chrome Trace Event
Format JSON (load it at https://ui.perfetto.dev or chrome://tracing).
This tool checks those files without a browser, importing nothing but the
port:

  python tools/torch_trace_export.py trace.json           # summarize
  python tools/torch_trace_export.py --check trace.json   # validate, exit
                                                          # != 0 on errors

``--check`` runs ``repro_torch.obs.validate_chrome`` over every file —
required fields, monotone timestamps, balanced begin/end slices per
track, numeric counter series, paired flow ids — and exits non-zero
listing every problem.  Without ``--check`` it prints a per-file summary:
event counts by phase, tracks, time span, and the bandwidth counter
track's sample count.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path

# run from a checkout without installing: put src/ on the path
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.obs import trace_bw_segments, validate_chrome  # noqa: E402


def load(path: str):
    with open(path) as f:
        return json.load(f)


def summarize(path: str, doc) -> None:
    evs = doc.get("traceEvents", [])
    phases = Counter(ev.get("ph") for ev in evs if isinstance(ev, dict))
    tracks = {(ev.get("pid"), ev.get("tid")) for ev in evs
              if isinstance(ev, dict) and ev.get("ph") != "M"}
    ts = [ev["ts"] for ev in evs
          if isinstance(ev, dict) and ev.get("ph") != "M"
          and isinstance(ev.get("ts"), (int, float))]
    segs = trace_bw_segments(doc)
    span = (max(ts) - min(ts)) / 1e6 if ts else 0.0
    print(f"{path}: {len(evs)} events, {len(tracks)} tracks, "
          f"{span:.6f} virtual s")
    print("  phases: " + ", ".join(f"{ph}={n}" for ph, n
                                   in sorted(phases.items())))
    print(f"  bw counter: {len(segs)} segments")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="+", help="exported trace JSON file(s)")
    ap.add_argument("--check", action="store_true",
                    help="validate schema; exit non-zero on any problem")
    args = ap.parse_args(argv)
    bad = 0
    for path in args.paths:
        try:
            doc = load(path)
        except (OSError, json.JSONDecodeError) as e:
            print(f"{path}: unreadable: {e}", file=sys.stderr)
            bad += 1
            continue
        if args.check:
            errs = validate_chrome(doc)
            if errs:
                bad += 1
                print(f"{path}: INVALID ({len(errs)} problem(s))")
                for e in errs:
                    print(f"  {e}")
            else:
                n = len(doc.get("traceEvents", []))
                print(f"{path}: OK ({n} events)")
        else:
            summarize(path, doc)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
