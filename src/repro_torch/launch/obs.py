"""Observability dashboard CLI — tail a JSONL span sink, render live.

  # one-shot summary (flamegraph-style span tree + per-name table)
  PYTHONPATH=src python -m repro_torch.launch.obs out.jsonl

  # live dashboard: re-render every --interval seconds as spans arrive
  PYTHONPATH=src python -m repro_torch.launch.obs out.jsonl --follow

Reads the sink format ``repro_torch.obs.trace`` writes (one JSON span per
line; produce one with ``mincut_serve --trace out.jsonl`` or
``repro_torch.obs.configure(jsonl="out.jsonl")``).  Exits nonzero when the
file holds no spans (usable as a smoke gate).
"""
from __future__ import annotations

import argparse
import sys
import time


def _render_all(spans, top: int, sort=None) -> str:
    from ..obs import dashboard

    agg = dashboard.aggregate(spans)
    names = dashboard.span_names(spans)
    total = sum(d["total_s"] for p, d in agg.items() if ">" not in p)
    head = (f"spans: {len(spans)}   names: {len(names)}   "
            f"root wall: {total * 1e3:.1f}ms")
    subsystems = sorted({n.split(".", 1)[0] for n in names})
    lines = [head, f"subsystems: {', '.join(subsystems)}", ""]
    lines.append(dashboard.render(agg, top=top, sort=sort))
    errs = [s for s in spans if s.get("error")]
    if errs:
        lines.append(f"\n{len(errs)} span(s) closed by exception, e.g. "
                     f"{errs[-1]['name']}: {errs[-1]['error']}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="JSONL span sink to read")
    ap.add_argument("--follow", "-f", action="store_true",
                    help="keep tailing the sink and re-render")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="follow-mode refresh period, seconds")
    ap.add_argument("--top", type=int, default=30,
                    help="max span paths in the tree view")
    ap.add_argument("--sort", choices=("self", "p99", "count"), default=None,
                    help="flatten the tree and rank paths by this column "
                         "(default: tree layout by root total time)")
    args = ap.parse_args(argv)

    from ..obs import dashboard

    spans, offset = [], 0
    try:
        spans, offset = dashboard.load_spans(args.path, 0)
    except FileNotFoundError:
        if not args.follow:
            print(f"no such sink: {args.path}", file=sys.stderr)
            return 1
    if not args.follow:
        if not spans:
            print(f"{args.path}: no spans", file=sys.stderr)
            return 1
        print(_render_all(spans, args.top, args.sort))
        return 0

    try:
        while True:
            try:
                new, offset = dashboard.load_spans(args.path, offset)
                spans.extend(new)
            except FileNotFoundError:
                pass
            sys.stdout.write("\x1b[2J\x1b[H")   # clear + home
            print(_render_all(spans, args.top, args.sort) if spans
                  else f"waiting for spans in {args.path} ...")
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    return 0 if spans else 1


if __name__ == "__main__":
    sys.exit(main())
