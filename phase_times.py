"""Times ``chip_smoke.py``'s phases 11c, 11d, 12 and 13c at chosen sizes on
one card, with their checks, so that the smoke run's sizes can be picked
to fit its time limit without a whole run.

    python3 phase_times.py [--tree-sides 24 28] [--route-side 6]
                           [--exact-side 8] [--road-side 512] [--out FILE]

It builds the kernels, then runs, each in a ``try`` (a failed check is
logged with its traceback and recorded, and the rest still runs):

- the four CLIs of ``chip_smoke.cli_runs`` side by side (the solve and
  mincut_serve CLIs, the cut_tree CLI at ``--exact-side``, the sharded
  solve CLI), then the checks of phases 11d and 13c on their output;
- 12b at ``--route-side``, 12c at ``--exact-side``, 12a at each of
  ``--tree-sides`` and 12d on 12c's instance;
- 11c at ``--road-side``.

Each step's seconds and whether its checks held go to ``--out`` (JSON,
``chiprun_out/phase_times.json`` by default) and to the last line.  Like
the smoke run, it exits non-zero without a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree-sides", type=int, nargs="+", default=[24, 28])
    ap.add_argument("--route-side", type=int, default=6)
    ap.add_argument("--exact-side", type=int, default=8)
    ap.add_argument("--road-side", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "phase_times.json"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("phase_times: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.kernels import build

    build.build_all()
    out_path = Path(args.out)
    out_dir = out_path.parent / "phase_times"
    out_dir.mkdir(parents=True, exist_ok=True)
    cs.EXACT_SIDE = args.exact_side
    rec = {"card": cs.card_line(), "args": vars(args)}

    def timed(name, fn):
        t = time.perf_counter()
        try:
            got, ok = fn(), True
        except Exception:
            traceback.print_exc()
            got, ok = None, False
        rec[name] = dict(ok=ok, seconds=time.perf_counter() - t)
        cs.log(f"[phase_times] {name}: checks held {ok}, "
               f"{rec[name]['seconds']:.1f} s")
        out_path.write_text(json.dumps(rec, indent=1, default=str))
        return got

    clis = timed("clis side by side", lambda: cs.finish_clis(
        cs.start_clis(cs.cli_runs(out_dir), out_dir)))
    if clis is not None:
        rec["cli_seconds"] = {k: v["seconds"] for k, v in clis.items()}
        timed("11d checks", lambda: cs.cli_phase(clis, out_dir))
        timed("13c checks", lambda: cs.sharded_cli_phase(
            clis["solve_sharded"], out_dir))
    timed(f"12b at side {args.route_side}",
          lambda: cs.cuttree_route_phase(args.route_side, args.seed))
    ctx = timed(f"12c at side {args.exact_side}",
                lambda: cs.cuttree_exact_phase(args.exact_side, args.seed))
    sink = None
    for side in args.tree_sides:
        got = timed(f"12a at side {side}", lambda: cs.cuttree_build_phase(
            side, args.seed, out_dir))
        if got is not None:
            sink = got["sink"]
            rec[f"12a at side {side}"].update(
                build_s=got["wall_s"], n_solves=got["meta"]["n_solves"],
                verify_max_rel=got["verify_max_rel"])
    if ctx is not None and sink is not None and clis is not None:
        timed(f"12d at side {args.exact_side}",
              lambda: cs.cuttree_service_phase(ctx[1], args.seed, sink,
                                               out_dir, clis["cut_tree"]))
    timed(f"11c at side {args.road_side}",
          lambda: cs.presolve_phase(args.seed, side=args.road_side))
    out_path.write_text(json.dumps(rec, indent=1, default=str))
    cs.log(json.dumps(rec, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
