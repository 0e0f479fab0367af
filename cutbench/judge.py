"""The comparison that decides ``correct``: what the timed path produced for
a sample of its answers against the plain reference on the same inputs.

Each answer is a voltage vector, a partition (``in_source``) and the cut
value the program reported for it.  The numbers a configuration compares
are those its ``check.limits`` names, of these, per answer in float64:

* ``frac_gap``  — |‖CBx‖₁ − ‖CBx_ref‖₁| / ‖CBx_ref‖₁, the fractional cut;
* ``cut_gap``   — |cut(partition) − cut_ref| / cut_ref, where cut_ref is
  the reference's sweep cut of its own voltages;
* ``prefix_gap`` — max(0, max x over the sink side − min x over the source
  side): 0 where the partition is a sweep cut of the answer's own voltages,
  a set {x ≥ θ} (ties either side), as ``rounding: sweep`` states.  Which
  prefix is best the program decides on float32 prefix sums, whose
  rounding no reference shares: that is left to ``value_gap`` and the
  fractional cut;
* ``value_gap`` — |reported value − cut(partition)| / cut(partition);
* ``stall_res`` — under the fixed schedule: the relative residual, in
  float64, of the system reweighted at the answer's voltages, at those
  voltages, over ``pcg_tol``.

Under the fixed schedule the reference takes, system by system, the PCG
step counts that the program reported (its ``pcg_iters``) in place of its
own stopping rule.  The fixed schedule stalls once a warm start already
meets the tolerance, and a residual within rounding of ``pcg_tol`` decides
where: float32 and float64 may stall one IRLS iteration apart, and their
answers then part by far more than rounding.  Followed, the reference
solves in float64 along the program's decisions.  ``stall_res`` judges
the decision that the answer rests on: where the last system took no
step, the answer is its own warm start, whose residual the program found
within ``pcg_tol``; where the last system stepped it reads 0.  Counts that
are not the schedule's (another number of systems, more steps than the
cap) read infinity.

The widest voltage gap, max |x − x_ref|, is not compared: it swings with
the few voxels near the cut, and in neither cell does the control read
three times what sound runs of the program read.

Over the sample each number is its largest reading, and each is held to
the limit its configuration's ``check`` section states.  A mode adds
numbers of the run's own structure (``checks``), each with its limit.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import reference
from .reference import cut, irls

NUMBERS = ("frac_gap", "cut_gap", "prefix_gap", "value_gap", "stall_res")


def following(config: dict) -> bool:
    """Does the reference follow the program's PCG step counts?  Under the
    fixed schedule, whose stall rounding decides."""
    return not reference.adaptive(config["solver"])


def _counts(solver: dict, counts) -> Optional[list]:
    """``counts`` where they are step counts of the fixed schedule (one per
    system, none above the cap), else None."""
    if counts is None:
        return None
    counts = [int(k) for k in counts]
    if (len(counts) != int(solver["n_irls"]) + 1
            or not all(0 <= k <= int(solver["pcg_max_iters"]) for k in counts)):
        return None
    return counts


def prefix_gap(x, side) -> float:
    """``prefix_gap`` of one answer: its voltages ``x`` and its partition
    ``side`` (True on the source side)."""
    if bool(side.all()) or not bool(side.any()):
        return 0.0
    return max(0.0, float(x[~side].max() - x[side].min()))


def stall_res(solver: dict, counts, record: dict, src, dst, weights,
              x) -> float:
    """``stall_res`` of one answer: its voltages ``x`` (float64), its step
    counts ``counts`` and the followed reference's ``record``."""
    counts = _counts(solver, counts)
    if counts is None or counts != record.get("steps"):
        return float("inf")
    if counts[-1] > 0:
        return 0.0
    g = irls.make_graph(src, dst, *weights, torch.float64, x.device)
    rel = float(irls.stall_residual(g, x[None], float(solver["eps"]))[0])
    return rel / float(solver["pcg_tol"])


def numbers(config: dict) -> List[str]:
    """The numbers ``config`` compares: those its ``check.limits`` names."""
    names = list(config["check"]["limits"])
    unknown = sorted(set(names) - set(NUMBERS))
    if unknown:
        raise KeyError(f"no number {unknown}: known {list(NUMBERS)}")
    if "stall_res" in names and not following(config):
        raise ValueError("stall_res judges the fixed schedule's step "
                         "counts")
    return names


def readings(src, dst, weights, answers, refs, device,
             config: dict) -> Dict[str, float]:
    """The largest reading of each of ``config``'s numbers over the
    answers.  ``weights``: (c, cs, ct) per answer; ``answers``: dicts with
    ``voltages``, ``in_source``, ``cut_value`` (and ``pcg_iters``);
    ``refs``: ``reference_answers``' (voltages, in_source, value, record)
    per answer."""
    src_t = torch.as_tensor(np.asarray(src)).to(device=device, dtype=torch.int64)
    dst_t = torch.as_tensor(np.asarray(dst)).to(device=device, dtype=torch.int64)
    names = numbers(config)
    out = {k: 0.0 for k in names}
    for w, a, (x_ref, _, cut_ref, record) in zip(weights, answers, refs):
        c, cs, ct = (torch.as_tensor(np.asarray(v, dtype=np.float64),
                                     device=device) for v in w)
        x = torch.as_tensor(np.asarray(a["voltages"], dtype=np.float64),
                            device=device)
        xr = torch.as_tensor(x_ref, device=device)
        side = torch.as_tensor(np.asarray(a["in_source"], dtype=bool),
                               device=device)
        f = cut.fractional_cut(src_t, dst_t, c, cs, ct, x)
        f_ref = cut.fractional_cut(src_t, dst_t, c, cs, ct, xr)
        true = cut.cut_value(src_t, dst_t, c, cs, ct, side)
        gaps = {
            "frac_gap": lambda: abs(f - f_ref) / f_ref,
            "cut_gap": lambda: abs(true - cut_ref) / cut_ref,
            "prefix_gap": lambda: prefix_gap(x, side),
            "value_gap": lambda: abs(float(a["cut_value"]) - true) / true,
            "stall_res": lambda: stall_res(config["solver"],
                                           a.get("pcg_iters"), record,
                                           src_t, dst_t, (c, cs, ct), x),
        }
        for k in names:
            v = gaps[k]()
            out[k] = max(out[k], v if np.isfinite(v) else float("inf"))
    return out


def verdict(got: Dict[str, float], limits: Dict[str, float],
            checks: Optional[Dict[str, dict]] = None):
    """(all within their limits, {name: {"value", "limit"}}): the numbers
    above, and the mode's own ``checks`` with the limits they carry."""
    compared = {k: {"value": got[k], "limit": float(limits[k])}
                for k in got}
    compared.update(checks or {})
    ok = all(v["value"] <= v["limit"] for v in compared.values())
    return ok, compared


def reference_answers(config: dict, src, dst, items: Sequence[dict],
                      labels=None, dtype=torch.float64, device="cuda",
                      follow: bool = True) -> List[tuple]:
    """``reference.solve`` over the sampled items, grouped by their warm
    start (``x0``: None, or the voltages the program's warm store held).
    Where ``following`` (and ``follow``) each item's reference takes the
    step counts of its ``pcg_iters`` (its own where they are not the
    schedule's)."""
    solver = config["solver"]
    refs: List[tuple] = [None] * len(items)
    groups: Dict[int, list] = {}
    for i, it in enumerate(items):
        groups.setdefault(id(it.get("x0")), []).append(i)
    for idx in groups.values():
        x0 = items[idx[0]].get("x0")
        counts = None
        if follow and following(config):
            counts = [_counts(solver, items[i].get("pcg_iters")) for i in idx]
        got = reference.solve(solver, config["driver"], src, dst,
                              [items[i]["weights"] for i in idx],
                              labels=labels, x0=x0, dtype=dtype, device=device,
                              follow=counts)
        for i, r in zip(idx, got):
            refs[i] = r
    return refs


def control_answers(config: dict, src, dst, items: Sequence[dict], labels,
                    dtype, device) -> List[dict]:
    """The control: the reference in ``dtype`` put in the program's place,
    on its own stopping rule.  Its answers in the program's form, the cut
    value the program's way (of the partition, in float64), with the step
    counts it took."""
    got = reference_answers(config, src, dst, items, labels=labels,
                            dtype=dtype, device=device, follow=False)
    out = []
    for it, (x, side, _, record) in zip(items, got):
        c, cs, ct = (torch.as_tensor(np.asarray(v, dtype=np.float64),
                                     device=device) for v in it["weights"])
        s = torch.as_tensor(side, device=device)
        value = cut.cut_value(
            torch.as_tensor(np.asarray(src)).to(device=device, dtype=torch.int64),
            torch.as_tensor(np.asarray(dst)).to(device=device, dtype=torch.int64),
            c, cs, ct, s)
        out.append({"voltages": x, "in_source": side, "cut_value": value,
                    "pcg_iters": record.get("steps")})
    return out
