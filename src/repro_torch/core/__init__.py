"""PIRMCut core on PyTorch: the session API, the IRLS driver and rounding.

Public API:
    Problem, MinCutSession, SolveResult, Weights — the session API
    IRLSConfig, solve            — the IRLS driver (Algorithm 1, steps 2-5)
    sweep_cut, two_level         — rounding (step 7; rounding.REGISTRY)
    max_flow, min_cut_value      — exact serial oracle (host Dinic)
    pirmcut                      — Algorithm 1 end to end
    cheeger_lambda2, phi_of_cut  — Thm 2.7 diagnostic
"""
from .incidence import DeviceGraph, device_graph_from_instance
from .irls import IRLSConfig, IRLSDiagnostics, solve, solve_scanned
from .maxflow import MaxFlowResult, max_flow, min_cut_indicator, min_cut_value
from .rounding import RoundingResult, round_voltages, sweep_cut, two_level
from .session import (MinCutSession, Problem, SolveResult, Weights,
                      as_weights, rebind_terminals, topology_fingerprint)
from .cheeger import CheegerEstimate, cheeger_lambda2, phi_of_cut


def pirmcut(instance, cfg: IRLSConfig = IRLSConfig(), rounding: str = "two_level",
            labels=None, backend: str = "host", device="cuda"):
    """Algorithm 1 (PIRMCut) end to end: IRLS voltages → rounding → cut.

    One-shot wrapper over ``MinCutSession`` on ``device``; ``rounding`` is
    any name in ``rounding.REGISTRY`` and ``labels`` an optional partition
    for the block-Jacobi preconditioner.  Returns (RoundingResult, voltages,
    IRLSDiagnostics)."""
    n_blocks = cfg.n_blocks if cfg.precond == "block_jacobi" else 1
    prob = Problem.build(instance, n_blocks=n_blocks, labels=labels)
    res = MinCutSession(prob, cfg, backend=backend,
                        device=device).solve(rounding=rounding)
    return res.cut, res.voltages, res.diagnostics
