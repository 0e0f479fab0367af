"""Cut-tree subsystem: all-pairs min cut from n−1 batched pair solves.

The solver stack amortizes everything per TOPOLOGY (partitions, plans,
compiled steppers — ``topology_fingerprint`` excludes weights) and keeps
terminals in the weight vectors, so rebinding the cut pair is just a weight
change.  This package turns that into an all-pairs workload:

    pairs.py     — ``pin_pair`` terminal rebinding (one-hot ``c_s``/``c_t``)
    gusfield.py  — ``build_cut_tree``: wave-scheduled Gusfield construction
                   driving ``MinCutSession.solve_batch`` (IRLS, batched,
                   pow2-padded) or the exact Dinic oracle; optional exact
                   certify/refine of IRLS-built trees
    repair.py    — ``repair_cut_tree``: replay the recorded construction
                   under drifted edge weights, re-solving only the tree
                   edges whose stored cut can't be proven still optimal
    tree.py      — ``CutTree``: path-minimum pair queries, global min cut,
                   certified partitions, JSON serialization

Serving: ``repro_torch.serve.CutTreeService`` caches finished trees per
topology.  CLI: ``python -m repro_torch.launch.cut_tree``.

The port of the JAX package's ``repro.cuttree``: the same functions and
tree JSON, with a ``device`` where a function makes its own session
(``"cuda"`` by default; the IRLS pair solves run there).
"""
from .gusfield import DEFAULT_CFG, build_cut_tree, build_gomory_hu
from .pairs import graph_cut_value, pin_pair, pin_pairs
from .repair import repair_cut_tree
from .tree import CutTree, pack_side
