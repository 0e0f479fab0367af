#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--side 96] [--n-irls 50] [--seed 0]
                          [--frame 1024] [--ell-side 48] [--tree-side 24]

Phases (any failure raises and exits non-zero; there is no CPU path):

1. Build the five CUDA kernels from ``src/repro_torch/kernels/csrc`` with
   nvcc for sm_90a (one nvcc per source, all started together), keep the
   ptxas lines (registers, spills) and the SASS loops' instruction counts
   of the five kernels redesigned for Hopper (``flash_fwd``, ``ell_spmv``,
   ``block_diag_matvec``, ``fused_ell_sweep``, ``edge_reweight``; the last
   three must not spill) and count the HGMMA instructions in the attention
   kernel's SASS (there must be some), and print the card's name and power
   limit.
2. Make the full-width instance: a 26-connected ``side``³ segmentation grid
   (the repo's grid3d family, the shape of the paper's UWO MRI volumes)
   with 8×8×8 voxel boxes as the block-Jacobi partition.
3. Kernels alone: each kernel's wrapper on card tensors at the shapes the
   main path gives it (the instance's ELL plan and block plan, values drawn
   from a seeded ``torch.Generator``), held against its plain PyTorch
   version, entry by entry against the entry's own scale, then timed with
   CUDA events beside the plain version, its bound and one PyTorch library
   call computing the same function where there is one.  Logged: the share
   of its bound of ``ell_spmv`` (and its time over the CSR call),
   ``fused_ell_sweep`` and ``block_diag_matvec``; the last is timed in
   turns with ``torch.bmm``, three times each, and its ``ms`` and
   ``library_ms`` are the medians, whose ratio is logged.
4. The main path: ``pirmcut``'s two steps (``Problem.build``, then
   ``MinCutSession.solve``, whose timings give the setup, IRLS and rounding
   seconds) with the kernel config on the card, launch counters set to 0
   just before and read just after.  Every kernel must have launched,
   exactly as often as the PCG trace says; voltages must be finite.
   Rounded with the sweep cut: the paper's two-level rounding ends in a
   host Dinic whose contour is ~25% of the voxels here (minutes of Python
   at this size).
5. The same solve on the plain path (``use_pallas=False``, on the card) must
   reach the same cut within rel 1e-4, with each IRLS iteration's PCG count
   within two steps of the kernel path's.
6. Two-level rounding at side 32 (kernel path vs plain path, rel 1e-6) and
   at side 16 against the exact min cut of the host Dinic (rel 1e-6).
7. ``edge_reweight`` alone at the COO shapes of the 96³ instance, one
   instance (B = 1) and a serving batch (B = 8), and of phase 8's 2-D frame
   (B = 8), with 16 endpoints out of range (they gather 0) inside the
   vector variant's groups of 4 edges, held entry by entry against the
   plain version (bit for bit) and timed beside it and its bound: back to
   back (``ms``) and by device time in a CUDA graph (``graph_ms``), each
   shape's share of its bound logged.
8. The serving path: ``MinCutServer`` (the server's default config with
   ``use_pallas``, sweep rounding, 4 workers, idle flush, ``max_batch`` 8)
   serves two tenants at full width — the 96³ volume and a 1024×1024
   4-connected segmentation frame — in bursts of 8 drifting weight
   assignments (``launch/mincut_serve.py``'s random walk, drift 0.05), the
   first burst of each tenant cold and the later ones warm.  It runs twice.
   The measured run keeps PyTorch's defaults, as a user runs the server:
   its times and memory are the phase's numbers, and its cuts stay within
   1e-2 of the plain path's.  Its first (cold) volume batch is served
   again by a fresh server, also with PyTorch's defaults: voltages, cuts
   and sides bit-equal (the COO scatters and the sweep rounding sum in a
   fixed order, with no atomics), the batch's wall logged.  The checked
   run serves the same traffic with
   ``torch.use_deterministic_algorithms(True)``: every served cut must
   equal, within rel 1e-4, the cut of the same batch solved through
   ``solve_batch`` on the plain path on the card, with the same warm start,
   and one lane of a batch of 8 must give the cut of its weights solved
   alone (rel 1e-4).  In both runs the launch counters are set to 0 just
   before and read just after: ``edge_reweight`` must have launched once per
   IRLS iteration of every batch, and no other kernel.  A small server with
   two-level rounding runs at side 32 in the checked run.  Last, one
   batch of the volume is traced with ``torch.profiler``: its kernels'
   device time by name and the device's busy share.
9. The batched ELL path: ``solve_batch`` on B = 4 lanes of a 48³ grid in the
   kernel config of phase 4 (block plan of 8×8×8 boxes, the default fixed
   schedule), with the batched ``ell_spmv``/``fused_ell_sweep`` and
   ``block_diag_matvec`` on the B lanes' [B·P, bs, bs] inverses held against
   their plain versions first, as in phase 3 (``ell_spmv`` also timed
   beside the B lanes as one block-diagonal CSR ``torch.mv``,
   ``block_diag_matvec`` in turns with ``torch.bmm``; each one's share of
   its bound logged; the batched ``ell_spmv`` and ``fused_ell_sweep``,
   whose launches are about as short as their wrappers' host work, timed
   back to back as everywhere, and by device time in a CUDA graph beside);
   the launches must be the fixed schedule's,
   and the cuts the plain path's within rel 1e-4 (the schedule's CG steps
   past convergence amplify the kernels' other summation orders into cut
   gaps of a few 1e-5; fewer IRLS iterations leave the voltages less
   polarized and the gaps larger).
10. LM serving: ``flash_fwd`` alone at the prefill's shapes (4 × 4096
    tokens, qwen2-1.5b's 12 query and 2 KV heads, D = 128, bf16, causal)
    and at a smaller float32 non-causal shape, in the model's [B, S, H, D]
    layout read in place (the 3-D [B·H, S, D] call on the regrouped tensors
    must give the same bytes), each entry held against the dense plain
    version at its own scale, timed in both layouts beside the plain
    version, ``scaled_dot_product_attention``, its bound (TFLOP/s and share
    logged) and the layer's call.  Then the path:
    ``launch.lm_serve.serve`` of qwen2-1.5b at full width (random weights
    from a seeded generator on the card, ``use_pallas_attention``) on 4
    prompts of 4096 synthetic tokens, 64 greedy tokens each: ``flash_fwd``
    must launch once per layer in prefill and never in decode.  The same
    prefill on the plain path (the blockwise attention, on the card) must
    give the same last-position logits within 5e-2 of max |logits| and the
    same first token wherever its top-2 margin exceeds twice the measured
    logit gap.  Last, one prefill and 8 decode steps are traced with
    ``torch.profiler``: device time by kernel and the device's busy share.

11. Delta staging, presolve and the CLIs, at full width.
    a. The host solve of phase 4 (the 96³ volume, the kernel config) under
       ``delta_key``: a cold solve, then 1% of the edges drifted (lognormal
       σ = 0.05, the reference CLI's ``--drift-sparsity 0.01 --drift
       0.05``) must stage as ``delta`` with that many changed edges, give
       the voltages (``np.array_equal``) and cut of the same solve with no
       key, and launch the three ELL kernels as often as its PCG trace
       says; the staged table must equal a full restage (``torch.equal``).
       Under deterministic algorithms.  Logged: delta and full staging ms,
       the delta map's build time and bytes, the table's bytes per key.
    b. Serving: a ``MinCutServer`` in phase 8's config on the fused-ELL
       path (``layout="ell"``, point Jacobi) serves the volume and the
       1024² frame, 3 bursts of 8 per tenant, every request drifting 1% of
       its tenant's edges and naming its tenant: solves/s, per-request IRLS
       share and batch wall, modes per tenant (one ``cold``, the rest
       ``delta``), peak memory.  Checked under deterministic algorithms:
       keyed ``solve_batch`` at B = 8 bit-equal to keyless; a one-worker
       server without warm starts gives tenant requests the bits of the
       same requests without a tenant; a 30% drift stages ``full``.
    c. Presolve on the road family at side 512 (n = 262,144) in 11b's
       config, host backend: kernel size, kernelize seconds and launches
       (as the PCG trace says); the certificate exact (rel_gap 0) and the
       cut its lifted cut; the lifted cut within rel 1e-3 of the solve
       without presolve.  A keyed sequence (rebuild, then patches of 0.1%
       drifts among the edges additive into kernel edges), the lifted cuts
       certified; a random 0.1% drift probed against revalidation.
       ``solve_batch(presolve=True)`` of 2 weight vectors (×1, ×1.5) within rel
       1e-3 of the unpresolved batch, or, where the adaptive schedule stops
       the unpresolved lane above the min cut, the presolved lane within
       rel 1e-6 of exact Dinic; at side 128 in tests/test_presolve.py's
       STRONG config (fused ELL, kernels) within rel 1e-6 of exact Dinic.
       Rounded two-level.
    d. ``launch.solve --family road --side 256 --irls 20`` (delta_two_level
       ≤ 1e-3) and ``launch.mincut_serve --warm --presolve --drift-sparsity
       0.05`` (every request completed) as subprocesses, their JSON read.
       They run side by side with 12d's ``launch.cut_tree``, 13c's
       ``launch.solve --backend sharded`` and 18c's two ``launch.train``
       runs (each phase checks its own), and the run waits for all six
       before it goes on.

12. Cut trees, through ``edge_reweight`` (the cut-tree default config with
    ``use_pallas``: one launch per IRLS iteration of every ``solve_batch``
    call, checked for every IRLS build and repair below).
    a. ``build_cut_tree`` of the cut_tree CLI's ``--family grid --side 24``
       (n = 576, m = 1,104) in batches of up to 64 pair solves, traced
       to a JSONL sink: build seconds, solves, waves, discarded
       speculation, pairs/s; the global min cut, 10,000 random pair queries
       (µs each) and 25 of them against the exact Dinic cut (rel 1e-3, the
       CLI's ``--verify-rtol``); the sink rendered by ``obs.dashboard``
       with the build's wall split into batched solves (IRLS, rounding)
       and host work; 2 IRLS iterations of a 64-pair wave profiled;
       ``edge_reweight`` alone at B = 64 over the grid, bit for bit and
       timed as in phase 7.
    b. At side 6 in batches of up to 8, under deterministic algorithms,
       builds on the kernel route, the plain route and the kernel route
       again: the three trees equal (parent, weight, stored sides,
       acceptance order).
    c. At side 8, where Dinic is cheap: the exact tree; Gomory–Hu (all
       pairs at the exact tree's, rel 1e-9); a 1% drift (σ 0.05) repaired
       exactly (rel 1e-9 of a fresh exact build, some edges reused) and by
       IRLS in tests/test_drift.py's strong config (rel 1e-6).
    d. ``CutTreeService`` (IRLS, refined) on 12c's instance: the first
       query builds, and a fresh service builds the same tree again (equal
       parent, weight, sides and acceptance order: no atomics on the
       path); every tree edge at its pair's Dinic cut (rel 1e-9), every
       pair at most its exact cut (the pairs more than 1e-3 below it
       logged), the global min cut within rel 1e-3; the next 1,000 hit the
       cache, the drift is ``"repaired"`` (rel 1e-9 of the fresh build),
       the same weights again ``"unchanged"``; then ``launch.cut_tree
       --side 8 --solver irls --refine --verify-pairs 25``
       (verify_max_rel ≤ 1e-3; run in 11d) and ``launch.obs`` on 12a's
       sink as subprocesses.

13. The sharded solver (``distributed.solver.ShardedSolver``).
    a. A world of one over NCCL (the solver initializes it) at full width:
       phase 4's 96³ instance, labels and kernel config at 10 IRLS
       iterations, on three routes — halo with the fused sweep (through
       ``fused_ell_sweep``), halo unfused and psum (through
       ``edge_reweight``) — each on the kernel route and the plain route
       under deterministic algorithms: cuts within rel 1e-5 of each other
       and 1e-3 of phase 4's host cut, one launch of the route's kernel per
       IRLS iteration and no other, the collectives per CG step as the CPU
       tests hold them; setup and solve walls, CG steps, bytes per step.
       Then 13b's 48³ instance at world one, rounded two-level.
    b. A world of four spawned ranks on the one card at 48³ (gloo over
       CUDA tensors, checked first: NCCL takes one rank a card), both
       schedules and the int8 halo: cuts equal to 13a's world one (rel
       1e-5, two-level), launches and collectives per CG step as in 13a,
       the int8 halo under 0.4× the halo's bytes and the halo under 0.7×
       psum's, each rank's kernels held at its shard's shapes.
    c. ``launch.solve --backend sharded`` as a subprocess (world of one;
       run in 11d).

14. MoE serving at full width, phase 10's traffic (4 prompts of 4096
    tokens, 64 greedy tokens), one arch at a time on the card.
    a. ``flash_fwd`` alone, as in phase 10a, at llama4-maverick's attention
       shape: 40 query heads over 8 KV heads of 128 (G = 5).
    d. ``moe_layer`` at one layer's shapes of each arch (llama4: E = 128,
       top-1, d_ff 8192; mixtral: E = 8, top-2, d_ff 16384) on 16,384
       seeded tokens: 64 sampled tokens held against a float32 per-token
       reference (8 bf16 roundings of each entry's scale), the dropped
       entries equal to a host recount from the top ids and C, rows of
       fully dropped tokens 0; ``moe_layer_grouped`` in 8 groups against
       ``moe_layer`` at capacity ≥ T on 2,048 tokens.
    b. llama4-maverick (d_model 5120, 128 experts top-1 and the shared
       expert, vocab 202,048) at depth 2 of 48 (67.3 GB of bf16 weights)
       through ``serve`` with ``use_pallas_attention``: ``flash_fwd`` once
       per layer in prefill and never in decode; prefill, decode and its
       bound (every weight read a step), peak memory; kernel vs plain
       attention path with the routes recorded: each layer's share of
       routes that differ, the last-position logits within 5e-2 of max
       |logits| on the lanes whose last token took the same experts in
       every layer (at least 2 of 4), greedy-token agreement; profiles of
       the prefill and 4 decode steps.
    c. mixtral-8x22b (d_model 6144, 8 experts top-2, window 4096) at depth
       4 of 56 (20.4 GB): no launch (its layers are all windowed and stay
       on the banded path, as in the reference); the decode runs to
       position 4158 through the wrapped ring caches, and its last logits
       are held against a fresh forward over the prompt and the generated
       tokens on the same held-lanes rule.

15. The sharded server and the perf gate.
    a. ``MinCutServer(backend="sharded")`` in a world of one over NCCL at
       full width: 13a's 96³ instance, phase 4's labels (registered with
       the topology) and kernel config at 10 IRLS iterations, the fused
       halo schedule, one batch a request.  One tenant's burst of 4: the
       undrifted weights, then 3 drifts of 1% of the edges (σ 0.05):
       every served cut within rel 1e-5 of the session's own sharded
       solve of the same weights, the first within rel 1e-5 of 13a's
       fused-halo cut; ``fused_ell_sweep`` once per IRLS iteration of
       every request and no other launch; 4 ``sharded_excluded`` warm
       lookups; wall, solves/s and the delta refill's counts.
    b. The sharded server over four spawned ranks on the one card (gloo
       over CUDA tensors, 13b's spawn, a timeout on every rank): rank 0
       serves a burst of 4 at 48³ in the server's default config with
       ``use_pallas`` and the halo sweep unfused (the build that runs
       ``edge_reweight`` on each shard), ranks 1–3 run ``follow_sharded``.
       The served two-level cuts equal a world-one sharded session's on
       the same weights (rel 1e-5); ``edge_reweight`` once per IRLS
       iteration a rank; every follower leaves its loop on shutdown.
    c. The perf gate: phase 4's host solve with ``profile=True`` on the
       kernel route and the plain route: the same count (the terms, and
       the totals at each route's PCG trace), at most 1.05× the card's
       HBM rate and a roofline fraction in (0, 1.05], each term beside
       the kernel table's bound (rel 1e-6); two payloads (15a's serving,
       this solve; ``obs.bench_snapshot()`` under ``"obs"``) into a
       history under ``chiprun_out/``, and ``launch.bench_diff
       --from-payload`` as a subprocess: exit 0 with 0 regressed on an
       unchanged rerun, exit 1 on 15a's payload with its wall doubled.

16. LM training (no kernel: the reference trains through none; every
    kernel's launch count must stay 0 on this path).
    a. The flash backward at training shapes in bf16: qwen2-1.5b's
       attention ([2, 4096, 12, 128] over 2 KV heads, causal, chunks
       512/1024) and one gemma3-27b local layer (32/16 heads, B = 1,
       window 1024 at S 4096: the banded path).  ``FlashAttention``'s
       recomputing backward against autograd through the plain forward
       (no custom backward): dq, dk and dv within 1e-2 of their own max;
       both backward times (CUDA events) and both peak memories, the
       recomputing one's below.
    b. ``build_train_step(lm_loss, AdamWConfig())`` on qwen2-1.5b at full
       width and 14 of its 28 layers (remat; the run's time cut the depth)
       over ``TokenStream(vocab, 4, 4096)``: a warm-up step, the same step
       in 2 microbatches from the same state (loss within rel 1e-3,
       grad_norm within rel 2e-2, gradient within 5e-2 of its norm), the
       first half of the batch alone (logged: how far a gradient missing
       half the batch lands), then 3 timed steps from that state again (s
       a step, tok/s, peak memory, each step's loss, grad_norm and lr; all
       finite, the first loss within 25% of ln V);
       ``use_pallas_attention=True`` under grad raises.
    c. ``TrainController`` at full width and depth 2 (~3.3 GB of state):
       run A 4 steps checkpointed every 2; run B 2 steps, then a fresh
       controller resumes on its default device, the card, and takes 2
       more: restored leaves bit-equal to
       B's state, B's losses at steps 3–4 within rel 1e-3 of A's; B's
       resume (the restore), a sync save and an async save of A's state
       timed; one step at this depth profiled (device time by kernel, busy
       share).
    d. ``launch.train --reduced --steps 6 --ckpt-every 3`` on the card,
       then ``--steps 9``: the journal shows ``resumed`` at step 6.

17. LM sharding (``models/sharding``, the sharded transformer, the grouped
    MoE dispatch, ``train/pipeline``, the elastic restore).
    a. ``lm_rules(make_host_mesh((1, 1)))``: a world of one over NCCL,
       qwen2-1.5b at full width and 2 of its 28 layers: the sharded
       ``lm_loss`` against the unsharded one (rel 1e-3), the sharded
       prefill through ``flash_fwd`` and 4 decode steps' logits against the
       unsharded ones (5e-2 of max |logits|).
    b. The unsharded references on the card (3 train steps of
       ``AdamWConfig()``, B = 4, S = 4096 (the train_4k cell's), remat;
       the prompt's prefill and
       16 greedy decode steps; mixtral's MoE layer by the one-rank
       ``moe_layer_grouped(n_groups=2)``), then four spawned ranks on the
       one card (gloo over CUDA tensors, ``run_ranks``; an ok flag
       all-reduced after each step): the redistribute matrix (all-reduce,
       all-gather, reduce-scatter, all-to-all, P2P; the port stages through
       host copies the ops gloo refuses on CUDA tensors, which
       ``gloo_native_probe`` finds), ``flash_fwd`` at a model rank's local
       heads ([2, 1024, 6, 128] over 1 KV head) against its plain version,
       the sharded prefill on (data 2, model 2) through ``flash_fwd`` (its
       launches: one a layer a rank) and 16 decode steps on the sharded
       caches fed the unsharded greedy tokens (logits within 5e-2 of max
       |logits|); split-KV: the prompt's first row alone (a batch of 1
       does not split over data 2, so the caches' sequence does, as
       ``long_500k``'s), its prefill and 16 decode steps against the
       unsharded run's first row (5e-2 of max |logits|), the caches' blocks
       over the sequence, no all-gather over data and three all-reduces
       over data a layer a step (the softmax's max, its sum, the output),
       then 3 train steps (losses within rel 1e-3, grad_norm
       within 2e-2 of the unsharded run's; bytes a rank by op and mesh
       dim).
    c. The same ranks on (pod 2, model 2): the GPipe loss of the first
       batch in 4 microbatches and one step (loss within rel 1e-3 of the
       unsharded ``lm_loss``, grad_norm within 2e-2).
    d. mixtral-8x22b's MoE layer at full width (d_model 6144, 8 experts
       top-2, d_ff 16,384), 2 groups of 4096 tokens over data 2 (EP over
       data by an all-to-all, TP over model): routes equal to the one-rank
       run's, outputs within 8·2⁻⁸ of max |y|; entries dropped per group.
    e. A reduced qwen2 state (``reduced_lm``: the 3.27 GB state of 16c took
       ~45 s of I/O) saved from (data 2, model 2), restored onto the same
       mesh (the next step's loss bit-equal to the uninterrupted run's),
       onto (pod 2, model 2) and, back in the main process, onto a world of
       one: every leaf array-equal to the saved one.

18. GNN and recsys training (``models/gnn``, ``models/recsys``, the
    fixed-order gathers and segment sums of ``models/layers``; no kernel
    launches).
    a. GCN, SchNet, DimeNet and MeshGraphNet at full width through
       ``launch.train.build_gnn_training`` on the launcher's full_graph_sm
       cell, then DimeNet and MeshGraphNet at minibatch_lg's padded shapes
       (169,984 nodes, 168,960 edges, DimeNet's 1,048,576 triplets).  Each:
       the loss and gradients finite; the train step twice from the same
       state with PyTorch's defaults, bit-equal (loss, grad_norm,
       parameters, moments); the loss lowered by that step (AdamW,
       warm-up 1, no decay, lr 1e-4 cut to a first-order decrease of 0.1%
       of the loss); on full_graph_sm the card's loss within rel 1e-4 of
       the port's CPU loss on the same parameters and batch.  Logged: ms a
       step, peak memory.
    b. DIN on din()'s full tables (7.28 GB of float32 drawn on the card):
       train_batch's B = 65,536 at S = 100, one step run twice from the
       same seeded state bit-equal (an exact checksum of every parameter
       and moment), five steps at lr 1e-2 lowering the batch's loss (ms a
       step, peak memory); serve_p99's B = 512 through ``din_logits``, p50
       and p99 over 50 calls, logits within 1e-4 of max |logit| of the
       CPU's on compact tables (the batch's rows, ids renumbered);
       retrieval_cand's one user against 1,000,000 candidates in chunks of
       65,536 (seconds), 512 sampled scores within 2e-4 of ``din_logits``
       on the tiled batch.
    c. ``launch.train --arch gcn-cora --steps 20`` and ``--arch din
       --reduced --steps 20``, started with phase 11's CLIs: exit 0 and
       finite losses printed.

19. The dry runs (``launch.cells``, ``launch.dryrun``, the op walker
    ``launch.hlo_analysis``, the planning mesh over torch's fake process
    group; no kernel launches).
    a. Four spawned gloo ranks on the card (``_mesh_rank``): the four GNNs
       at full width on full_graph_sm on (data 2, model 2) with
       ``gnn_rules`` (nodes, edges and triplets over both axes), one step
       at 18a's lr run twice from the same state: loss and grad_norm
       within rel 1e-5 of 18a's unsharded step (SchNet's and DimeNet's
       graph energy E within rel 1e-5, their loss (E - y)² within
       2e-5·|E|/|E - y| and grad_norm within 1e-5·(1 + |E|/|E - y|): the
       residual cancels), the two runs bit-equal;
       DIN at din()'s widths and full table rows on (data 1, model 4)
       with ``din_rules`` (each rank a quarter of the 7.28 GB tables), a
       batch of MESH_DIN_B: the sharded step's loss within rel 1e-5 of the
       unsharded loss, and MESH_DIN_CANDIDATES retrieval candidates over
       the four ranks, MESH_DIN_CHECKED sampled scores within 2e-4 of
       ``din_logits`` on the tiled batch.
    b. The planner against the card (``plan_worker``, on fake CUDA tensors
       in two processes started when phase 11's CLIs end, beside phases
       12–18: ~45 s of host time):
       16b's step and 18b's DIN step planned at a world of one, each
       planned peak within 20% of the peak the phase measured; 17b's
       sharded step planned on a fake (2, 2) world, its collective census
       equal to the one rank 0 recorded in 17b.  The card's name and
       ``total_memory`` are logged (``hlo_analysis.CARD_TOTAL_MEMORY``).
    c. ``python -m repro_torch.launch.dryrun`` for one cell a family on the
       single-pod mesh (qwen2-1.5b train_4k, gcn-cora ogb_products, din
       train_batch, pirmcut road_asia), started with 19b's processes:
       every record ``ok``, each peak a rank logged against the card.

TF32 is switched off for matmuls and cuDNN, so every float32 product is a
full float32 product.  The last two lines of standard output are the
``kernels`` JSON line and ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# NVIDIA H100 SXM data sheet: HBM3 rate, float32 rate outside the tensor
# cores (the graph kernels do float32 CUDA-core arithmetic) and the dense
# bf16 tensor-core rate (the attention kernel's bf16 products)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BF16_TC_FLOP_PER_S = 989e12

KERNELS = {
    "ell_spmv": ("src/repro_torch/kernels/csrc/ell_spmv.cu",
                 "src/repro/kernels/ell_spmv.py:50"),
    "fused_ell_sweep": ("src/repro_torch/kernels/csrc/fused_ell_sweep.cu",
                        "src/repro/kernels/edge_reweight.py:111"),
    "block_diag_matvec": ("src/repro_torch/kernels/csrc/block_diag_matvec.cu",
                          "src/repro/kernels/block_diag_matmul.py:41"),
    "edge_reweight": ("src/repro_torch/kernels/csrc/edge_reweight.cu",
                      "src/repro/kernels/edge_reweight.py:59"),
    "flash_fwd": ("src/repro_torch/kernels/csrc/flash_fwd.cu",
                  "src/repro/kernels/flash_attention.py:81"),
}
# bursts of 8 requests per serving tenant (the first cold, the rest warm)
SERVE_ROUNDS = 2
# LM serving traffic: 4 prompts of 4096 tokens, 64 tokens generated for each
LM_BATCH, LM_SEQ, LM_GEN = 4, 4096, 64
# the path whose launches the kernels line reports for each kernel
LAUNCH_PATH = {"ell_spmv": "main", "fused_ell_sweep": "main",
               "block_diag_matvec": "main", "edge_reweight": "serve",
               "flash_fwd": "lm"}
# no launches of any kernel; a path's expected counts update this
NO_LAUNCHES = {name: 0 for name in KERNELS}
# flash_fwd in bf16 against the dense plain version, of each entry's scale
# Σ_j p_ij·|v_j|: three roundings to bf16 at u = 2^-8 (p before the p·v
# product on the kernel's side, out on both sides) plus 1e-4 for the float32
# sums and exponentials; in float32 the Pallas sweep's 3e-5
FLASH_RTOL = {"bfloat16": 3 * 2.0 ** -8 + 1e-4, "float32": 3e-5}
# the LM path's last-position logits, kernel vs plain attention path, of
# max |logits|: the two paths round to bf16 at other places (p before p·v,
# the attention output) in every layer, and the gaps pass through the rest
LOGIT_RTOL = 5e-2


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# every CLI subprocess started by start_clis; any still running when the
# script exits (a phase failed while they ran) is killed then
_CLIS: list = []


@atexit.register
def _stop_clis():
    for proc in _CLIS:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def start_clis(runs: dict, out_dir: Path) -> dict:
    """Starts each ``name: (args, timeout)`` of ``runs`` as ``python args``
    from the checkout's root, all at once; ``finish_clis`` waits for them.
    Each writes its standard output and error to ``chip_smoke_{name}.log``
    and ``.err`` under ``out_dir`` (files, so that no pipe fills)."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    started = {}
    for name, (args, timeout) in runs.items():
        out = out_dir / f"chip_smoke_{name}.log"
        err = out_dir / f"chip_smoke_{name}.err"
        with open(out, "w") as fo, open(err, "w") as fe:
            proc = subprocess.Popen([sys.executable] + args, cwd=ROOT,
                                    env=env, stdout=fo, stderr=fe)
        _CLIS.append(proc)
        started[name] = dict(proc=proc, t0=time.perf_counter(),
                             timeout=timeout, out=out, err=err)
    return started


def finish_clis(started: dict) -> dict:
    """Waits for the CLIs of ``start_clis``.  Returns, by name, the seconds
    from the start to the exit (the CLIs ran side by side on the card),
    the exit code, the standard output and the end of the error; raises
    if one exits non-zero or outlives its timeout (then killed)."""
    done = {}
    while len(done) < len(started):
        for name, c in started.items():
            if name in done:
                continue
            rc = c["proc"].poll()
            secs = time.perf_counter() - c["t0"]
            if rc is None and secs <= c["timeout"]:
                continue
            if rc is None:
                c["proc"].kill()
                c["proc"].wait()
                raise AssertionError(f"{name} CLI still ran after "
                                     f"{c['timeout']} s")
            err = c["err"].read_text()
            if rc != 0:
                raise AssertionError(f"{name} CLI exited {rc}: {err[-2000:]}")
            done[name] = dict(seconds=secs, rc=rc,
                              stdout=c["out"].read_text(), stderr=err[-2000:])
        time.sleep(0.05)
    return done


def box_labels(side: int, box: int = 8):
    """Geometric partition of a side³ grid into box³-voxel boxes (node id =
    z·side² + y·side + x, as grid_3d numbers them).  Returns (labels, P)."""
    import numpy as np

    idx = np.arange(side ** 3)
    z, y, x = idx // (side * side), (idx // side) % side, idx % side
    nb = -(-side // box)
    return (z // box) * nb * nb + (y // box) * nb + x // box, nb ** 3


def segmentation_grid(side: int, seed: int):
    from repro_torch.graphs import generators as gen

    g = gen.grid_3d(side, side, side, conn=26, seed=seed)
    return gen.segmentation_instance(g, (side,) * 3, seed=seed + 1)


# the kernels redesigned for Hopper: their ptxas lines go to the report;
# those of STRICT must not spill
REDESIGNED = ("flash_fwd", "ell_spmv", "block_diag_matvec", "fused_ell_sweep",
              "edge_reweight")
STRICT = ("block_diag_matvec", "fused_ell_sweep", "edge_reweight")


def sass_loops(sass: str) -> dict:
    """The loops of each function of a ``cuobjdump -sass`` listing: for
    every backward branch, the instructions from its target to it (16 bytes
    each on sm_90), smallest first.  Per function name, a list of counts."""
    import re

    loops, name = {}, None
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            loops[name] = []
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        br = ins and re.search(r"\bBRA(?:\.\S+)?\s+(?:[^,]+,\s*)?0x([0-9a-f]+)",
                              ins.group(2))
        if br and name is not None:
            at, to = int(ins.group(1), 16), int(br.group(1), 16)
            if to < at:
                loops[name].append((at - to) // 16 + 1)
    return {fn: sorted(n) for fn, n in loops.items()}


def build_facts() -> dict:
    """What the compiler says of the redesigned kernels: per kernel, the
    ptxas lines of each entry function (registers, shared memory, spills;
    from the log kept beside its library, so a build made before this run
    counts too), the count of HGMMA (wgmma) instructions in its library's
    SASS and the instruction count of each loop of its SASS
    (``sass_loops``).  Fails if the attention kernel's SASS holds no HGMMA,
    or if a kernel of ``STRICT`` has no ptxas lines or spills."""
    from repro_torch.kernels import build

    facts = {}
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    for name in REDESIGNED:
        lines = [ln.strip() for ln in build.build_log(name).splitlines()
                 if any(w in ln for w in ("Compiling entry", "registers",
                                          "spill", "C75"))]
        sass = subprocess.run([str(cuobjdump), "-sass",
                               str(build.library_path(name))],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout
        facts[name] = dict(ptxas=lines, hgmma=sass.count("HGMMA"),
                           sass_loops=sass_loops(sass))
        spills = [ln for ln in lines if "spill" in ln and not
                  ln.startswith("0 bytes stack frame, 0 bytes spill")]
        log(f"[build] {name}: {sum('registers' in ln for ln in lines)} entry "
            f"functions, {len(spills)} with spills; {facts[name]['hgmma']} "
            f"HGMMA instructions in its SASS")
        if name in STRICT and (spills or not lines):
            raise AssertionError(f"{name}: spills {spills} in ptxas lines "
                                 f"{lines}")
    if facts["flash_fwd"]["hgmma"] == 0:
        raise AssertionError("flash_fwd's library has no HGMMA instruction")
    return facts


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``reps`` back-to-back calls, between
    two CUDA events, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of ``fn``: ``reps`` calls captured
    in one CUDA graph, replayed once to warm up, then once between two CUDA
    events.  What ``time_ms`` reads where the wrapper's host work per call
    (checks, allocations, the launch) takes longer than its kernel: the
    launches then wait on the host, and ``time_ms`` times the host."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def alternate_ms(fns: dict, reps: int, rounds: int = 3):
    """Each of ``fns`` timed ``rounds`` times in turn (a, b, a, b, ...), each
    timing a ``time_ms`` of ``reps`` calls.  Returns the medians and the
    timings by name."""
    import statistics

    runs = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            runs[name].append(time_ms(fn, reps))
    return {name: statistics.median(t) for name, t in runs.items()}, runs


def bound(n_bytes: float, n_flops: float, peak_flops: float = PEAK_F32_FLOP_PER_S):
    """Least time the card could take: bytes over the memory rate or flops
    over the peak rate of their type (float32 unless given), whichever is
    larger."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def check_close(name, got, want, rtol, scales=None):
    """Asserts |got − want| ≤ rtol·s for every entry of every output, where
    s is the entry's own scale: |want|, or for a sum of signed terms the
    same sum over the terms' absolute values (``scales``).  Logs the worst
    |got − want|/s and returns the max |got − want|."""
    import torch

    if scales is None:
        scales = [w.abs() for w in want]
    err = worst = 0.0
    for g, w, s in zip(got, want, scales):
        d = (g - w).abs()
        bad = d > rtol * s
        if bool(bad.any()):
            i = int(torch.argmax(torch.where(bad, d / s, 0.0).flatten()))
            raise AssertionError(
                f"{name}: kernel disagrees with its plain version at "
                f"{int(bad.sum())} entries; worst: got {float(g.flatten()[i])}, "
                f"plain {float(w.flatten()[i])}, scale {float(s.flatten()[i])} "
                f"(rtol {rtol})")
        err = max(err, float(d.max()))
        # s == 0 passed only with d == 0
        worst = max(worst, float(torch.where(s > 0, d / s, 0.0).max()))
    log(f"  {name}: max abs err {err:.3e}, worst err/scale {worst:.3e} "
        f"(tolerance {rtol} of each entry's scale)")
    return err


def kernels_alone(prob, inst, cfg, seed: int):
    """Phase 3: each kernel vs its plain version at the main path's shapes."""
    import torch

    from repro_torch.core import laplacian as lap
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    plan = prob.ell_plan(dev)
    bplan = prob.block_plan(dev)
    g = prob.device_graph(torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, k = plan.cols.shape
    valid = torch.zeros((n, k), dtype=torch.bool, device=dev)
    valid[plan.slot_rows, plan.slot_cols] = True
    nnz = int(valid.sum())
    out = {}

    # -- ell_spmv: the instance's column ids, values drawn from the seed
    cols = plan.cols
    vals = -torch.rand((n, k), generator=gen, device=dev) * valid
    diag = torch.rand(n, generator=gen, device=dev) + (-vals).sum(dim=1)
    v = torch.rand(n, generator=gen, device=dev)
    y = ops.ell_spmv(cols, vals, diag, v)
    # 1e-5 of Σ|terms| per row: k + 1 = 33 float32 products summed in two
    # orders differ by at most ~2·33·2⁻²⁴ ≈ 4e-6 of it
    scale = [ref.ell_spmv_ref(cols, vals.abs(), diag.abs(), v.abs())]
    err = check_close("ell_spmv", [y], [ref.ell_spmv_ref(cols, vals, diag, v)],
                      1e-5, scale)
    csr = ell_csr(cols, valid, vals, diag)
    check_close("ell_spmv library (CSR mv)", [torch.mv(csr, v)], [y], 1e-5,
                scale)
    t_b = bound(nbytes(cols, vals, diag, v, y), 2 * nnz + 2 * n)
    out["ell_spmv"] = dict(
        max_abs_err=err, shape=[n, k],
        ms=time_ms(lambda: ops.ell_spmv(cols, vals, diag, v), 100),
        plain_ms=time_ms(lambda: ref.ell_spmv_ref(cols, vals, diag, v), 20),
        library_ms=time_ms(lambda: torch.mv(csr, v), 100),
        bound_ms=t_b[0], bound_by=t_b[1])
    log_share("ell_spmv", out["ell_spmv"], "CSR mv")
    del vals, diag, csr, scale

    # -- fused_ell_sweep: the instance's weights, voltages from the seed
    c_ell = lap.ell_edge_weights(plan, g.c)
    v = torch.rand(n, generator=gen, device=dev)
    args = (cols, c_ell, g.c_s, g.c_t, v, cfg.eps)
    got = ops.fused_ell_sweep(*args)
    # 3e-5 of each entry itself (no absolute floor; the outputs span eight
    # decades): each r is c²·rsqrt(·) within 2 ulp, each diagonal a sum of
    # positive terms in two orders (≤ 2·34·2⁻²⁴ ≈ 4e-6 relative)
    err = check_close("fused_ell_sweep", got, ref.fused_ell_sweep_ref(*args),
                      3e-5)
    # ~10 flops and one reciprocal square root per stored edge slot, ~12 per row
    t_b = bound(nbytes(cols, c_ell, g.c_s, g.c_t, v, *got), 10 * nnz + 12 * n)
    out["fused_ell_sweep"] = dict(
        max_abs_err=err, shape=[n, k],
        ms=time_ms(lambda: ops.fused_ell_sweep(*args), 50),
        plain_ms=time_ms(lambda: ref.fused_ell_sweep_ref(*args), 10),
        library_ms=None, bound_ms=t_b[0], bound_by=t_b[1])
    log_share("fused_ell_sweep", out["fused_ell_sweep"])
    del c_ell, got

    # -- block_diag_matvec: P blocks of bs², drawn from the seed
    p, bs = bplan.p, bplan.bs
    out["block_diag_matvec"] = block_diag_entry(
        "block_diag_matvec", torch.randn((p, bs, bs), generator=gen, device=dev),
        torch.randn((p, bs), generator=gen, device=dev))

    # -- where an IRLS iteration's time goes outside the kernels: the block
    # assembly and the batched Cholesky + explicit inverse (torch)
    from repro_torch.core import precond as pc

    rw = lap.initial_weights(g)
    A = pc.assemble_blocks(bplan, rw)
    t_asm = time_ms(lambda: pc.assemble_blocks(bplan, rw), 3, warmup=1)
    t_chol = time_ms(lambda: torch.linalg.cholesky_ex(A), 3, warmup=1)
    del A
    t_fac = time_ms(lambda: pc.factorize_blocks(bplan, rw, True), 3, warmup=1)
    log(f"  per IRLS iteration: factorize_blocks {t_fac:.2f} ms, of which "
        f"assemble_blocks {t_asm:.2f} ms and cholesky_ex {t_chol:.2f} ms "
        f"(the rest: cholesky_solve against I)")
    out["_factorization"] = dict(assemble_ms=t_asm, cholesky_ms=t_chol,
                                 factorize_ms=t_fac)
    torch.cuda.empty_cache()
    for name, r in out.items():
        if name.startswith("_"):
            continue
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"  {name} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {lib} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    return out


def log_share(name, r, library=None):
    """Logs a kernel's share of its bound and, where a library call computes
    the same function, its time over that call's, and keeps both in its
    record."""
    r["bound_share"] = r["bound_ms"] / r["ms"]
    text = (f"  {name}: {r['ms']:.4f} ms, {r['bound_share']:.3f} of its bound "
            f"({r['bound_ms']:.4f} ms)")
    if library is not None:
        r["vs_library"] = r["ms"] / r["library_ms"]
        text += (f", {r['vs_library']:.3f}x the {library} call "
                 f"({r['library_ms']:.4f} ms)")
    log(text)


def block_diag_entry(name, A, x):
    """``block_diag_matvec`` on blocks A [P, bs, bs] and x [P, bs]: held
    against its plain version and the ``torch.bmm`` call, then timed in
    turns with ``torch.bmm``, three times each; ``ms`` and ``library_ms``
    are the medians."""
    import torch

    from repro_torch.kernels import ops, ref

    y = ops.block_diag_matvec(A, x)
    # 1e-5 of Σ|A||x| per row: dot products of length bs in two orders; for
    # random signs their gap grows as √bs·2⁻²⁴ ≈ 1.4e-6 of it at bs = 512
    scale = [ref.block_diag_matvec_ref(A.abs(), x.abs())]
    err = check_close(name, [y], [ref.block_diag_matvec_ref(A, x)], 1e-5,
                      scale)
    check_close(f"{name} library (bmm)",
                [torch.bmm(A, x[:, :, None])[:, :, 0]], [y], 1e-5, scale)
    del scale
    p, bs = x.shape
    t_b = bound(nbytes(A, x, y), 2 * p * bs * bs)
    med, runs = alternate_ms({
        "kernel": lambda: ops.block_diag_matvec(A, x),
        "bmm": lambda: torch.bmm(A, x[:, :, None])}, 30)
    r = dict(max_abs_err=err, shape=list(A.shape), ms=med["kernel"],
             plain_ms=time_ms(lambda: ref.block_diag_matvec_ref(A, x), 10),
             library_ms=med["bmm"], bound_ms=t_b[0], bound_by=t_b[1],
             runs=runs)
    log(f"  {name} timings in turns: kernel {runs['kernel']}, torch.bmm "
        f"{runs['bmm']} ms")
    log_share(name, r, "torch.bmm")
    return r


def ell_csr(cols, valid, vals, diag):
    """The ELL matrix (one lane, or B lanes as one block-diagonal matrix of
    B·n rows) as a CSR tensor for ``torch.mv``: the library call computing
    the same product."""
    import torch

    n, k = cols.shape
    lanes = 1 if vals.dim() == 2 else vals.shape[0]
    vals, diag = vals.reshape(lanes, n, k), diag.reshape(lanes, n)
    rows = torch.arange(n, device=cols.device)
    r = torch.cat([rows[:, None].expand(n, k)[valid], rows])
    c = torch.cat([cols[valid].long(), rows])
    off = (torch.arange(lanes, device=cols.device) * n)[:, None]
    idx = torch.stack([(r[None] + off).flatten(), (c[None] + off).flatten()])
    val = torch.cat([vals[:, valid], diag], dim=1).flatten()
    return torch.sparse_coo_tensor(idx, val, (lanes * n, lanes * n)
                                   ).coalesce().to_sparse_csr()


def kernel_entry(err, shape, fn, plain, reps, plain_reps, bound_ms):
    """One kernel's record: its error and shape, then the kernel and its
    plain version timed on the same inputs, beside its bound."""
    return dict(max_abs_err=err, shape=list(shape), ms=time_ms(fn, reps),
                plain_ms=time_ms(plain, plain_reps), library_ms=None,
                bound_ms=bound_ms[0], bound_by=bound_ms[1])


def device_time(name, r, fn, reps):
    """A launch about as short as its wrapper's host work: adds
    ``graph_ms``, its device time in a CUDA graph, beside ``ms``, the time
    of back-to-back wrapper calls (``time_ms``); logs both, and the graph
    time's share of the bound."""
    r["graph_ms"] = graph_ms(fn, reps)
    log(f"  {name}: {r['ms']:.4f} ms a call back to back, "
        f"{r['graph_ms']:.4f} ms a launch in a CUDA graph "
        f"({r['bound_ms'] / r['graph_ms']:.3f} of its bound)")


def edge_reweight_inputs(g, lanes: int, gen):
    """Per-lane inputs of ``edge_reweight`` at B = ``lanes`` (no lane dim
    at 1): the instance's weights, each drifted by up to ±20%, and voltages
    in [0, 1), drawn from ``gen`` on the card."""
    import torch

    lead = () if lanes == 1 else (lanes,)
    c = g.c * (0.8 + 0.4 * torch.rand(lead + (g.m,), generator=gen,
                                      device=g.c.device))
    v = torch.rand(lead + (g.n,), generator=gen, device=g.c.device)
    return c, v


def edge_reweight_alone(prob, eps: float, seed: int, lane_counts=(1, 8),
                        label: str = ""):
    """Phase 7: ``edge_reweight`` at the COO shapes of the instance, for one
    instance and for a serving batch of 8 lanes (``lane_counts``)."""
    import torch

    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    g = prob.device_graph(torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    n, m = g.n, g.m
    # a few endpoints out of range: the kernel gathers 0 there, as the TPU
    # kernel's fill_value=0 does; the plain version reads an appended 0.
    # They sit in 16 groups of 4 edges (the vector variant's work items),
    # at each place of a group four times
    src, dst = g.src.clone(), g.dst.clone()
    bad = (torch.randperm(m // 4, generator=gen, device=dev)[:16] * 4
           + torch.arange(16, device=dev) % 4)
    src[bad[:8]] = n + torch.arange(8, dtype=torch.int32, device=dev)
    dst[bad[8:]] = -1 - torch.arange(8, dtype=torch.int32, device=dev)

    def in_range(i):
        return torch.where((i >= 0) & (i < n), i, torch.full_like(i, n))

    out = {}
    for lanes in lane_counts:
        name = f"edge_reweight {label}B={lanes}"
        c, v = edge_reweight_inputs(g, lanes, gen)
        r = ops.edge_reweight_r(src, dst, c, v, eps)
        v_pad = torch.cat([v, torch.zeros_like(v[..., :1])], dim=-1)
        want = ref.edge_reweight_ref(in_range(src), in_range(dst), c, v_pad,
                                     eps)
        # bit for bit (tolerance 0 of each entry): the kernel rounds each
        # operation once, in the plain version's order
        err = check_close(name, [r], [want], 0.0)
        del want, v_pad
        # timed on the instance's own indices, the main path's
        args = (g.src, g.dst, c, v, eps)
        # ~7 flops, a square root and a division per edge and lane
        out[lanes] = kernel_entry(
            err, c.shape, lambda: ops.edge_reweight_r(*args),
            lambda: ref.edge_reweight_ref(*args), 50, 10,
            bound(nbytes(g.src, g.dst, c, v, r), 7 * c.numel()))
        out[lanes]["plan"] = list(ops._er_plan(m, ops._aligned(g.src, g.dst,
                                                              c)))
        log_share(name, out[lanes])
        device_time(name, out[lanes], lambda: ops.edge_reweight_r(*args), 50)
        del c, v, r, args
    torch.cuda.empty_cache()
    for lanes, r in out.items():
        log(f"  edge_reweight {label}{r['shape']}: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, library null, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plan {r['plan']}")
    return out


def batched_ell_kernels(prob, lanes: int, eps: float, seed: int):
    """The batched ``ell_spmv`` and ``fused_ell_sweep``: ``lanes`` lanes of
    values over the instance's one ELL plan, and ``block_diag_matvec`` on
    the lanes' ``lanes``·P blocks as one flat batch, against their plain
    versions, at the tolerances of phase 3."""
    import torch

    from repro_torch.core import laplacian as lap
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    plan = prob.ell_plan(dev)
    g = prob.device_graph(torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    cols = plan.cols
    n, k = cols.shape
    valid = torch.zeros((n, k), dtype=torch.bool, device=dev)
    valid[plan.slot_rows, plan.slot_cols] = True
    out = {}
    vals = -torch.rand((lanes, n, k), generator=gen, device=dev) * valid
    diag = torch.rand((lanes, n), generator=gen, device=dev) + (-vals).sum(-1)
    v = torch.rand((lanes, n), generator=gen, device=dev)
    y = ops.ell_spmv(cols, vals, diag, v)
    scale = [ref.ell_spmv_ref(cols, vals.abs(), diag.abs(), v.abs())]
    err = check_close(f"ell_spmv B={lanes}", [y],
                      [ref.ell_spmv_ref(cols, vals, diag, v)], 1e-5, scale)
    nnz = int(valid.sum())
    out["ell_spmv"] = kernel_entry(
        err, vals.shape, lambda: ops.ell_spmv(cols, vals, diag, v),
        lambda: ref.ell_spmv_ref(cols, vals, diag, v), 100, 20,
        bound(nbytes(cols, vals, diag, v, y), lanes * (2 * nnz + 2 * n)))
    device_time(f"ell_spmv B={lanes}", out["ell_spmv"],
                lambda: ops.ell_spmv(cols, vals, diag, v), 100)
    # the library call: the B lanes as one block-diagonal CSR matrix
    csr = ell_csr(cols, valid, vals, diag)
    vf = v.flatten()
    check_close(f"ell_spmv B={lanes} library (CSR mv)",
                [torch.mv(csr, vf).view(lanes, n)], [y], 1e-5, scale)
    out["ell_spmv"]["library_ms"] = time_ms(lambda: torch.mv(csr, vf), 100)
    log_share(f"ell_spmv B={lanes}", out["ell_spmv"], "block-diagonal CSR mv")
    del vals, diag, y, scale, csr
    c = g.c * (0.8 + 0.4 * torch.rand((lanes, g.m), generator=gen, device=dev))
    c_ell = lap.ell_edge_weights(plan, c)
    c_s = g.c_s.expand(lanes, n).contiguous()
    c_t = g.c_t.expand(lanes, n).contiguous()
    args = (cols, c_ell, c_s, c_t, v, eps)
    got = ops.fused_ell_sweep(*args)
    err = check_close(f"fused_ell_sweep B={lanes}", got,
                      ref.fused_ell_sweep_ref(*args), 3e-5)
    out["fused_ell_sweep"] = kernel_entry(
        err, c_ell.shape, lambda: ops.fused_ell_sweep(*args),
        lambda: ref.fused_ell_sweep_ref(*args), 50, 10,
        bound(nbytes(cols, c_ell, c_s, c_t, v, *got),
              lanes * (10 * nnz + 12 * n)))
    device_time(f"fused_ell_sweep B={lanes}", out["fused_ell_sweep"],
                lambda: ops.fused_ell_sweep(*args), 50)
    log_share(f"fused_ell_sweep B={lanes}", out["fused_ell_sweep"])
    del c, c_ell, c_s, c_t, v, got, args
    # the lanes' inverses as gather_blocks flattens them: [lanes·P, bs, bs]
    bplan = prob.block_plan(dev)
    p, bs = lanes * bplan.p, bplan.bs
    out["block_diag_matvec"] = block_diag_entry(
        f"block_diag_matvec B={lanes}",
        torch.randn((p, bs, bs), generator=gen, device=dev),
        torch.randn((p, bs), generator=gen, device=dev))
    torch.cuda.empty_cache()
    for name, r in out.items():
        log(f"  {name} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
    return out


def frame_instance(side: int, seed: int):
    """A side×side 4-connected image-segmentation frame (grid_2d)."""
    from repro_torch.graphs import generators as gen

    g = gen.grid_2d(side, side, seed=seed)
    return gen.segmentation_instance(g, (side, side), seed=seed + 1)


def serve_traffic(rng, base, scale: float, burst: int, drift: float):
    """``burst`` weight assignments of one tenant: launch/mincut_serve.py's
    multiplicative random walk (a global scale of the edge weights, one
    lognormal step per request).  Returns (weights, the walk's new scale)."""
    import numpy as np

    from repro_torch.core import Weights

    ws = []
    for _ in range(burst):
        scale *= float(np.exp(rng.normal(0.0, drift)))
        ws.append(Weights(np.asarray(base.graph.weight) * scale,
                          np.asarray(base.s_weight),
                          np.asarray(base.t_weight)))
    return ws, scale


def server_cfg(use_pallas: bool):
    """``MinCutServer``'s default config, on the kernel or the plain path."""
    import inspect

    from repro_torch.serve import MinCutServer

    return dataclasses.replace(
        inspect.signature(MinCutServer).parameters["cfg"].default,
        use_pallas=use_pallas)


def serve_run(tenants, rounds: int, seed: int, rounding: str = "sweep",
              burst: int = 8, drift: float = 0.05):
    """Serve ``rounds`` bursts of ``burst`` requests per tenant through a
    fresh ``MinCutServer`` on the card (the default config with
    ``use_pallas``), each round's bursts in flight together; launch counters
    set to 0 just before and read just after.  Checks that every request
    completed in full batches, that ``edge_reweight`` launched once per IRLS
    iteration of every batch and no other kernel launched, that every
    tenant's later bursts warm-started, and that the voltages are finite."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serve import MinCutServer

    cfg = server_cfg(True)
    rng = np.random.default_rng(seed)
    scales = {name: 1.0 for name in tenants}
    sent = {name: [] for name in tenants}       # per round: weights
    served = {name: [] for name in tenants}     # per round: results
    with MinCutServer(cfg=cfg, rounding=rounding, device="cuda") as srv:
        keys = {name: srv.register(inst) for name, inst in tenants.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        for _ in range(rounds):
            futs = {}
            for name, inst in tenants.items():
                ws, scales[name] = serve_traffic(rng, inst, scales[name],
                                                 burst, drift)
                sent[name].append(ws)
                futs[name] = srv.submit_many(keys[name], ws, tenant=name)
            for name, fs in futs.items():
                served[name].append([f.result(timeout=900) for f in fs])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.launches)
        peak = torch.cuda.max_memory_allocated()
        stats = srv.stats()
        sessions = {name: srv.cache.get(key) for name, key in keys.items()}
    n_req = rounds * burst * len(tenants)
    want = stats["batches"] * cfg.n_irls
    log(f"[serve] {stats['completed']} of {n_req} requests in {wall:.2f} s; "
        f"batches {stats['batch_sizes']}, flush reasons "
        f"{stats['flush_reasons']}; warm {stats['warm']}; launches "
        f"{launches}, edge_reweight expected {want} ({stats['batches']} "
        f"batches × n_irls {cfg.n_irls})")
    if stats["completed"] != n_req or stats["failed"]:
        raise AssertionError(f"served {stats['completed']} of {n_req}")
    if stats["batch_sizes"] != [burst] * (rounds * len(tenants)):
        raise AssertionError(f"batches {stats['batch_sizes']}: the bursts "
                             f"did not form full batches")
    if launches != dict(NO_LAUNCHES, edge_reweight=want):
        raise AssertionError(f"serving launches {launches}, expected "
                             f"edge_reweight {want} and nothing else")
    if stats["warm"]["hits"] != (rounds - 1) * len(tenants):
        raise AssertionError(f"warm starts {stats['warm']}")
    for name in tenants:
        for rs in served[name]:
            for r in rs:
                if not np.isfinite(r.voltages).all():
                    raise AssertionError(f"{name}: non-finite voltages")
    return dict(sent=sent, served=served, wall=wall, launches=launches,
                peak=peak, stats=stats, sessions=sessions)


def serve_cold_again(name: str, inst, ws, first) -> dict:
    """Phase 8's repair check: ``ws`` (a tenant's first, cold burst) served
    again through a fresh server in the measured run's config, with
    PyTorch's defaults: the voltages and cuts must equal ``first``, the
    measured run's results, bit for bit.  Logs the batch's wall (session
    build, plan upload and the cold solve) and its IRLS share."""
    import numpy as np
    import torch

    from repro_torch.serve import MinCutServer

    with MinCutServer(cfg=server_cfg(True), rounding="sweep",
                      device="cuda") as srv:
        key = srv.register(inst)
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = [f.result(timeout=900)
               for f in srv.submit_many(key, ws, tenant=name)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    same_v = all(np.array_equal(a.voltages, b.voltages)
                 for a, b in zip(got, first))
    same_cut = all(a.cut_value == b.cut_value
                   and np.array_equal(a.cut.in_source, b.cut.in_source)
                   for a, b in zip(got, first))
    irls = float(np.median([r.timings["irls_wall"] for r in got]))
    log(f"[serve] {name}'s cold batch of {len(ws)} served again: voltages "
        f"bit-equal {same_v}, cuts and sides equal {same_cut}; batch wall "
        f"{wall:.3f} s, IRLS wall {irls:.3f} s")
    if not (same_v and same_cut):
        raise AssertionError(f"{name}: the cold batch served twice differs")
    return dict(wall_s=wall, irls_wall_s=irls, bit_equal=True)


def against_plain(run, rounding: str = "sweep"):
    """Every served batch again through ``solve_batch`` on the plain path on
    the card, same lanes, same warm start (the tenant's previous burst's
    last voltages, as the server's warm store holds them).  Returns
    {tenant: (max rel cut gap, PCG steps served, PCG steps plain)}."""
    out = {}
    for name, sess in run["sessions"].items():
        gaps, spend_k, spend_p = [], 0, 0
        for rnd, ws in enumerate(run["sent"][name]):
            prev = run["served"][name][rnd - 1] if rnd else None
            plain = sess.solve_batch(
                ws, rounding=rounding, cfg=server_cfg(False), pad_to=len(ws),
                warm_from=None if prev is None else [prev[-1].voltages] * len(ws))
            for got, ref in zip(run["served"][name][rnd], plain):
                gaps.append(abs(got.cut_value - ref.cut_value)
                            / abs(ref.cut_value))
                spend_k += int(got.pcg_iters.sum())
                spend_p += int(ref.pcg_iters.sum())
        out[name] = (max(gaps), spend_k, spend_p)
    return out


def serving_phase(tenants, rounds: int, seed: int):
    """Phase 8: a measured serving run with the card's default (atomic)
    scatters, then a checked run of the same traffic with deterministic
    algorithms, held against the plain path and a solo solve."""
    import numpy as np
    import torch

    # -- the measured run: PyTorch's defaults, as a user runs the server
    meas = serve_run(tenants, rounds, seed)
    results = [r for name in tenants for rs in meas["served"][name] for r in rs]
    tm = {k: [r.timings[k] for r in results]
          for k in ("queue", "irls", "irls_wall", "rounding", "total")}
    stats = meas["stats"]
    log(f"[serve] measured: {stats['completed'] / meas['wall']:.2f} solves/s "
        f"over the run (server window {stats['solves_per_sec']:.2f}/s); "
        f"peak device memory {meas['peak'] / 2**30:.2f} GiB")
    for k, xs in tm.items():
        log(f"[serve] per-request {k} s: median {float(np.median(xs)):.3f}, "
            f"max {max(xs):.3f}")
    # the repair: the COO scatters sum in a fixed order, so the first (cold)
    # volume batch served again, by a fresh server and without
    # deterministic mode, gives the same bits
    name = next(iter(tenants))
    again = serve_cold_again(name, tenants[name], meas["sent"][name][0],
                             meas["served"][name][0])
    # the kernel vs plain gap, bounded by 10 × the adaptive schedule's
    # irls_tol of 1e-3; the exact comparison is the checked run's
    spread = against_plain(meas)
    for name, (gap, sk, sp) in spread.items():
        log(f"[serve] measured {name}: cuts vs plain path (both with "
            f"PyTorch's defaults) max rel {gap:.3e} (bound 1e-2); PCG steps "
            f"served {sk}, plain {sp}")
        if not gap <= 1e-2:
            raise AssertionError(f"{name}: measured served cut vs plain rel "
                                 f"{gap}")

    # -- the checked run: every scatter deterministic, so the served batch
    # and its plain twin differ only where the kernel differs from its
    # plain version
    torch.use_deterministic_algorithms(True)
    try:
        chk = serve_run(tenants, rounds, seed)
        checks = {}
        for name, (gap, sk, sp) in against_plain(chk).items():
            sess = chk["sessions"][name]
            j = 3          # lane 3 of the first (cold) batch, solved alone
            lane = chk["served"][name][0][j]
            solo = sess.solve_batch([chk["sent"][name][0][j]], rounding="sweep",
                                    cfg=server_cfg(True))[0]
            solo_gap = abs(solo.cut_value - lane.cut_value) / abs(lane.cut_value)
            log(f"[serve] checked {name}: cuts vs plain path max rel "
                f"{gap:.3e} (tolerance 1e-4); PCG steps served {sk}, plain "
                f"{sp}; lane {j} of a batch of 8 vs alone: cut "
                f"{lane.cut_value!r} vs {solo.cut_value!r}, rel "
                f"{solo_gap:.3e} (tolerance 1e-4)")
            if not (gap <= 1e-4 and solo_gap <= 1e-4):
                raise AssertionError(f"{name}: served vs plain rel {gap}, "
                                     f"co-batched vs solo rel {solo_gap}")
            checks[name] = dict(max_rel_vs_plain=gap, solo_rel=solo_gap,
                                pcg_steps_served=sk, pcg_steps_plain=sp)
        two_level = two_level_server(seed)
    finally:
        torch.use_deterministic_algorithms(False)
    # the measured run's first volume batch again, traced
    name = next(iter(tenants))
    sess, ws = meas["sessions"][name], meas["sent"][name][0]
    prof = profile_call(lambda: sess.solve_batch(ws, rounding=None),
                        f"one batch of {len(ws)}")
    return dict(wall_s=meas["wall"], launches=meas["launches"],
                cold_again=again,
                checked_launches=chk["launches"], peak_bytes=meas["peak"],
                stats={k: stats[k] for k in ("completed", "batches",
                                             "batch_sizes", "flush_reasons",
                                             "warm", "solves_per_sec")},
                timings={k: dict(median=float(np.median(v)), max=max(v))
                         for k, v in tm.items()},
                measured_vs_plain={k: v[0] for k, v in spread.items()},
                checked=checks, two_level=two_level, profile=prof,
                checked_wall_s=chk["wall"],
                cfg=dataclasses.asdict(server_cfg(True)))


def profile_call(fn, label: str, top: int = 10):
    """Where one call's time goes: ``fn()`` under ``torch.profiler`` on the
    card.  Returns the wall, the summed device time of the kernels and
    copies (the device's busy share of the wall; one stream, so they do not
    overlap) and the kernels that took the most device time.  A trace that
    holds no device time is reported as such and not read further."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # the device's own events (kernels and copies), not the operators that
    # launched them, whose device time repeats their kernels'
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == DeviceType.CUDA
              and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events) / 1e6
    host = {e.key: e for e in prof.key_averages()}
    syncs = sum(host[k].count for k in host
                if k in ("cudaStreamSynchronize", "cudaMemcpyAsync"))
    launches = host["cudaLaunchKernel"].count if "cudaLaunchKernel" in host else 0
    rows = sorted(events, key=dev_us, reverse=True)[:top]
    out = dict(wall_s=wall, device_busy_s=busy,
               busy_share=busy / wall if wall > 0 else float("nan"),
               host_syncs_and_copies=syncs, kernel_launch_calls=launches,
               top=[dict(name=e.key[:90], device_ms=dev_us(e) / 1e3,
                         count=e.count) for e in rows])
    if busy == 0:
        log(f"[profile] {label}: the trace holds no device time; not read "
            f"further")
        return out
    log(f"[profile] {label}: wall {wall:.3f} s, kernels and copies "
        f"{busy:.3f} s on the device (busy share {busy / wall:.3f}, idle "
        f"{1 - busy / wall:.3f}); cudaStreamSynchronize + cudaMemcpyAsync "
        f"calls {syncs}, cudaLaunchKernel calls {launches}")
    for r in out["top"]:
        log(f"[profile]   {r['device_ms']:10.2f} ms  ×{r['count']:6d}  "
            f"{r['name']}")
    return out


def two_level_server(seed: int, side: int = 32, burst: int = 2):
    """A small server with two-level rounding (its host Dinic on the
    contour) against the plain path's two-level cuts."""
    inst = segmentation_grid(side, seed)
    run = serve_run({"grid": inst}, 1, seed, rounding="two_level",
                    burst=burst)
    gap, _, _ = against_plain(run, rounding="two_level")["grid"]
    got = run["served"]["grid"][0]
    log(f"[serve two_level] side {side}: cuts {[r.cut_value for r in got]}, "
        f"vs plain path max rel {gap:.2e} (tolerance 1e-4)")
    if not (gap <= 1e-4 and all(r.cut.meta["method"] == "two_level"
                                for r in got)):
        raise AssertionError(f"two-level server: rel {gap}")
    return dict(cuts=[r.cut_value for r in got], rel_vs_plain=gap)


def batched_ell_phase(side: int, lanes: int, seed: int):
    """Phase 9: ``solve_batch`` in the kernel config on a ``side``³ grid,
    default schedule (T = 50 IRLS iterations of 50 CG steps)."""
    import numpy as np
    import torch

    from repro_torch.core import IRLSConfig, MinCutSession, Problem, Weights
    from repro_torch.kernels import ops

    inst = segmentation_grid(side, seed)
    labels, n_blocks = box_labels(side)
    cfg = IRLSConfig(layout="ell", fuse_edge_sweep=True, use_pallas=True,
                     precond="block_jacobi", explicit_block_inverse=True,
                     n_blocks=n_blocks)
    n_irls = cfg.n_irls
    prob = Problem.build(inst, n_blocks=n_blocks, labels=labels)
    sess = MinCutSession(prob, cfg, backend="scanned", device="cuda")
    rng = np.random.default_rng(seed + 3)
    ws = [Weights(np.asarray(inst.graph.weight)
                  * rng.uniform(0.8, 1.2, inst.graph.m),
                  np.asarray(inst.s_weight), np.asarray(inst.t_weight))
          for _ in range(lanes)]
    kern = batched_ell_kernels(prob, lanes, cfg.eps, seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t = time.perf_counter()
    res = sess.solve_batch(ws, rounding="sweep")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    # the fixed schedule: n_irls sweeps; every PCG call (the cold initial
    # one too) one matvec and one preconditioner apply for r0, then one of
    # each per step
    steps = (n_irls + 1) * (cfg.pcg_max_iters + 1)
    want = dict(NO_LAUNCHES, ell_spmv=steps, fused_ell_sweep=n_irls,
                block_diag_matvec=steps)
    log(f"[batched ell] side {side}, B={lanes}, P={n_blocks}: solve_batch "
        f"{wall:.2f} s; launches {launches} (expected {want}); peak device "
        f"memory {peak / 2**30:.2f} GiB")
    if launches != want:
        raise AssertionError(f"batched ELL launches {launches} != {want}")
    t = time.perf_counter()
    plain = sess.solve_batch(ws, rounding="sweep",
                             cfg=dataclasses.replace(cfg, use_pallas=False))
    t_plain = time.perf_counter() - t
    rels = [abs(a.cut_value - b.cut_value) / abs(b.cut_value)
            for a, b in zip(res, plain)]
    gap = max(int(np.abs(a.pcg_iters - b.pcg_iters).max())
              for a, b in zip(res, plain))
    log(f"[batched ell] cuts {[r.cut_value for r in res]} vs plain "
        f"{[r.cut_value for r in plain]}: max rel {max(rels):.3e} (tolerance "
        f"1e-4), PCG gap {gap} (tolerance 2); plain {t_plain:.2f} s")
    if not (max(rels) <= 1e-4 and gap <= 2
            and all(np.isfinite(r.voltages).all() for r in res)):
        raise AssertionError(f"batched ELL vs plain: rel {max(rels)}, "
                             f"PCG gap {gap}")
    return dict(kernels=kern, wall_s=wall, plain_s=t_plain,
                launches=launches, peak_bytes=peak, max_rel=max(rels),
                pcg_gap=gap)


def flash_fwd_alone(cfg, batch: int, seq: int, seed: int):
    """Phase 10a: ``flash_fwd`` at the LM path's prefill shapes (bf16,
    causal) against its dense plain version, in the path's own [B, S, H, D]
    layout read in place and in the 3-D [B·H, S, D] one; timed in both
    beside the plain version, SDPA, its bound and the layer's call; then a
    float32 non-causal case at a smaller shape with Sq ≠ Sk."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers as nn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    KV, D = cfg.n_kv_heads, cfg.d_head
    G = cfg.n_heads // KV

    def inputs(b, sq, sk, dtype):
        """q [B, Sq, H, D], k, v [B, Sk, KV, D]: the model's layout."""
        return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                     for shape in ((b, sq, KV * G, D), (b, sk, KV, D),
                                   (b, sk, KV, D)))

    def held(name, q, k, v, causal):
        """The kernel on the model's layout against the plain version on
        the regrouped tensors, each entry against its own scale; then the
        3-D call on those tensors, which must give the same bytes.  Returns
        (kwargs, the 3-D tensors, plain out, its scale, max abs err)."""
        kw = dict(g_per_kv=G, causal=causal, scale=D ** -0.5)
        out, lse = ops.flash_fwd(q, k, v, **kw)
        q3, k3, v3 = (t.contiguous() for t in ops._regroup(q, k, v))
        want, want_lse = ref.flash_fwd_ref(q3, k3, v3, **kw)
        s_out, s_lse = ref.flash_fwd_scales(q3, k3, v3, **kw)
        rtol = FLASH_RTOL[str(q.dtype).split(".")[-1]]
        out3 = ops._regroup(out, k, v)[0]
        err = check_close(f"{name} out", [out3.float()], [want.float()], rtol,
                          [s_out])
        # lse = m + log l: 1e-5 of |m| + log l + the scores' summation scale
        check_close(f"{name} lse", [lse], [want_lse], 1e-5, [s_lse])
        got3, lse3 = ops.flash_fwd(q3, k3, v3, **kw)
        if not (torch.equal(got3, out3) and torch.equal(lse3, lse)):
            raise AssertionError(f"{name}: the 3-D call differs from the "
                                 f"in-place call on the same values")
        return kw, (q3, k3, v3), want, s_out, err

    # -- the path's shapes, bf16, causal, in the path's layout
    q, k, v = inputs(batch, seq, seq, torch.bfloat16)
    kw, (q3, k3, v3), want, s_out, err = held("flash_fwd bf16 causal", q, k,
                                              v, True)
    q4 = q3.view(batch, KV * G, seq, D)
    k4, v4 = k3.view(batch, KV, seq, D), v3.view(batch, KV, seq, D)

    def sdpa():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                              enable_gqa=True)

    # the library call is timed as the yardstick only; its gap to the plain
    # version is logged, not held
    lib = sdpa().reshape(q3.shape).float()
    log(f"  flash_fwd library (SDPA): worst err/scale "
        f"{float(((lib - want.float()).abs() / s_out).max()):.3e}")
    del lib, want, s_out
    flops = ops.flash_flops(q3.shape[0], seq, seq, D, True)
    t_b = bound(nbytes(q, k, v, q) + q3.shape[0] * seq * 4, flops,
                PEAK_BF16_TC_FLOP_PER_S)
    out = dict(
        max_abs_err=err, shape=[batch, seq, KV * G, D],
        ms=time_ms(lambda: ops.flash_fwd(q, k, v, **kw), 20),
        layout_3d_ms=time_ms(lambda: ops.flash_fwd(q3, k3, v3, **kw), 20),
        plain_ms=time_ms(lambda: ref.flash_fwd_ref(q3, k3, v3, **kw), 3,
                         warmup=1),
        library_ms=time_ms(sdpa, 20), bound_ms=t_b[0], bound_by=t_b[1],
        # the layer's call on the same tensors: no copy around the kernel
        layer_call_ms=time_ms(
            lambda: nn.flash_attention_kernel(q, k, v, causal=True), 20))
    out.update(tflop_s=flops / out["ms"] / 1e9,
               bound_share=out["bound_ms"] / out["ms"],
               vs_library=out["ms"] / out["library_ms"])
    del q, k, v, q3, k3, v3, q4, k4, v4
    torch.cuda.empty_cache()

    # -- float32, full attention, Sq ≠ Sk, at a smaller shape
    q, k, v = inputs(2, 1024, 1536, torch.float32)
    kw, _, _, _, err32 = held("flash_fwd f32 full", q, k, v, False)
    out["f32"] = dict(max_abs_err=err32, shape=[[*q.shape], [*k.shape]],
                      ms=time_ms(lambda: ops.flash_fwd(q, k, v, **kw), 10),
                      bound_ms=bound(nbytes(q, k, v, q) + 2 * KV * G * 1024 * 4,
                                     ops.flash_flops(2 * KV * G, 1024, 1536, D,
                                                 False))[0])
    del q, k, v
    torch.cuda.empty_cache()
    log(f"  flash_fwd {out['shape']} (in place): kernel {out['ms']:.4f} ms "
        f"({out['tflop_s']:.1f} TFLOP/s, {out['bound_share']:.3f} of its "
        f"bound), 3-D layout {out['layout_3d_ms']:.4f} ms, plain "
        f"{out['plain_ms']:.4f} ms, library (SDPA) {out['library_ms']:.4f} ms "
        f"(kernel/SDPA {out['vs_library']:.3f}), bound {out['bound_ms']:.4f} ms "
        f"({out['bound_by']}); the layer's call {out['layer_call_ms']:.4f} ms")
    log(f"  flash_fwd f32 {out['f32']['shape']}: kernel {out['f32']['ms']:.4f} "
        f"ms, float32 bound {out['f32']['bound_ms']:.4f} ms")
    return out


def lm_phase(cfg, batch: int, seq: int, gen_len: int, seed: int):
    """Phase 10b-c: the LM serving path at full width through the kernel,
    then the same prefill and greedy decode on the plain attention path."""
    import numpy as np
    import torch

    from repro_torch.data.lm import token_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.lm_serve import serve
    from repro_torch.models import transformer as tr

    dev = torch.device("cuda")
    t = time.perf_counter()
    params = tr.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                            device=dev).tree()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    t = time.perf_counter()
    prompts = token_batch(cfg.vocab, batch, seq, seed=seed)
    data_s = time.perf_counter() - t
    log(f"[lm] {cfg.name}: {cfg.param_count():,} parameters ({cfg.dtype}) "
        f"initialized in {init_s:.1f} s; {batch} prompts of {seq} tokens made "
        f"in {data_s:.1f} s")
    # warm-up (cuBLAS handles, the kernel's library): a short prompt, not read
    serve(cfg, params, prompts[:, :128], 2, dev)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    tokens, tm = serve(cfg, params, prompts, gen_len, dev)
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    want = dict(NO_LAUNCHES, flash_fwd=cfg.n_layers)
    prefill_tps = batch * seq / tm["prefill_s"]
    decode_tps = batch * (gen_len - 1) / tm["decode_s"]
    log(f"[lm] serve: prefill {batch}x{seq} in {tm['prefill_s']:.3f} s "
        f"({prefill_tps:.0f} tok/s), decode {gen_len - 1} steps in "
        f"{tm['decode_s']:.3f} s ({decode_tps:.1f} tok/s, batch {batch}); "
        f"peak device memory {peak / 2**30:.2f} GiB")
    log(f"[lm] launches {launches} (expected {want}: one flash_fwd per layer "
        f"in prefill, none in decode)")
    if launches != want:
        raise AssertionError(f"LM path launches {launches} != {want}")
    if tokens.shape != (batch, gen_len) or not (
            (tokens >= 0) & (tokens < cfg.vocab)).all():
        raise AssertionError(f"generated tokens {tokens.shape} out of range")

    # -- the same prefill through the kernel and on the plain path
    plain_cfg = dataclasses.replace(cfg, use_pallas_attention=False)
    toks = torch.as_tensor(prompts, dtype=torch.long, device=dev)
    logits_k, _ = tr.prefill(params, toks, cfg, pad_cache_to=seq + gen_len)
    logits_p, _ = tr.prefill(params, toks, plain_cfg, pad_cache_to=seq + gen_len)
    if not bool(torch.isfinite(logits_k).all()):
        raise AssertionError("non-finite logits on the kernel path")
    gap = float((logits_k - logits_p).abs().max())
    scale = float(logits_p.abs().max())
    top2 = logits_p.topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    first_k = logits_k.argmax(-1).cpu().numpy()
    first_p = logits_p.argmax(-1).cpu().numpy()
    checked = margin > 2 * gap
    log(f"[lm] last-position logits, kernel vs plain path: max |Δ| {gap:.4e} "
        f"of max |logits| {scale:.4e} (rel {gap / scale:.3e}, tolerance "
        f"{LOGIT_RTOL}); first tokens {first_k.tolist()} vs "
        f"{first_p.tolist()}, top-2 margins {np.round(margin, 4).tolist()}, "
        f"held where the margin exceeds {2 * gap:.4e}: lanes "
        f"{np.flatnonzero(checked).tolist()}")
    if not gap <= LOGIT_RTOL * scale:
        raise AssertionError(f"logits kernel vs plain: {gap} > {LOGIT_RTOL} × "
                             f"{scale}")
    if (first_k[checked] != first_p[checked]).any():
        raise AssertionError(f"first tokens {first_k} vs plain {first_p}")
    del logits_k, logits_p
    torch.cuda.empty_cache()
    plain_tokens, plain_tm = serve(plain_cfg, params, prompts, gen_len, dev)
    agree = (tokens == plain_tokens).sum(axis=1).tolist()
    log(f"[lm] plain path: prefill {plain_tm['prefill_s']:.3f} s, decode "
        f"{plain_tm['decode_s']:.3f} s; generated tokens equal to the kernel "
        f"path's, per lane (of {gen_len}): {agree}")

    # -- where the path's time goes: the prefill, then 8 decode steps
    prof = {"prefill": profile_call(
        lambda: tr.prefill(params, toks, cfg, pad_cache_to=seq + gen_len),
        f"LM prefill {batch}x{seq}")}
    _, cache = tr.prefill(params, toks, cfg, pad_cache_to=seq + gen_len)
    first = torch.as_tensor(tokens[:, 0], dtype=torch.long, device=dev)

    def decode_steps(n=8):
        for i in range(n):
            tr.decode_step(params, cache, first, seq + i, cfg)

    prof["decode_8_steps"] = profile_call(decode_steps, "LM decode, 8 steps")
    del params, cache
    torch.cuda.empty_cache()
    return dict(config=dataclasses.asdict(cfg) | {"dtype": str(cfg.dtype)},
                batch=batch, seq=seq, gen=gen_len, init_s=init_s,
                prefill_s=tm["prefill_s"], decode_s=tm["decode_s"],
                prefill_tok_s=prefill_tps, decode_tok_s=decode_tps,
                peak_bytes=peak, launches=launches, logit_gap=gap,
                logit_scale=scale, first_tokens=first_k.tolist(),
                first_tokens_plain=first_p.tolist(),
                first_token_lanes_held=np.flatnonzero(checked).tolist(),
                plain_prefill_s=plain_tm["prefill_s"],
                plain_decode_s=plain_tm["decode_s"], tokens_agree=agree,
                profile=prof)


# -- phase 11: delta staging, presolve and the CLIs at full width ------------

# delta staging traffic: the reference CLI's --drift-sparsity 0.01 --drift 0.05
DRIFT_FRAC, DRIFT_SIGMA = 0.01, 0.05
# presolve's instance: the reference CLI's --family road at side 512 (n =
# 262,144), cut for the run's time: at 1024 the run took 1,138.4-1,196.5 s
# of its 1,200 s (two kernelizes of 50-78 s, linear in n); at 768 the
# phase took ~95 s, which left the run too little room under its limit on
# a slower host; at 512 it takes ~32 s
ROAD_SIDE = 512


def drift_edges(rng, c, frac: float, sigma: float = DRIFT_SIGMA, among=None):
    """launch/mincut_serve.py's sparse walk: ``frac`` of the edges (of
    ``among`` where given, else of all) each take one lognormal step of
    ``sigma``.  Returns (new weights, the count of drifted edges)."""
    import numpy as np

    pool = np.arange(c.size) if among is None else np.asarray(among)
    k = max(1, int(round(frac * c.size)))
    idx = rng.choice(pool, size=k, replace=False)
    out = c.copy()
    out[idx] *= np.exp(rng.normal(0.0, sigma, size=k))
    return out, k


def wall_ms(fn, reps: int) -> float:
    """Mean host milliseconds per call of ``fn`` (host work and uploads
    included), each call ending in a device synchronization."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps * 1e3


def host_launches_want(pcg_iters, block: bool) -> dict:
    """The kernel launches of one host solve on the fused-ELL kernel path,
    from its PCG trace: every PCG call one matvec (and one block apply
    under block Jacobi) for r0, then one of each per step; one sweep per
    IRLS iteration after the cold initial system."""
    steps = sum(1 + it for it in pcg_iters)
    want = dict(NO_LAUNCHES, ell_spmv=steps,
                fused_ell_sweep=len(pcg_iters) - 1)
    if block:
        want["block_diag_matvec"] = steps
    return want


def delta_host_phase(inst, labels, n_blocks: int, cfg, seed: int):
    """Phase 11a: delta staging on the host solve of phase 4's instance and
    kernel config, under deterministic algorithms (the initial system's and
    the block assembly's scatters then sum in one order, so two solves of
    the same weights are bit-equal)."""
    import numpy as np
    import torch

    from repro_torch.core import MinCutSession, Problem, Weights
    from repro_torch.core import laplacian as lap
    from repro_torch.kernels import ops

    prob = Problem.build(inst, n_blocks=n_blocks, labels=labels)
    t = time.perf_counter()
    plan = prob.ell_plan("cuda")
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t
    t = time.perf_counter()
    dmap = prob.ell_delta_map("cuda")
    torch.cuda.synchronize()
    map_s = time.perf_counter() - t
    sess = MinCutSession(prob, cfg, device="cuda")
    rng = np.random.default_rng(seed + 11)
    c0 = np.asarray(inst.graph.weight, dtype=np.float64)
    c1, k = drift_edges(rng, c0, DRIFT_FRAC)
    w0 = Weights(c0, inst.s_weight, inst.t_weight)
    w1 = Weights(c1, inst.s_weight, inst.t_weight)
    torch.use_deterministic_algorithms(True)
    try:
        cold = sess.solve(weights=w0, rounding="sweep", delta_key="vol")
        torch.cuda.synchronize()
        ops.reset_launches()
        keyed = sess.solve(weights=w1, rounding="sweep", delta_key="vol")
        torch.cuda.synchronize()
        launches = dict(ops.launches)
        plain = sess.solve(weights=w1, rounding="sweep")
    finally:
        torch.use_deterministic_algorithms(False)
    modes = [cold.telemetry["delta"]["mode"], keyed.telemetry["delta"]["mode"]]
    changed = keyed.telemetry["delta"]["changed_edges"]
    want = host_launches_want(keyed.diagnostics.pcg_iters, block=True)
    same_v = bool(np.array_equal(keyed.voltages, plain.voltages))
    log(f"[delta host] {inst.n} nodes, {inst.graph.m} edges; drift {k} edges "
        f"(σ {DRIFT_SIGMA}): modes {modes}, changed_edges {changed}; keyed vs "
        f"keyless voltages bit-equal {same_v}, cuts {keyed.cut_value!r} vs "
        f"{plain.cut_value!r}; IRLS {keyed.timings['irls']:.2f} s keyed, "
        f"{plain.timings['irls']:.2f} s keyless")
    log(f"[delta host] launches {launches} (expected from the PCG trace "
        f"{want})")
    if modes != ["cold", "delta"] or changed != k:
        raise AssertionError(f"delta modes {modes}, changed {changed} of {k}")
    if not (same_v and keyed.cut_value == plain.cut_value):
        raise AssertionError("delta-staged solve differs from the keyless one")
    if launches != want:
        raise AssertionError(f"delta host launches {launches} != {want}")
    # the staged table against a full restage, and the staging times as the
    # session stages (host rounding, upload, device scatter)
    staged = sess._delta["vol"]["c_ell"]
    dtype = staged.dtype

    def full_stage(c):
        return lap.ell_edge_weights(plan, torch.as_tensor(c).to(dtype)
                                    .to("cuda"))

    if not torch.equal(staged, full_stage(c1)):
        raise AssertionError("delta-staged table differs from a full restage")
    prev = full_stage(c0)
    diff = np.flatnonzero(c0 != c1)
    delta_ms = wall_ms(lambda: lap.ell_edge_weights_delta(dmap, prev, c1,
                                                          diff), 10)
    full_ms = wall_ms(lambda: full_stage(c1), 10)
    table_bytes = staged.numel() * staged.element_size()
    map_bytes = nbytes(dmap.rows, dmap.lanes)
    log(f"[delta host] staging {delta_ms:.3f} ms delta ({diff.size} edges) vs "
        f"{full_ms:.3f} ms full restage; delta map built in "
        f"{map_s * 1e3:.1f} ms (argsort of {2 * inst.graph.m} slots; "
        f"{map_bytes / 2**20:.1f} MiB on the card), ELL plan {plan_s:.2f} s; "
        f"per key: table {table_bytes / 2**20:.1f} MiB on the card + "
        f"{c0.nbytes / 2**20:.1f} MiB of float64 weights on the host")
    return dict(modes=modes, changed_edges=changed, launches=launches,
                pcg_iters=keyed.diagnostics.pcg_iters, cut=keyed.cut_value,
                irls_s=dict(keyed=keyed.timings["irls"],
                            keyless=plain.timings["irls"]),
                stage_ms=dict(delta=delta_ms, full=full_ms),
                delta_map_s=map_s, ell_plan_s=plan_s,
                table_bytes=table_bytes, map_bytes=map_bytes,
                weights_bytes=c0.nbytes)


def ell_server_cfg():
    """Phase 8's server config on the fused-ELL path (point Jacobi):
    tests/test_drift.py's fused-ELL server config at full size."""
    return dataclasses.replace(server_cfg(True), layout="ell",
                               fuse_edge_sweep=True)


def delta_serve_run(tenants, rounds: int, seed: int, burst: int = 8):
    """Phase 11b's measured run: ``rounds`` bursts of ``burst`` requests per
    tenant, every request drifting DRIFT_FRAC of that tenant's edges from
    its previous one and naming its tenant; launch counters set to 0 just
    before and read just after."""
    import numpy as np
    import torch

    from repro_torch.core import Weights
    from repro_torch.kernels import ops
    from repro_torch.serve import MinCutServer

    cfg = ell_server_cfg()
    rng = np.random.default_rng(seed + 12)
    cur = {name: np.asarray(inst.graph.weight, dtype=np.float64)
           for name, inst in tenants.items()}
    served = {name: [] for name in tenants}
    with MinCutServer(cfg=cfg, rounding="sweep", device="cuda") as srv:
        keys = {name: srv.register(inst) for name, inst in tenants.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        for _ in range(rounds):
            futs = {}
            for name, inst in tenants.items():
                ws = []
                for _ in range(burst):
                    cur[name], _ = drift_edges(rng, cur[name], DRIFT_FRAC)
                    ws.append(Weights(cur[name], inst.s_weight,
                                      inst.t_weight))
                futs[name] = srv.submit_many(keys[name], ws, tenant=name)
            for name, fs in futs.items():
                served[name].extend(f.result(timeout=900) for f in fs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.launches)
        peak = torch.cuda.max_memory_allocated()
        stats = srv.stats()
        sessions = {name: srv.cache.get(key) for name, key in keys.items()}
    return dict(served=served, wall=wall, launches=launches, peak=peak,
                stats=stats, sessions=sessions, cfg=cfg)


def delta_serve_phase(tenants, seed: int, rounds: int = 3, burst: int = 8):
    """Phase 11b: delta staging in serving, a measured run, then the checked
    run under deterministic algorithms: keyed against keyless
    ``solve_batch`` at B = 8, tenant against no-tenant requests through a
    one-worker server without warm starts, and a 30% drift."""
    import numpy as np
    import torch

    from repro_torch.core import Weights
    from repro_torch.serve import MinCutServer

    run = delta_serve_run(tenants, rounds, seed, burst)
    stats, cfg = run["stats"], run["cfg"]
    n_req = rounds * burst * len(tenants)
    results = [r for rs in run["served"].values() for r in rs]
    want = dict(NO_LAUNCHES, fused_ell_sweep=stats["batches"] * cfg.n_irls,
                ell_spmv=run["launches"]["ell_spmv"])
    modes = {name: {m: sum(r.telemetry["delta"]["mode"] == m for r in rs)
                    for m in ("cold", "delta", "full")}
             for name, rs in run["served"].items()}
    tm = {k: [r.timings[k] for r in results] for k in ("irls", "irls_wall")}
    log(f"[delta serve] measured: {stats['completed']} of {n_req} requests in "
        f"{run['wall']:.2f} s, {stats['completed'] / run['wall']:.2f} solves/s; "
        f"batches {stats['batch_sizes']}; modes {modes}; peak device memory "
        f"{run['peak'] / 2**30:.2f} GiB; launches {run['launches']}")
    for k, xs in tm.items():
        log(f"[delta serve] per-request {k} s: median "
            f"{float(np.median(xs)):.3f}, max {max(xs):.3f}")
    if stats["completed"] != n_req or stats["failed"]:
        raise AssertionError(f"served {stats['completed']} of {n_req}")
    if run["launches"] != want or want["ell_spmv"] == 0:
        raise AssertionError(f"delta serving launches {run['launches']}, "
                             f"expected {want}")
    for name, md in modes.items():
        if md != {"cold": 1, "delta": rounds * burst - 1, "full": 0}:
            raise AssertionError(f"{name}: delta modes {md}")
        if not all(np.isfinite(r.voltages).all() for r in run["served"][name]):
            raise AssertionError(f"{name}: non-finite voltages")

    rng = np.random.default_rng(seed + 13)
    checked = {}
    torch.use_deterministic_algorithms(True)
    try:
        # session level: keyed and keyless batches of the same weights
        for name, sess in run["sessions"].items():
            inst = tenants[name]
            c = np.asarray(inst.graph.weight, dtype=np.float64)
            delta_lanes = 0
            for rnd in range(2):
                ws = []
                for _ in range(burst):
                    c, _ = drift_edges(rng, c, DRIFT_FRAC)
                    ws.append(Weights(c, inst.s_weight, inst.t_weight))
                keyed = sess.solve_batch(ws, rounding="sweep",
                                         delta_keys=["chk"] * burst)
                plain = sess.solve_batch(ws, rounding="sweep")
                for a, b in zip(keyed, plain):
                    if not (np.array_equal(a.voltages, b.voltages)
                            and a.cut_value == b.cut_value):
                        raise AssertionError(f"{name}: keyed solve_batch "
                                             f"differs from the keyless one")
                delta_lanes = max(delta_lanes, sum(
                    r.telemetry["delta"]["mode"] == "delta" for r in keyed))
            checked[name] = dict(session_bit_equal=True,
                                 delta_lanes=delta_lanes)
        # server level: tenant and no-tenant requests, one worker, no
        # warm starts, so only the staging differs; then a 30% drift
        with MinCutServer(cfg=cfg, rounding="sweep", max_batch=1, n_workers=1,
                          warm_capacity=0, device="cuda") as srv:
            for name, inst in tenants.items():
                key = srv.register(inst)
                c = np.asarray(inst.graph.weight, dtype=np.float64)
                seq = []
                for _ in range(3):
                    c, _ = drift_edges(rng, c, DRIFT_FRAC)
                    w = Weights(c, inst.s_weight, inst.t_weight)
                    rt = srv.submit(key, w, tenant=name).result(timeout=900)
                    rp = srv.submit(key, w).result(timeout=900)
                    if not (np.array_equal(rt.voltages, rp.voltages)
                            and rt.cut_value == rp.cut_value):
                        raise AssertionError(f"{name}: tenant request "
                                             f"differs from the no-tenant one")
                    seq.append(rt.telemetry["delta"]["mode"])
                c, k30 = drift_edges(rng, c, 0.30)
                r30 = srv.submit(key, Weights(c, inst.s_weight, inst.t_weight),
                                 tenant=name).result(timeout=900)
                seq.append(r30.telemetry["delta"]["mode"])
                log(f"[delta serve] checked {name}: keyed solve_batch = "
                    f"keyless at B={burst} (bit-equal, "
                    f"{checked[name]['delta_lanes']} delta lanes a batch); "
                    f"server tenant = no-tenant bit-equal, modes {seq} (the "
                    f"last a 30% drift of {k30} edges)")
                if seq != ["cold", "delta", "delta", "full"]:
                    raise AssertionError(f"{name}: server modes {seq}")
                checked[name].update(server_bit_equal=True, server_modes=seq)
            srv_stats = srv.stats()
    finally:
        torch.use_deterministic_algorithms(False)
    if srv_stats["warm"]["entries"] or srv_stats["failed"]:
        raise AssertionError(f"checked server: {srv_stats['warm']}, failed "
                             f"{srv_stats['failed']}")
    return dict(wall_s=run["wall"], solves_per_s=stats["completed"] / run["wall"],
                launches=run["launches"], peak_bytes=run["peak"], modes=modes,
                batch_sizes=stats["batch_sizes"],
                timings={k: dict(median=float(np.median(v)), max=max(v))
                         for k, v in tm.items()},
                checked=checked, cfg=dataclasses.asdict(cfg))


def road_instance(side: int, seed: int):
    """The reference CLI's road family: road_like + flow_improve_instance."""
    from repro_torch.graphs import generators as gen

    return gen.flow_improve_instance(gen.road_like(side, seed=seed),
                                     seed=seed + 1)


def presolve_phase(seed: int, side: int = ROAD_SIDE):
    """Phase 11c: presolve at full width on the road family, in 11b's
    fused-ELL config on the host backend; a keyed sequence whose kernels
    patch; a presolved batch on the scanned program; and the exactness
    check at side 128 in tests/test_presolve.py's STRONG config.  Rounded
    two-level (the solve's default): a sweep of the unpresolved solve can
    stop ~1e-3 above the min cut where the presolved one reaches it."""
    import numpy as np
    import torch

    from repro_torch.core import (IRLSConfig, MinCutSession, Problem, Weights,
                                  max_flow)
    from repro_torch.kernels import ops
    from repro_torch.presolve import patch_kernel
    from repro_torch.presolve.contract import K_EDGE, K_POISON

    cfg = ell_server_cfg()
    t = time.perf_counter()
    inst = road_instance(side, seed)
    gen_s = time.perf_counter() - t
    sess = MinCutSession(Problem.build(inst, n_blocks=1), cfg, backend="host",
                         device="cuda")
    c0 = np.asarray(inst.graph.weight, dtype=np.float64)
    cs, ct = inst.s_weight, inst.t_weight
    torch.cuda.synchronize()
    ops.reset_launches()
    pre = sess.solve(weights=Weights(c0, cs, ct), presolve=True,
                     rounding="two_level", delta_key="road")
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    meta = pre.cut.meta["presolve"]
    cert = meta["certificate"]
    want = host_launches_want(pre.diagnostics.pcg_iters, block=False)
    log(f"[presolve] road {side}: n={inst.n} m={inst.graph.m} (made in "
        f"{gen_s:.1f} s); kernel n={meta['kernel_n']} m={meta['kernel_m']}, "
        f"kernelize {pre.timings['presolve']:.2f} s, IRLS "
        f"{pre.timings['irls']:.2f} s; launches {launches} (expected from "
        f"the PCG trace {want})")
    if launches != want:
        raise AssertionError(f"presolve launches {launches} != {want}")
    if not (abs(cert["rel_gap"]) <= 1e-9
            and pre.cut_value == cert["lifted_cut"]):
        raise AssertionError(f"presolve certificate {cert} vs cut "
                             f"{pre.cut_value}")
    plain = sess.solve(rounding="two_level")
    ratio = pre.cut_value / plain.cut_value
    log(f"[presolve] lifted cut {pre.cut_value!r} vs the solve without "
        f"presolve {plain.cut_value!r}: ratio {ratio!r} (tolerance rel "
        f"1e-3); IRLS without presolve {plain.timings['irls']:.2f} s")
    if not abs(ratio - 1.0) <= 1e-3:
        raise AssertionError(f"presolved cut / plain cut = {ratio}")

    # a keyed sequence: the JAX package patches a kernel when no drifted
    # entry fed a reduction decision.  A random 0.1% of the edges almost
    # always holds such an entry here (probed below); the tenant's drift
    # is drawn among the edges whose weight flows additively into a kernel
    # edge, which the kernel can take by a patch.
    kernel = sess._kernels[next(reversed(sess._kernels))]
    kinds = kernel.wmap.edge_kind
    rng = np.random.default_rng(seed + 14)
    c_rand, k_rand = drift_edges(rng, c0, 1e-3)
    refused = patch_kernel(kernel, (c0, cs, ct), (c_rand, cs, ct)) is None
    hit = int(np.sum(kinds[np.flatnonzero(c_rand != c0)] == K_POISON))
    log(f"[presolve] edges by kind: {int(np.sum(kinds == K_EDGE))} additive "
        f"into kernel edges, {int(np.sum(kinds == K_POISON))} decided a "
        f"reduction; a random 0.1% drift ({k_rand} edges, {hit} of them "
        f"deciding) is refused by revalidation: {refused}")
    actions, cuts, c = [pre.telemetry["presolve"]["action"]], [], c0
    for _ in range(2):
        c, _ = drift_edges(rng, c, 1e-3, among=np.flatnonzero(kinds == K_EDGE))
        r = sess.solve(weights=Weights(c, cs, ct), presolve=True,
                       rounding="two_level", delta_key="road")
        actions.append(r.telemetry["presolve"]["action"])
        cc = r.cut.meta["presolve"]["certificate"]
        cuts.append((r.cut_value, cc["lifted_cut"], cc["rel_gap"],
                     r.telemetry.get("delta", {}).get("mode")))
        if not (r.cut_value == cc["lifted_cut"] and abs(cc["rel_gap"]) <= 1e-9):
            raise AssertionError(f"patched solve certificate {cc}")
    log(f"[presolve] keyed sequence: actions {actions}; (cut, lifted, "
        f"rel_gap, kernel staging) {cuts}")
    if actions[0] != "rebuild" or "patch" not in actions[1:]:
        raise AssertionError(f"presolve actions {actions}")

    # a presolved batch of scaled weights on the scanned program
    # ×1.0 reuses the rebuilt kernel; ×1.5 kernelizes anew (~55 s on the
    # card machine's host, which is why the batch holds two lanes) and is
    # a lane where the adaptive schedule stops the unpresolved solve above
    # the min cut
    scales = (1.0, 1.5)
    ws = [Weights(c0 * s, cs, ct) for s in scales]
    ops.reset_launches()
    t = time.perf_counter()
    batch = sess.solve_batch(ws, presolve=True, rounding="two_level")
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t
    batch_launches = dict(ops.launches)
    plain_b = sess.solve_batch(ws, rounding="two_level")
    rels = [abs(a.cut_value / b.cut_value - 1.0) for a, b in zip(batch, plain_b)]
    log(f"[presolve] solve_batch(presolve=True) B={len(ws)}: {batch_s:.1f} s "
        f"(kernelize {[round(r.timings['presolve'], 2) for r in batch]} s), "
        f"kernel n {[r.telemetry['presolve']['kernel_n'] for r in batch]}; "
        f"launches {batch_launches}; cuts {[a.cut_value for a in batch]} vs "
        f"the unpresolved batch {[b.cut_value for b in plain_b]}: rel "
        f"{[f'{r:.2e}' for r in rels]} (tolerance 1e-3)")
    if batch_launches["fused_ell_sweep"] == 0 or batch_launches["ell_spmv"] == 0:
        raise AssertionError(f"presolved batch launches {batch_launches}")
    # The adaptive schedule (irls_tol 1e-3) can stop the unpresolved solve
    # of a scaled road instance a few percent above its min cut, as it does
    # in the JAX package.  Where a lane misses 1e-3, the exact Dinic cut
    # decides: the presolved lane must be the min cut (rel 1e-6) and the
    # unpresolved one above it.
    exact = {}
    for j, (a, b) in enumerate(zip(batch, plain_b)):
        if rels[j] <= 1e-3:
            continue
        t = time.perf_counter()
        ex = max_flow(sess.problem.instance_with(ws[j])).value
        exact[scales[j]] = dict(exact=ex, presolved=a.cut_value,
                                unpresolved=b.cut_value,
                                seconds=time.perf_counter() - t)
        log(f"[presolve] lane ×{scales[j]}: exact Dinic {ex!r} "
            f"({exact[scales[j]]['seconds']:.1f} s): presolved rel "
            f"{a.cut_value / ex - 1:.2e} (tolerance 1e-6), unpresolved rel "
            f"{b.cut_value / ex - 1:.2e}")
        if not (abs(a.cut_value / ex - 1.0) <= 1e-6
                and b.cut_value >= ex * (1 - 1e-9)):
            raise AssertionError(f"presolved lane ×{scales[j]}: {a.cut_value}"
                                 f" vs unpresolved {b.cut_value}, exact {ex}")

    # exactness at side 128: STRONG on the fused-ELL kernel path vs Dinic
    small = road_instance(128, seed)
    strong = IRLSConfig(n_irls=50, pcg_max_iters=150, precond="jacobi",
                        n_blocks=1, pcg_tol=1e-8, eps=1e-6, layout="ell",
                        fuse_edge_sweep=True, use_pallas=True)
    t = time.perf_counter()
    got = MinCutSession(Problem.build(small, n_blocks=1), strong,
                        device="cuda").solve(presolve=True)
    t_small = time.perf_counter() - t
    exact = max_flow(small).value
    rel = abs(got.cut_value - exact) / exact
    log(f"[presolve] side 128 STRONG: cut {got.cut_value!r} vs exact Dinic "
        f"{exact!r} (rel {rel:.2e}, tolerance 1e-6); kernel n "
        f"{got.cut.meta['presolve']['kernel_n']}; {t_small:.1f} s")
    if not rel <= 1e-6:
        raise AssertionError(f"presolve at side 128 vs Dinic: rel {rel}")
    return dict(n=inst.n, m=inst.graph.m, kernel_n=meta["kernel_n"],
                kernel_m=meta["kernel_m"], kernelize_s=pre.timings["presolve"],
                irls_s=pre.timings["irls"], plain_irls_s=plain.timings["irls"],
                launches=launches, pcg_iters=pre.diagnostics.pcg_iters,
                cut=pre.cut_value, plain_cut=plain.cut_value, ratio=ratio,
                random_drift_refused=refused, random_drift_deciding=hit,
                actions=actions, keyed=cuts, batch_s=batch_s,
                batch_kernelize_s=[r.timings["presolve"] for r in batch],
                batch_launches=batch_launches, batch_rel=rels,
                batch_exact=exact,
                side128=dict(cut=got.cut_value, exact=exact, rel=rel,
                             seconds=t_small))


def cli_runs(out_dir: Path) -> dict:
    """The six CLIs that phases 11d, 12d, 13c and 18c hold, as
    ``start_clis`` takes them: they run side by side on the card in phase
    11d, and each phase checks its own."""
    import shutil

    def json_out(name):
        return ["--json-out", str(out_dir / f"chip_smoke_{name}.json")]

    def ckpt(name):                     # a fresh run: no checkpoint to resume
        d = out_dir / f"chip_smoke_{name}_ckpt"
        shutil.rmtree(d, ignore_errors=True)
        return ["--ckpt-dir", str(d)]

    return {
        "solve": (["-m", "repro_torch.launch.solve", "--family", "road",
                   "--side", "256", "--irls", "20"] + json_out("solve"), 900),
        "mincut_serve": (["-m", "repro_torch.launch.mincut_serve", "--warm",
                          "--presolve", "--drift-sparsity", "0.05"]
                         + json_out("mincut_serve"), 900),
        "cut_tree": (["-m", "repro_torch.launch.cut_tree", "--family",
                      "grid", "--side", str(EXACT_SIDE), "--solver", "irls",
                      "--refine", "--verify-pairs", str(VERIFY_PAIRS)]
                     + json_out("cut_tree"), 600),
        "solve_sharded": (["-m", "repro_torch.launch.solve", "--family",
                           "grid", "--side", "48", "--irls", "10",
                           "--backend", "sharded"]
                          + json_out("solve_sharded"), 600),
        "train_gcn": (["-m", "repro_torch.launch.train", "--arch",
                       "gcn-cora", "--steps", "20"] + ckpt("train_gcn"), 300),
        "train_din": (["-m", "repro_torch.launch.train", "--arch", "din",
                       "--reduced", "--steps", "20"] + ckpt("train_din"),
                      300),
}


def plan_runs(out_dir: Path) -> dict:
    """Phase 19's planning processes, as ``start_clis`` takes them: the
    dryrun CLI on DRYRUN_CELLS (19c) and ``plan_worker`` in two processes
    (19b).  They need host time only (~45 s each at most on the card's
    host), so they start when phase 11's CLIs end and run beside phases
    12–18."""
    def worker(names):
        path = str(out_dir / f"chip_smoke_plans_{'_'.join(names)}.json")
        return (["-c", f"import chip_smoke; chip_smoke.plan_worker({path!r}, "
                 f"{names!r})"], 600)

    return {**{f"dryrun_{arch}": (["-m", "repro_torch.launch.dryrun",
                                   "--arch", arch, "--cell", cell, "--mesh",
                                   "single", "--out",
                                   str(out_dir / "dryrun_torch")], 600)
               for arch, cell in DRYRUN_CELLS},
            "plan_16b": worker(("16b",)),
            "plan_18b_17b": worker(("18b", "17b"))}


def cli_phase(clis: dict, out_dir: Path):
    """Phase 11d: the two CLIs as subprocesses on the card (run by
    ``finish_clis`` beside 12d's and 13c's)."""
    out = {}
    for name in ("solve", "mincut_serve"):
        got = json.loads((out_dir / f"chip_smoke_{name}.json").read_text())
        tail = clis[name]["stdout"].strip().splitlines()[-1]
        log(f"[cli] {name}: {clis[name]['seconds']:.1f} s beside the other "
            f"CLIs; last line: {tail}")
        out[name] = dict(seconds=clis[name]["seconds"], json=got)
    s = out["solve"]["json"]
    keys = {"n", "m", "t_build", "t_problem", "t_irls", "backend",
            "cut_two_level", "t_two_level", "cut_exact", "t_exact",
            "delta_two_level"}
    log(f"[cli] solve: n={s['n']} m={s['m']} cut {s['cut_two_level']!r} vs "
        f"exact {s['cut_exact']!r}: delta_two_level {s['delta_two_level']:.2e} "
        f"(tolerance 1e-3); IRLS {s['t_irls']:.2f} s")
    if set(s) != keys or not abs(s["delta_two_level"]) <= 1e-3:
        raise AssertionError(f"solve CLI: {s}")
    m = out["mincut_serve"]["json"]
    log(f"[cli] mincut_serve: completed {m['completed']}, failed "
        f"{m['failed']}, rejected {m['rejected']}, device {m['device']}, "
        f"{m['solves_per_sec']:.2f} solves/s")
    if not (m["completed"] == 48 and m["failed"] == 0
            and m["device"].startswith("cuda") and "telemetry" in m):
        raise AssertionError(f"mincut_serve CLI: {m}")
    return out


# -- phase 12: cut trees at full width -----------------------------------------

# the cut_tree CLI's --family grid --side 24 (n = 576, m = 1,104), in
# batches of up to 64 pair solves: each pair solve costs ~35-50 ms of
# launches (the batched PCG's per-lane inner products) and each wave ~0.9
# s, so a side-64 tree (~4,800 solves) takes 165-250 s, a side-48 one
# 155-184 s, side 40 133 s (2,115 solves) and side 28 93 s (1,434), more
# than the run can give it beside the other phases; side 24 takes ~45 s
# (1,145 solves in 19 waves).  Side 32 is no cut: its single-node global
# cut sets off speculation that is discarded (1,681 solves for 1,023
# edges, 119.5 s), and its 25 pairs missed Dinic by 7.5e-2
CUTTREE_SIDE, CUTTREE_BATCH = 24, 64
# 12b's route check (in batches of up to ROUTE_BATCH; three builds: 67 s
# at side 10, 51 s at 8, 31 s at 6) and the exact oracles of 12c and 12d,
# at sides where their IRLS builds and repairs fit the run's time and
# where Dinic takes milliseconds a pair (12d's two refined builds ~64 s at
# side 10)
ROUTE_SIDE, ROUTE_BATCH, EXACT_SIDE = 6, 8, 8
# random pair queries on the finished tree; pairs checked against Dinic
# (the reference CLI's --verify-pairs gate at its --verify-rtol 1e-3)
TREE_QUERIES, VERIFY_PAIRS = 10000, 25
# IRLS iterations of the profiled cut-tree wave (of DEFAULT_CFG's 16)
PROFILE_IRLS = 2
# tests/test_drift.py's strong config for an IRLS repair
STRONG_REPAIR = dict(n_irls=40, pcg_max_iters=120, precond="jacobi",
                     n_blocks=1, pcg_tol=1e-8, eps=1e-6)


def cuttree_instance(side: int, seed: int):
    """The cut_tree CLI's ``--family grid --side side``."""
    from repro_torch.launch.cut_tree import build_instance

    return build_instance("grid", side, seed)


def kernel_cfg():
    """The cut-tree build's default config with ``edge_reweight``."""
    from repro_torch.cuttree import DEFAULT_CFG

    return dataclasses.replace(DEFAULT_CFG, use_pallas=True)


def dinic_pair(inst, u: int, v: int) -> float:
    """The exact u-v min cut of the non-terminal graph (the port's Dinic
    on the pair's rebound terminals)."""
    from repro_torch.core import max_flow
    from repro_torch.core.session import rebind_terminals
    from repro_torch.graphs.structures import STInstance

    w = rebind_terminals(inst, u, v)
    return max_flow(STInstance(graph=inst.graph, s_weight=w.c_s,
                               t_weight=w.c_t)).value


def with_weights(inst, c):
    from repro_torch.graphs.structures import EdgeList, STInstance

    return STInstance(graph=EdgeList(src=inst.graph.src, dst=inst.graph.dst,
                                     weight=c, n=inst.n),
                      s_weight=inst.s_weight, t_weight=inst.t_weight)


def tree_rel(a, b) -> float:
    """Largest relative gap of tree ``a``'s min cuts to ``b``'s, over all
    pairs."""
    import numpy as np

    x, y = a.min_cut_matrix(), b.min_cut_matrix()
    off = ~np.eye(a.n, dtype=bool)
    return float(np.max(np.abs(x[off] - y[off]) / np.abs(y[off])))


def same_tree(a, b) -> bool:
    """Parent, weight, stored sides and acceptance order all equal."""
    import numpy as np

    return (np.array_equal(a.parent, b.parent)
            and np.array_equal(a.weight, b.weight)
            and np.array_equal(a.sides, b.sides)
            and a.meta["order"] == b.meta["order"])


def solve_batch_calls(tree, max_batch: int) -> int:
    """``solve_batch`` calls of an IRLS build: each wave's pairs in chunks
    of ``max_batch``."""
    return sum(-(-w // max_batch) for w in tree.meta["wave_sizes"])


def built_tree(label: str, fn, n_irls: int = 0,
               max_batch: int = CUTTREE_BATCH):
    """``fn()`` → a cut tree (a build or a repair), with its seconds and
    ``edge_reweight`` launches: ``n_irls`` (the IRLS iterations of the
    kernel route's config; 0 for Dinic and the plain route) for every
    ``solve_batch`` call, and no other kernel."""
    import torch

    from repro_torch.kernels import ops

    before = dict(ops.launches)
    t = time.perf_counter()
    tree = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launched = {k: ops.launches[k] - before[k] for k in before}
    m = tree.meta
    want = dict(NO_LAUNCHES)
    if n_irls:
        want["edge_reweight"] = n_irls * solve_batch_calls(tree, max_batch)
    log(f"[cuttree] {label}: {secs:.2f} s, {m['n_solves']} solves in "
        f"{m.get('n_waves', m['n_solves'])} waves, edge_reweight launches "
        f"{launched['edge_reweight']} (expected {want['edge_reweight']})")
    if launched != want:
        raise AssertionError(f"{label}: launches {launched} != {want}")
    return tree, secs, launched["edge_reweight"]


def span_breakdown(agg) -> dict:
    """Where a traced build's wall went, from the dashboard's aggregate:
    the batched solves (their IRLS and rounding apart) and the host work
    around them (pair weights, graph cut values, speculation and splits)."""
    build = agg["cuttree.build"]["total_s"]
    wave = "cuttree.build>cuttree.wave"
    batch = wave + ">session.solve_batch"
    parts = {"solve_batch": agg[batch]["total_s"],
             "irls": agg[batch + ">session.irls"]["total_s"],
             "rounding": agg[batch + ">session.rounding"]["total_s"],
             "solve_batch_self": agg[batch]["self_s"],
             "wave_self": agg[wave]["self_s"],
             "build_self": agg["cuttree.build"]["self_s"]}
    return dict(build_s=build, seconds=parts,
                share={k: v / build for k, v in parts.items()})


def cuttree_build_phase(side: int, seed: int, out_dir: Path):
    """Phase 12a: the IRLS cut tree of the full-width grid through
    ``edge_reweight``, traced to a JSONL sink, with its queries, a Dinic
    sample, the dashboard's span breakdown, one wave profiled and the
    kernel alone at the build's widest batch."""
    import numpy as np
    import torch

    from repro_torch.core import MinCutSession, Problem
    from repro_torch.cuttree import build_cut_tree, pin_pairs
    from repro_torch.kernels import ops
    from repro_torch.obs import dashboard, trace

    inst = cuttree_instance(side, seed)
    cfg = kernel_cfg()
    sink = out_dir / "chip_smoke_cuttree.jsonl"
    sink.unlink(missing_ok=True)
    trace.clear()
    trace.configure(jsonl=str(sink))
    torch.cuda.synchronize()
    ops.reset_launches()
    try:
        tree, wall, _ = built_tree(
            f"grid side {side} (n={inst.n} m={inst.graph.m})",
            lambda: build_cut_tree(inst, solver="irls", cfg=cfg,
                                   max_batch=CUTTREE_BATCH, rounding="sweep",
                                   device="cuda"), cfg.n_irls)
    finally:
        trace.configure(enabled=False, jsonl="")
        trace.clear()
    launches = dict(ops.launches)
    m = tree.meta
    calls = solve_batch_calls(tree, CUTTREE_BATCH)
    spans, _ = dashboard.load_spans(str(sink))
    n_batch_spans = sum(s["name"] == "session.solve_batch" for s in spans)
    log(f"[cuttree] t_solve_s {m['t_solve_s']:.2f}, {m['n_solves']} solves "
        f"for {m['n_pairs']} tree edges (speculation discarded "
        f"{m['speculation_discarded']}), {m['pairs_per_sec']:.1f} pairs/s; "
        f"{calls} solve_batch calls ({n_batch_spans} traced)")
    if n_batch_spans != calls:
        raise AssertionError(f"traced batches {n_batch_spans} != {calls}")

    # -- queries on the finished tree, and a sample against Dinic
    gval, gside = tree.global_min_cut()
    rng = np.random.default_rng(seed + 12)
    pairs = [tuple(int(x) for x in rng.choice(tree.n, 2, replace=False))
             for _ in range(TREE_QUERIES)]
    t = time.perf_counter()
    vals = tree.min_cut_batch(pairs)
    query_us = (time.perf_counter() - t) / len(pairs) * 1e6
    t = time.perf_counter()
    rels = [abs(tree.min_cut(u, v) - ex) / abs(ex)
            for (u, v), ex in ((p, dinic_pair(inst, *p))
                               for p in pairs[:VERIFY_PAIRS])]
    t_verify = time.perf_counter() - t
    log(f"[cuttree] global min cut {gval!r} (|S|={int(gside.sum())}); "
        f"{len(pairs)} pair queries at {query_us:.2f} us each (median "
        f"{float(np.median(vals)):.4g}); {VERIFY_PAIRS} pairs vs Dinic max "
        f"rel {max(rels):.2e} (tolerance 1e-3) in {t_verify:.1f} s")
    if not (np.isfinite(vals).all() and max(rels) <= 1e-3):
        raise AssertionError(f"cut-tree pairs vs Dinic: max rel {max(rels)}")

    # -- the span dashboard over the build's sink
    agg = dashboard.aggregate(spans)
    text = dashboard.render(agg, title=f"cut tree, grid side {side}")
    (out_dir / "chip_smoke_cuttree_spans.txt").write_text(text + "\n")
    for line in text.splitlines():
        log(f"[cuttree] {line}")
    spans_out = span_breakdown(agg)
    sh = spans_out["share"]
    log(f"[cuttree] build wall shares: solve_batch {sh['solve_batch']:.3f} "
        f"(IRLS {sh['irls']:.3f}, rounding {sh['rounding']:.3f}, staging "
        f"and checks {sh['solve_batch_self']:.3f}); host outside the "
        f"solves: pair weights and cut values {sh['wave_self']:.3f}, "
        f"speculation and splits {sh['build_self']:.3f}")

    # -- one wave's batch (64 pairs against the root), its first
    # PROFILE_IRLS IRLS iterations profiled: a whole wave launches ~300,000
    # kernels, whose trace the profiler takes minutes to read back
    prob = Problem.build(inst, n_blocks=1)
    sess = MinCutSession(prob, cfg, backend="scanned", device="cuda")
    ws = pin_pairs(prob, [(i, 0) for i in range(1, min(CUTTREE_BATCH,
                                                       inst.n - 1) + 1)])
    window = dataclasses.replace(cfg, n_irls=PROFILE_IRLS)

    def wave():
        return sess.solve_batch(ws, rounding="sweep", cfg=window,
                                pad_to=CUTTREE_BATCH)

    wave()
    prof = profile_call(wave, f"a cut-tree wave of {CUTTREE_BATCH} pairs, "
                              f"{PROFILE_IRLS} IRLS iterations")

    # -- edge_reweight alone at the build's widest batch
    er = edge_reweight_alone(prob, cfg.eps, seed, lane_counts=(CUTTREE_BATCH,),
                             label="cut tree ")[CUTTREE_BATCH]
    return dict(n=inst.n, m=inst.graph.m, wall_s=wall,
                meta={k: v for k, v in m.items()
                      if k not in ("order", "wave_sizes")},
                wave_sizes=m["wave_sizes"], solve_batch_calls=calls,
                launches=launches, global_min_cut=gval, query_us=query_us,
                verify_max_rel=max(rels), verify_s=t_verify,
                spans=spans_out, profile=prof, edge_reweight=er,
                sink=str(sink))


def cuttree_route_phase(side: int, seed: int):
    """Phase 12b: the same build through ``edge_reweight`` and on the
    plain route, both on the card, under deterministic algorithms: the
    kernel is bit-equal to its plain version, so the trees must be the
    same, and a second kernel-route build the same again."""
    import torch

    from repro_torch.cuttree import build_cut_tree

    inst = cuttree_instance(side, seed)
    cfg = kernel_cfg()
    out = {}
    torch.use_deterministic_algorithms(True)
    try:
        for label, use_pallas in (("kernel", True), ("plain", False),
                                  ("kernel again", True)):
            run = dataclasses.replace(cfg, use_pallas=use_pallas)
            out[label] = built_tree(
                f"{label} route, side {side}",
                lambda: build_cut_tree(inst, solver="irls", cfg=run,
                                       max_batch=ROUTE_BATCH,
                                       rounding="sweep", device="cuda"),
                run.n_irls if use_pallas else 0, ROUTE_BATCH)
    finally:
        torch.use_deterministic_algorithms(False)
    kern, plain, again = (out[k][0] for k in ("kernel", "plain",
                                              "kernel again"))
    equal = same_tree(kern, plain), same_tree(kern, again)
    log(f"[cuttree] side {side}: kernel tree == plain tree {equal[0]}, == "
        f"second kernel tree {equal[1]}")
    if not all(equal):
        raise AssertionError(f"route trees differ: {equal}")
    return dict(n=inst.n, seconds={k: v[1] for k, v in out.items()},
                launches={k: v[2] for k, v in out.items()},
                n_solves=kern.meta["n_solves"], n_waves=kern.meta["n_waves"])


def cuttree_exact_phase(side: int, seed: int):
    """Phase 12c: at a side where Dinic is cheap, the exact tree,
    Gomory–Hu, and both repairs of a 1% drift against a fresh exact build.
    Returns the phase's record and (instance, exact tree, drifted weights,
    fresh exact tree) for 12d."""
    import numpy as np

    from repro_torch.core import IRLSConfig
    from repro_torch.cuttree import build_cut_tree, repair_cut_tree

    inst = cuttree_instance(side, seed)
    secs = {}
    exact, secs["exact"], _ = built_tree(
        f"exact tree, side {side}",
        lambda: build_cut_tree(inst, solver="exact"))
    gh, secs["gomory_hu"], _ = built_tree(
        f"Gomory-Hu, side {side}",
        lambda: build_cut_tree(inst, solver="exact", contract=True))
    gh_rel = tree_rel(gh, exact)
    log(f"[cuttree] side {side}: Gomory-Hu vs exact tree, all pairs "
        f"{gh_rel:.2e} (tolerance 1e-9)")
    if not gh_rel <= 1e-9:
        raise AssertionError(f"side {side}: Gomory-Hu vs exact {gh_rel}")

    # -- a 1% drift: exact and IRLS repairs against a fresh exact build
    c = np.asarray(inst.graph.weight, dtype=np.float64)
    c_new, k = drift_edges(np.random.default_rng(seed + 12), c, DRIFT_FRAC)
    inst_new = with_weights(inst, c_new)
    fresh, secs["fresh_exact"], _ = built_tree(
        f"fresh exact tree after a drift of {k} edges",
        lambda: build_cut_tree(inst_new, solver="exact"))
    rep, secs["repair_exact"], _ = built_tree(
        "exact repair",
        lambda: repair_cut_tree(inst_new, exact, c, c_new, solver="exact"))
    strong = IRLSConfig(**STRONG_REPAIR, use_pallas=True)
    rep_irls, secs["repair_irls"], _ = built_tree(
        "kernel IRLS repair (strong config)",
        lambda: repair_cut_tree(inst_new, exact, c, c_new, solver="irls",
                                cfg=strong, rounding="sweep", device="cuda"),
        strong.n_irls)
    rep_rel, irls_rel = tree_rel(rep, fresh), tree_rel(rep_irls, fresh)
    log(f"[cuttree] repairs of {k} drifted edges: exact reused "
        f"{rep.meta['n_reused']}, solved {rep.meta['n_solves']}, vs fresh "
        f"{rep_rel:.2e} (1e-9); IRLS reused {rep_irls.meta['n_reused']}, "
        f"solved {rep_irls.meta['n_solves']}, vs fresh {irls_rel:.2e} (1e-6)")
    if not (rep_rel <= 1e-9 and rep.meta["n_reused"] > 0
            and irls_rel <= 1e-6):
        raise AssertionError(f"repairs: exact {rep_rel} (reused "
                             f"{rep.meta['n_reused']}), IRLS {irls_rel}")
    record = dict(n=inst.n, seconds=secs, gomory_hu_rel=gh_rel,
                  drifted_edges=k,
                  repair_exact=dict(rel=rep_rel, n_reused=rep.meta["n_reused"],
                                    n_solves=rep.meta["n_solves"]),
                  repair_irls=dict(rel=irls_rel,
                                   n_reused=rep_irls.meta["n_reused"],
                                   n_solves=rep_irls.meta["n_solves"]))
    return record, (inst, exact, c_new, fresh)


def cuttree_service_phase(ctx, seed: int, sink: str, out_dir: Path,
                          cut_tree_cli: dict):
    """Phase 12d: ``CutTreeService`` on 12c's instance through the kernel:
    the first query builds the refined IRLS tree (built twice, the second
    time by a fresh service: the same tree; held against Dinic edge
    by edge and against 12c's exact tree on every pair), the next 1,000
    hit the cache, the drift is repaired, the same weights again leave it
    unchanged; then the cut_tree and obs CLIs as subprocesses."""
    import os

    import numpy as np

    from repro_torch.serve import CutTreeService

    inst, exact, c_new, fresh = ctx
    cfg = kernel_cfg()
    svc = CutTreeService(cfg=cfg, solver="irls", refine=True, device="cuda")
    key = svc.register(inst)
    refined, t_build, launched = built_tree(
        "service: first query, a refined IRLS tree",
        lambda: (svc.min_cut(key, 0, inst.n - 1), svc.tree(key))[1],
        cfg.n_irls)
    # the repair: built again by a fresh service, the refined tree is the
    # same (no atomics in the solves' scatters or the sweep rounding)
    svc2 = CutTreeService(cfg=cfg, solver="irls", refine=True, device="cuda")
    key2 = svc2.register(inst)
    twice, _, _ = built_tree(
        "service: the same refined tree again",
        lambda: (svc2.min_cut(key2, 0, inst.n - 1), svc2.tree(key2))[1],
        cfg.n_irls)
    log(f"[cuttree] refined tree built twice: equal {same_tree(refined, twice)}"
        f" (parent, weight, sides, acceptance order)")
    if not same_tree(refined, twice):
        raise AssertionError("the refined tree differs between two builds")
    del svc2, twice
    t = time.perf_counter()
    edge_rel = max(abs(w - dinic_pair(inst, i, p)) / abs(w)
                   for i, p, w in refined.edges())
    t_edges = time.perf_counter() - t
    # Every refined edge is its pair's exact cut, so by the min cut's
    # ultrametric inequality every pair's path minimum is a lower bound of
    # its exact cut.  Where the IRLS sides attached a node under the wrong
    # representative the bound is loose: the JAX package's refined trees
    # miss the exact tree by up to ~7e-2 on a few pairs at grid sides 10,
    # 12, 16 and 24 (ROADMAP queue 3), so the pairs are held to the bound
    # and the gap is logged.
    x, y = refined.min_cut_matrix(), exact.min_cut_matrix()
    off = ~np.eye(inst.n, dtype=bool)
    gap = (y[off] - x[off]) / y[off]
    g_rel = abs(refined.global_min_cut()[0] - exact.global_min_cut()[0]) \
        / abs(exact.global_min_cut()[0])
    log(f"[cuttree] refined edges vs Dinic max rel {edge_rel:.2e} "
        f"(tolerance 1e-9; {refined.meta['refine_changed_edges']} edges "
        f"corrected, checked in {t_edges:.1f} s); every pair at most its "
        f"exact cut: least gap {gap.min():.2e} (tolerance -1e-9); pairs "
        f"more than 1e-3 below it {int((gap > 1e-3).sum()) // 2} of "
        f"{off.sum() // 2}, largest gap {gap.max():.2e}; global min cut "
        f"{g_rel:.2e} (1e-3)")
    if not (edge_rel <= 1e-9 and gap.min() >= -1e-9 and g_rel <= 1e-3):
        raise AssertionError(f"refined tree: edges {edge_rel}, least gap "
                             f"{gap.min()}, global {g_rel}")
    rng = np.random.default_rng(seed + 13)
    for _ in range(1000):
        u, v = rng.choice(inst.n, 2, replace=False)
        svc.min_cut(key, int(u), int(v))
    st = svc.tree_stats
    t = time.perf_counter()
    what = svc.update_weights(key, c_new)
    t_update = time.perf_counter() - t
    rel = tree_rel(svc.tree(key), fresh)
    again = svc.update_weights(key, c_new)
    stats = svc.stats()
    log(f"[cuttree] service: tree cache {stats['tree_cache']}; "
        f"update_weights -> {what!r} in {t_update:.2f} s (vs fresh exact "
        f"{rel:.2e}, tolerance 1e-9), then {again!r}; query p50 "
        f"{stats['query_p50_us']:.2f} us, p99 {stats['query_p99_us']:.2f} us")
    if not (st.misses == 1 and st.hits >= 1000 and what == "repaired"
            and rel <= 1e-9 and again == "unchanged"):
        raise AssertionError(f"service: misses {st.misses}, hits {st.hits}, "
                             f"{what}, rel {rel}, {again}")

    path = out_dir / "chip_smoke_cut_tree.json"
    clis = {"cut_tree": {k: cut_tree_cli[k] for k in ("seconds", "rc",
                                                      "stdout")}}
    log(f"[cli] cut_tree: {clis['cut_tree']['seconds']:.1f} s beside 11d's "
        f"CLIs; {clis['cut_tree']['stdout'].strip().splitlines()[-1]}")
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.obs",
                           sink], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                          capture_output=True, text=True, timeout=600)
    clis["obs"] = dict(seconds=time.perf_counter() - t, rc=proc.returncode,
                       stdout=proc.stdout)
    (out_dir / "chip_smoke_obs.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise AssertionError(f"obs CLI exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    log(f"[cli] obs: {clis['obs']['seconds']:.1f} s; "
        f"{proc.stdout.strip().splitlines()[0]}")
    got = json.loads(path.read_text())
    log(f"[cli] cut_tree: verify_max_rel {got['verify_max_rel']:.2e} "
        f"(tolerance 1e-3), {got['meta']['n_solves']} solves")
    if not (got["verify_max_rel"] <= 1e-3 and got["n"] == inst.n
            and "cuttree.build" in clis["obs"]["stdout"]):
        raise AssertionError(f"cut_tree CLI: {got['verify_max_rel']}, obs "
                             f"CLI output lacks the build span")
    del clis["obs"]["stdout"], clis["cut_tree"]["stdout"]
    return dict(build_s=t_build, build_launches=launched,
                refined_edge_rel=edge_rel, refined_least_gap=gap.min(),
                refined_max_gap=gap.max(),
                refined_pairs_off=int((gap > 1e-3).sum()) // 2,
                refined_global_rel=g_rel,
                refine_changed_edges=refined.meta["refine_changed_edges"],
                edge_check_s=t_edges, update_s=t_update, update=what,
                repaired_rel=rel, again=again, stats=stats, cli=clis,
                cli_json={k: got[k] for k in ("n", "m", "global_min_cut",
                                             "query_us", "verify_max_rel")})

# -- phase 13: the sharded solver ---------------------------------------------

# IRLS iterations of phase 13's fixed-schedule solves (cut from phase 4's
# 50: every iteration runs its full 50 CG steps, and six full-width solves
# must fit the phase's share of the run)
SHARD_IRLS = 10
# 13b: a world of four ranks on the one card, at 48³
SHARD_RANKS, SHARD_SIDE = 4, 48
# 13a's routes: (schedule, fuse_edge_sweep, the route's kernel)
SHARD_ROUTES = {"halo_fused": ("halo", True, "fused_ell_sweep"),
                "halo_unfused": ("halo", False, "edge_reweight"),
                "psum": ("psum", True, "edge_reweight")}
# eps of 13a's kernel-route-vs-plain-route solves, held at rel 1e-5: at
# phase 4's 1e-6 the fixed schedule's 50 CG steps an iteration run far
# past convergence and carry fused_ell_sweep's other order of each row's
# sum into the sweep cut as noise; at 1e-3, as the CPU parity tests hold
# the packages, the solves converge
SHARD_HELD_EPS = 1e-3
# 13b's solves: (schedule, halo compression)
SHARD_RANK_ROUTES = {"halo_fused": ("halo", None), "psum": ("psum", None),
                     "halo_int8": ("halo", "int8")}
# each rank's collectives per CG step, as the CPU tests hold them
SHARD_STEP_OPS = {"halo": {"all_gather": 1.0, "all_reduce": 2.0,
                           "calls": 3.0},
                  "psum": {"all_reduce": 1.0, "calls": 1.0},
                  "halo_int8": {"all_gather": 2.0, "all_reduce": 2.0,
                                "calls": 4.0}}


def shard_cfg(cfg, fuse: bool = True):
    """Phase 4's kernel config at phase 13's depth."""
    return dataclasses.replace(cfg, n_irls=SHARD_IRLS, fuse_edge_sweep=fuse)


def step_ops(stats) -> dict:
    return {op: v for op, v in stats["per_pcg_step"].items() if op != "bytes"}


def shard_kernels_held(solver, eps: float, seed: int, label: str) -> dict:
    """The sharded path's kernels on this rank's shard tensors — the ELL
    columns into ``[v_local | halo]``, the copies' heads and tails, or the
    psum edge chunk against the replicated vector — against their plain
    versions, at phase 3's and phase 7's tolerances.  Voltages from the
    seed; no launch here counts for a path."""
    import torch

    from repro_torch.core import laplacian as lap
    from repro_torch.kernels import ops, ref

    t = solver._t
    dev = t["c"].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    if solver.schedule == "halo":
        nv = solver.plan.nl + solver.p * solver.plan.b_sh
        ext = torch.rand(nv, generator=gen, device=dev)
        if solver.ell is not None:
            args = (t["cols32"], t["c_ell"], t["c_s"], t["c_t"], ext, eps)
            out["fused_ell_sweep"] = dict(
                shape=list(t["cols32"].shape) + [nv],
                max_abs_err=check_close(
                    f"{label} fused_ell_sweep", ops.fused_ell_sweep(*args),
                    lap.fused_ell_sweep(*args), 3e-5))
        args = (t["heads32"], t["tails32"], t["c"], ext, eps)
    else:
        ext = torch.rand(solver.plan.n_pad, generator=gen, device=dev)
        args = (t["src32"], t["dst32"], t["c"], ext, eps)
    out["edge_reweight"] = dict(
        shape=[args[0].shape[0], ext.shape[0]],
        max_abs_err=check_close(f"{label} edge_reweight",
                                [ops.edge_reweight_r(*args)],
                                [ref.edge_reweight_ref(*args)], 0.0))
    return out


def sharded_solve(inst, cfg, schedule: str, labels, plans=None,
                  compression=None, rounding="sweep"):
    """One sharded solve on this rank, launch counters set to 0 just before
    and read just after, its voltages rounded by ``rounding`` (None: not
    rounded); returns (record, solver)."""
    import numpy as np
    import torch

    from repro_torch.core import round_voltages
    from repro_torch.distributed.solver import ShardedSolver
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    t = time.perf_counter()
    solver = ShardedSolver(inst, cfg, schedule=schedule, labels=labels,
                           plans=plans, halo_compression=compression,
                           device=torch.device("cuda",
                                               torch.cuda.current_device()))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    ops.reset_launches()
    t = time.perf_counter()
    v, rels, iters = solver.solve()
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t
    launches = dict(ops.launches)
    stats = solver.collective_stats()
    rec = dict(setup_s=setup_s, solve_s=solve_s, launches=launches,
               pcg_steps=stats["pcg_steps"], pcg_iters=iters.tolist(),
               per_pcg_step=stats["per_pcg_step"], scopes=stats["scopes"],
               finite=bool(np.isfinite(v).all()))
    if rounding is not None:
        t = time.perf_counter()
        rec["cut"] = round_voltages(rounding, inst, v,
                                    device="cuda").cut_value
        rec["rounding_s"] = time.perf_counter() - t
        rec["rounding"] = rounding
    return rec, solver


def sharded_world_one_phase(inst, labels, cfg, host_cut: float, seed: int):
    """Phase 13a: the sharded solver in a world of one over NCCL (the
    solver initializes it), at full width: phase 4's 96³ instance, labels
    and kernel config, on three routes (halo with the fused sweep, halo
    unfused, psum).  Each route runs once as a user runs it (the walls,
    the launches, the cut against the host's, and its kernels held at the
    world-one shard's shapes), then on the kernel route and the plain
    route under deterministic algorithms at ``SHARD_HELD_EPS`` (the cuts
    held against each other; the deterministic ``index_add_`` of the
    unfused and psum builds is several times slower, so those walls do
    not stand for the route's).  Then the 48³ instance of 13b on the
    kernel route, rounded two-level, for 13b to hold its world of four
    against and held itself against the host solve's two-level cut
    there."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import MinCutSession, Problem
    from repro_torch.distributed import solver as dsolver
    from repro_torch.distributed import spmv

    out = {}
    # the plans of each schedule, built once and shared by its routes
    t = time.perf_counter()
    halo = spmv.build_halo_plan(inst, 1, labels=labels)
    block = dsolver.build_halo_block_plan(halo, 128)
    ell = spmv.build_halo_ell(halo)
    out["halo_plans_s"] = time.perf_counter() - t
    plans = {"halo_fused": (halo, block, ell), "halo_unfused": (halo, block),
             "psum": None}
    log(f"[sharded 1] halo plans at world one in {out['halo_plans_s']:.1f} s:"
        f" nl {halo.nl}, copies {halo.heads.shape[1]}, ELL k {ell.k}, "
        f"{block.nb} blocks of {block.bs}")
    for route, (schedule, fuse, kernel) in SHARD_ROUTES.items():
        rc = shard_cfg(cfg, fuse)
        m, solver = sharded_solve(inst, rc, schedule, labels,
                                  plans=plans[route])
        m["kernels"] = shard_kernels_held(solver, rc.eps, seed,
                                          f"[sharded 1] {route}")
        del solver
        held = dataclasses.replace(rc, eps=SHARD_HELD_EPS)
        run = lambda use_pallas: sharded_solve(
            inst, dataclasses.replace(held, use_pallas=use_pallas), schedule,
            labels, plans=plans[route])[0]
        torch.use_deterministic_algorithms(True)
        try:
            k, p = run(True), run(False)
        finally:
            torch.use_deterministic_algorithms(False)
        want = dict(NO_LAUNCHES, **{kernel: rc.n_irls})
        rel = abs(k["cut"] - p["cut"]) / abs(p["cut"])
        # signed: the fixed schedule takes all its CG steps in every IRLS
        # iteration where the host loop stops at its tolerance, and lands
        # on lower sweep cuts (0.37% lower at 32³ on the CPU), so only a
        # cut ABOVE the host's is a fault
        above = (m["cut"] - host_cut) / abs(host_cut)
        log(f"[sharded 1] {route}: setup {m['setup_s']:.2f} s, solve "
            f"{m['solve_s']:.2f} s ({m['pcg_steps']} CG steps), launches "
            f"{m['launches']}; per CG step {m['per_pcg_step']}; cut "
            f"{m['cut']!r}, {above:+.3e} of phase 4's host cut "
            f"{host_cut!r} (tolerance +1e-3); at eps {SHARD_HELD_EPS} under "
            f"deterministic algorithms: kernel route {k['cut']!r} in "
            f"{k['solve_s']:.2f} s vs plain route {p['cut']!r} in "
            f"{p['solve_s']:.2f} s (rel {rel:.2e}, tolerance 1e-5)")
        if (m["launches"] != want or k["launches"] != want
                or p["launches"] != NO_LAUNCHES):
            raise AssertionError(f"sharded {route} launches {m['launches']} "
                                 f"(plain {p['launches']}), want {want}")
        if step_ops(m) != SHARD_STEP_OPS[schedule]:
            raise AssertionError(f"sharded {route} collectives per step "
                                 f"{m['per_pcg_step']}")
        if not (m["finite"] and k["finite"] and p["finite"] and rel <= 1e-5
                and above <= 1e-3):
            raise AssertionError(f"sharded {route}: cut {m['cut']} (host "
                                 f"{host_cut}); deterministic kernel route "
                                 f"{k['cut']} vs plain {p['cut']} (rel {rel})")
        out[route] = dict(measured=m, kernel=k, plain=p, rel_plain=rel,
                          rel_host=above)
        torch.cuda.empty_cache()
    out["backend"] = str(dist.get_backend())
    out["world_size"] = dist.get_world_size()
    # 13b's instance at world one, the kernel route, rounded two-level:
    # the world sizes sum the inner products in other orders, and at
    # eps = 1e-6 the sweep's threshold follows that noise (2.4e-5 apart on
    # a 32³ grid on the CPU) where the two-level cut does not
    inst4 = segmentation_grid(SHARD_SIDE, seed)
    labels4, p4 = box_labels(SHARD_SIDE)
    cfg4 = shard_cfg(dataclasses.replace(cfg, n_blocks=p4))
    t = time.perf_counter()
    host4 = MinCutSession(Problem.build(inst4, n_blocks=p4, labels=labels4),
                          cfg4, device="cuda").solve(rounding="two_level")
    out["side48_host"] = dict(cut=host4.cut_value,
                              seconds=time.perf_counter() - t)
    out["side48"] = {}
    for route, (schedule, comp) in SHARD_RANK_ROUTES.items():
        if comp is None:
            r = sharded_solve(inst4, cfg4, schedule, labels4,
                              rounding="two_level")[0]
            r["rel_host"] = abs(r["cut"] - host4.cut_value) / host4.cut_value
            out["side48"][route] = r
    log(f"[sharded 1] {SHARD_SIDE}³ at world one, two-level: host "
        f"{host4.cut_value!r}; "
        + ", ".join(f"{r} {x['cut']!r} (rel {x['rel_host']:.2e}, tolerance "
                    f"1e-6) in {x['solve_s']:.2f} s + {x['rounding_s']:.2f} "
                    f"s rounding" for r, x in out["side48"].items()))
    if not all(x["finite"] and x["rel_host"] <= 1e-6
               for x in out["side48"].values()):
        raise AssertionError(f"sharded {SHARD_SIDE}³ two-level cuts vs host "
                             f"{host4.cut_value}: {out['side48']}")
    return out


def _sharded_rank(rank: int, store: str, out_path: str, seed: int,
                  cfg) -> None:
    """One rank of 13b (a spawned process): gloo over CUDA tensors, every
    rank on the one card."""
    import datetime
    import warnings

    import torch
    import torch.distributed as dist

    from repro_torch.distributed.solver import Float32DivergenceWarning

    warnings.simplefilter("ignore", Float32DivergenceWarning)
    dist.init_process_group("gloo", store=dist.FileStore(store, SHARD_RANKS),
                            rank=rank, world_size=SHARD_RANKS,
                            timeout=datetime.timedelta(seconds=300))
    torch.cuda.set_device(0)
    # gloo must take CUDA tensors as they are: no copy to the CPU here
    x = torch.full((3,), float(rank + 1), device="cuda")
    dist.all_reduce(x)
    parts = [torch.empty_like(x) for _ in range(SHARD_RANKS)]
    dist.all_gather(parts, x)
    if not (x.is_cuda and float(x[0]) == SHARD_RANKS * (SHARD_RANKS + 1) / 2
            and [float(p[0]) for p in parts] == [10.0] * SHARD_RANKS):
        raise AssertionError(f"gloo collectives on CUDA tensors: {x}, {parts}")
    inst = segmentation_grid(SHARD_SIDE, seed)
    labels, _ = box_labels(SHARD_SIDE)
    out = {"backend": str(dist.get_backend())}
    for route, (schedule, comp) in SHARD_RANK_ROUTES.items():
        rounding = None if rank else "sweep" if comp else "two_level"
        rec, solver = sharded_solve(inst, cfg, schedule, labels,
                                    compression=comp, rounding=rounding)
        rec["kernels"] = shard_kernels_held(solver, cfg.eps, seed + rank,
                                            f"[sharded 4] rank {rank} "
                                            f"{route}")
        rec["plan"] = dict(nl=getattr(solver.plan, "nl", None),
                           b_sh=getattr(solver.plan, "b_sh", None),
                           n_pad=getattr(solver.plan, "n_pad", None))
        out[route] = rec
        del solver
    if rank == 0:
        Path(out_path).write_text(json.dumps(out))
    dist.destroy_process_group()


def run_ranks(target, out_path: Path, args: tuple,
              timeout_s: float = 600) -> float:
    """``target(rank, store, out_path, *args)`` in SHARD_RANKS spawned
    processes on the one card (one intra-op thread each: they share the
    host), rendezvousing through a FileStore; every rank that outlives
    ``timeout_s`` is killed, and a killed rank or a non-zero exit fails
    the phase.  Returns the wall seconds."""
    import multiprocessing as mp
    import os
    import tempfile

    ctx = mp.get_context("spawn")
    out_path.unlink(missing_ok=True)
    env_before = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"      # four ranks share the host
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=target,
                             args=(r, os.path.join(tmp, "store"),
                                   str(out_path)) + tuple(args))
                 for r in range(SHARD_RANKS)]
        for p in procs:
            p.start()
        deadline = time.perf_counter() + timeout_s
        for p in procs:
            p.join(max(1.0, deadline - time.perf_counter()))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
    if env_before is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = env_before
    codes = [p.exitcode for p in procs]
    if alive or any(c != 0 for c in codes):
        raise AssertionError(f"{target.__name__} ranks exited {codes} "
                             f"({len(alive)} killed at the deadline)")
    return time.perf_counter() - t


def sharded_ranks_phase(cfg, world_one: dict, seed: int, out_dir: Path):
    """Phase 13b: a world of four ranks on the one card at 48³ (spawned
    processes, gloo over CUDA tensors: NCCL refuses two ranks on one
    device), both schedules and the int8 halo; cuts against 13a's world
    one (rel 1e-5), collectives per CG step as in the CPU tests, each
    rank's kernels held at its shard's shapes."""
    _, p4 = box_labels(SHARD_SIDE)
    cfg4 = shard_cfg(dataclasses.replace(cfg, n_blocks=p4))
    out_path = out_dir / "chip_smoke_sharded4.json"
    wall = run_ranks(_sharded_rank, out_path, (seed, cfg4))
    got = json.loads(out_path.read_text())
    for route, (schedule, comp) in SHARD_RANK_ROUTES.items():
        r = got[route]
        kernel = ("fused_ell_sweep" if schedule == "halo" else
                  "edge_reweight")
        want = dict(NO_LAUNCHES, **{kernel: cfg4.n_irls})
        ops_want = SHARD_STEP_OPS["halo_int8" if comp else schedule]
        log(f"[sharded 4] {route}: setup {r['setup_s']:.2f} s, solve "
            f"{r['solve_s']:.2f} s ({r['pcg_steps']} CG steps), launches "
            f"{r['launches']}, per CG step {r['per_pcg_step']}, plan "
            f"{r['plan']}, cut {r['cut']!r}")
        if r["launches"] != want or step_ops(r) != ops_want:
            raise AssertionError(f"sharded 4 {route}: launches "
                                 f"{r['launches']}, per step "
                                 f"{r['per_pcg_step']}")
        if comp is None:
            one = world_one["side48"][route]["cut"]
            rel = abs(r["cut"] - one) / abs(one)
            r["rel_world_one"] = rel
            log(f"[sharded 4] {route}: cut vs world one {one!r}: rel "
                f"{rel:.2e} (tolerance 1e-5)")
            if not (r["finite"] and rel <= 1e-5):
                raise AssertionError(f"sharded 4 {route}: cut {r['cut']} vs "
                                     f"world one {one} (rel {rel})")
    b_f = got["halo_fused"]["per_pcg_step"]["bytes"]
    b_8 = got["halo_int8"]["per_pcg_step"]["bytes"]
    b_p = got["psum"]["per_pcg_step"]["bytes"]
    log(f"[sharded 4] bytes per CG step a rank: halo {b_f:.0f}, int8 halo "
        f"{b_8:.0f}, psum {b_p:.0f}; gloo stages the CUDA tensors through "
        f"the host; {wall:.1f} s for the four ranks")
    if not (b_8 < 0.4 * b_f and b_f < 0.7 * b_p and got["halo_int8"]["finite"]):
        raise AssertionError(f"sharded 4 bytes per step: halo {b_f}, int8 "
                             f"{b_8}, psum {b_p}")
    got["wall_s"] = wall
    return got


def sharded_cli_phase(cli: dict, out_dir: Path):
    """Phase 13c: ``launch.solve --backend sharded`` as a subprocess in a
    world of one on the card (run by ``finish_clis`` in phase 11d)."""
    path = out_dir / "chip_smoke_solve_sharded.json"
    secs = cli["seconds"]
    s = json.loads(path.read_text())
    log(f"[sharded cli] {secs:.1f} s: backend {s['backend']}, cut "
        f"{s['cut_two_level']!r} vs exact {s['cut_exact']!r}: "
        f"delta_two_level {s['delta_two_level']:.2e} (tolerance 1e-3), IRLS "
        f"{s['t_irls']:.2f} s (beside 11d's CLIs)")
    if s["backend"] != "sharded" or not abs(s["delta_two_level"]) <= 1e-3:
        raise AssertionError(f"sharded solve CLI: {s}")
    return dict(seconds=secs, json=s)


def sharded_phase(inst, labels, cfg, host_cut: float, seed: int,
                  out_dir: Path, cli: dict) -> dict:
    """Phase 13: 13a, 13b and 13c; the world of one is taken down after
    13a, before the ranks of 13b start.  The solver's float32 sentinel
    warns on every solve here (eps = 1e-6 is below float32's reach at
    these weights, as on the host path), so its warning is muted."""
    import warnings

    from repro_torch.distributed.collectives import release_world
    from repro_torch.distributed.solver import Float32DivergenceWarning

    t = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", Float32DivergenceWarning)
        out = {"world_one": sharded_world_one_phase(inst, labels, cfg,
                                                    host_cut, seed)}
    release_world()
    out["ranks"] = sharded_ranks_phase(cfg, out["world_one"], seed, out_dir)
    out["cli"] = sharded_cli_phase(cli, out_dir)
    out["seconds"] = time.perf_counter() - t
    log(f"[sharded] phase 13 in {out['seconds']:.1f} s")
    return out


# -- phase 14: MoE serving at full width ------------------------------------

# phase 14's depth cuts: llama4-maverick at 2 of its 48 layers (67.3 GB of
# bf16 weights on the 80 GB card), mixtral-8x22b at 4 of its 56 (20.4 GB)
MOE_DEPTH = {"llama4-maverick-400b-a17b": 2, "mixtral-8x22b": 4}
# the MoE layer alone: the prefill's 4 × 4096 tokens, 64 sampled tokens
# held against the float32 reference, the grouped dispatch at 2,048 tokens
# in 8 groups (capacity ≥ T: its [E, T, F] buffers bound the memory)
MOE_TOKENS, MOE_SAMPLES, MOE_GROUPED_TOKENS, MOE_GROUPS = 16384, 64, 2048, 8
# moe_layer in bf16 against a float32 per-token reference, of each entry's
# scale Σ_j g_j Σ_f |a_f·w2_fd| (a = silu(x·w1) ⊙ x·w3): a carries four
# roundings to bf16 at u = 2^-8 (x·w1, x·w3, silu, the product), then the
# expert's output, the gate's cast, the gated product and the sum of the k
# choices one each
MOE_RTOL = 8 * 2.0 ** -8
# query and key chunk of 14c's fresh forward over 4096 + 64 tokens (4159,
# the last decode step's length, is prime)
FRESH_CHUNK = 520


@contextlib.contextmanager
def recorded_routes():
    """Each ``moe_layer`` call's routes while open: a list of (experts
    [T, k], keep [T, k], capacity) per call, in layer order.  ``moe_layer``
    is wrapped to compute ``moe_routes`` on its input first; it computes
    the same routes again inside."""
    from repro_torch.models import layers

    real = layers.moe_layer
    calls = []

    def moe_layer(x, p, top_k, capacity_factor=1.25):
        r = layers.moe_routes(x, p.router, top_k, capacity_factor)
        calls.append((r.experts, r.keep.view(r.experts.shape), r.capacity))
        return real(x, p, top_k, capacity_factor)

    layers.moe_layer = moe_layer
    try:
        yield calls
    finally:
        layers.moe_layer = real


def same_routes(a, b, rows_a, rows_b):
    """Per lane: whether its token (row ``rows_a[i]`` of a's routes, row
    ``rows_b[i]`` of b's) took the same experts, kept or dropped alike, in
    every layer."""
    import numpy as np

    same = np.ones(len(rows_a), bool)
    for (ea, ka, _), (eb, kb, _) in zip(a, b, strict=True):
        same &= ((ea[rows_a] == eb[rows_b]).all(-1)
                 & (ka[rows_a] == kb[rows_b]).all(-1)).cpu().numpy()
    return same


def held_logits(label, got, want, lanes):
    """The logits of the held lanes within LOGIT_RTOL of their max |logits|;
    fails if fewer than 2 of the lanes are held."""
    import numpy as np

    held = np.flatnonzero(lanes)
    gap = float((got[held] - want[held]).abs().max()) if len(held) else 0.0
    scale = float(want[held].abs().max()) if len(held) else 0.0
    log(f"[moe] {label}: lanes held (same experts in every layer) "
        f"{held.tolist()} of {len(lanes)}; their logits max |Δ| {gap:.4e} of "
        f"max |logits| {scale:.4e} (rel {gap / max(scale, 1e-30):.3e}, "
        f"tolerance {LOGIT_RTOL})")
    if len(held) < 2:
        raise AssertionError(f"{label}: {len(held)} lanes held, fewer than 2")
    if not gap <= LOGIT_RTOL * scale:
        raise AssertionError(f"{label}: logits {gap} > {LOGIT_RTOL} × "
                             f"{scale}")
    return dict(lanes_held=held.tolist(), logit_gap=gap, logit_scale=scale)


def moe_alone(cfg, seed: int):
    """Phase 14d: ``moe_layer`` at one layer's shapes of the arch (its
    router and experts drawn as ``init_params`` draws them), on T = 16,384
    tokens from a seeded generator: the routes computed once; 64 sampled
    tokens with every choice kept held against a float32 per-token
    reference Σ_j g_j·expert_j(x); the dropped (token, choice) set equal to
    a host recount from the top ids and C, rows with every choice dropped
    exactly 0; then ``moe_layer_grouped`` in 8 groups against
    ``moe_layer`` at capacity ≥ T on the first 2,048 tokens."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.models import layers as nn
    from repro_torch.models import transformer as tr

    dev = torch.device("cuda")
    one = dataclasses.replace(cfg, n_layers=1)
    params = tr.init_params(one, torch.Generator(device=dev).manual_seed(
        seed + 14), device=dev)
    lp = tr.layer_params(params.tree(), 0)
    p = nn.MoEParams(router=lp["router"], w1=lp["w1"], w3=lp["w3"],
                     w2=lp["w2"])
    E, k, cf = cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.capacity_factor
    T = MOE_TOKENS
    x = torch.randn((T, cfg.d_model), generator=torch.Generator(
        device=dev).manual_seed(seed + 15), device=dev).to(cfg.dtype)
    r = nn.moe_routes(x, p.router, k, cf)
    y = nn.moe_layer(x, p, k, cf)
    experts = r.experts.cpu().numpy()
    keep = r.keep.view(T, k).cpu().numpy()
    C = r.capacity
    # the host recount: each entry's rank among its expert's in token-major
    # order, by a running count per expert
    counts = np.zeros(E, np.int64)
    rank = np.empty(T * k, np.int64)
    for i, e in enumerate(experts.reshape(-1).tolist()):
        rank[i] = counts[e]
        counts[e] += 1
    if not np.array_equal(~keep.reshape(-1), rank >= C):
        raise AssertionError(f"{cfg.name}: dropped entries differ from the "
                             f"host recount")
    none_kept = ~keep.any(axis=1)
    if bool(y[torch.as_tensor(none_kept, device=dev)].any()):
        raise AssertionError(f"{cfg.name}: a token with every choice dropped "
                             f"has a nonzero row")
    # the float32 reference on sampled tokens, grouped by expert
    pick = np.random.default_rng(seed).choice(np.flatnonzero(keep.all(axis=1)),
                                              MOE_SAMPLES, replace=False)
    gates = r.gates[torch.as_tensor(pick, device=dev)]          # [n, k]
    xs = x[torch.as_tensor(pick, device=dev)].float()
    want = torch.zeros_like(xs)
    scale = torch.zeros_like(xs)
    for e in np.unique(experts[pick]).tolist():
        rows, js = np.nonzero(experts[pick] == e)
        rows_t = torch.as_tensor(rows, device=dev)
        g = gates[rows_t, torch.as_tensor(js, device=dev)][:, None]
        w2 = p.w2[e].float()
        xe = xs[rows_t]
        a = F.silu(xe @ p.w1[e].float()) * (xe @ p.w3[e].float())
        want.index_add_(0, rows_t, g * (a @ w2))
        scale.index_add_(0, rows_t, g * (a.abs() @ w2.abs()))
    got = y[torch.as_tensor(pick, device=dev)].float()
    err = check_close(f"moe_layer {cfg.name} layer shape, {MOE_SAMPLES} "
                      f"tokens vs float32", [got], [want], MOE_RTOL, [scale])
    ms = time_ms(lambda: nn.moe_layer(x, p, k, cf), 5, warmup=1)
    dropped = int((~keep).sum())
    log(f"[moe] 14d {cfg.name}: T {T}, E {E}, top-{k}, C {C}; dropped "
        f"(token, choice) entries {dropped} of {T * k} (= the host recount), "
        f"tokens with no choice kept {int(none_kept.sum())} (rows 0); "
        f"moe_layer {ms:.3f} ms")
    del y, r, want, scale
    # grouped against global at capacity ≥ T
    x2 = x[:MOE_GROUPED_TOKENS]
    y1 = nn.moe_layer(x2, p, k, float(E))
    y2 = nn.moe_layer_grouped(x2, p, k, float(E), MOE_GROUPS)
    gap = (y1.float() - y2.float()).abs()
    row = y1.float().abs().amax(dim=1, keepdim=True)
    equal = bool(torch.equal(y1, y2))
    log(f"[moe] 14d {cfg.name}: moe_layer_grouped ({MOE_GROUPS} groups) vs "
        f"moe_layer at capacity factor {E} on {MOE_GROUPED_TOKENS} tokens: "
        f"bit-equal {equal}, max |Δ| {float(gap.max()):.3e} (tolerance "
        f"2^-6 of each row's max |y|)")
    if not bool((gap <= 2.0 ** -6 * row).all()):
        raise AssertionError(f"{cfg.name}: grouped vs global MoE differ")
    del params, p, lp, x, x2, y1, y2
    torch.cuda.empty_cache()
    return dict(tokens=T, capacity=C, dropped=dropped,
                no_choice_kept=int(none_kept.sum()), max_abs_err=err, ms=ms,
                grouped_bit_equal=equal, grouped_max_gap=float(gap.max()))


def moe_serve(cfg, batch: int, seq: int, gen_len: int, seed: int):
    """Phase 14b/14c's common part: the arch at full width (its depth cut
    to ``MOE_DEPTH``) from a seeded generator on the card, served through
    ``launch.lm_serve.serve``: the launches (``flash_fwd`` once per global
    layer, every layer of llama4, none of mixtral's windowed ones), tokens
    in range, prefill and decode times, peak memory and the decode bound
    (every step reads every weight: each expert runs its C = 8 slots, the
    embedding is the LM head; and the whole KV cache).  Returns (params,
    prompts, tokens, the phase's record)."""
    import torch

    from repro_torch.data.lm import token_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.lm_serve import serve
    from repro_torch.models import transformer as tr

    dev = torch.device("cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    model = tr.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    weight_bytes = sum(nbytes(p) for p in model.parameters())
    params = model.tree()
    del model
    prompts = token_batch(cfg.vocab, batch, seq, seed=seed)
    log(f"[moe] {cfg.name} at depth {cfg.n_layers}: {cfg.param_count():,} "
        f"parameters ({weight_bytes / 1e9:.2f} GB, {cfg.dtype}), "
        f"{cfg.active_param_count():,} active per token; initialized in "
        f"{init_s:.1f} s")
    serve(cfg, params, prompts[:, :128], 2, dev)     # warm-up, not read
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    tokens, tm = serve(cfg, params, prompts, gen_len, dev)
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    n_full = sum(1 for kind in cfg.layer_kinds() if kind == "G")
    want = dict(NO_LAUNCHES, flash_fwd=n_full if cfg.use_pallas_attention
                else 0)
    cache_bytes = sum(nbytes(c) for c in tr.init_cache(
        cfg, batch, seq + gen_len, device="meta").values())
    step_bound_ms = (weight_bytes + cache_bytes) / PEAK_BYTES_PER_S * 1e3
    steps = gen_len - 1
    rec = dict(depth=cfg.n_layers, params=cfg.param_count(),
               weight_bytes=weight_bytes, init_s=init_s,
               prefill_s=tm["prefill_s"], decode_s=tm["decode_s"],
               prefill_tok_s=batch * seq / tm["prefill_s"],
               decode_tok_s=batch * steps / tm["decode_s"],
               decode_step_ms=tm["decode_s"] / steps * 1e3,
               decode_step_bound_ms=step_bound_ms, peak_bytes=peak,
               launches=launches)
    log(f"[moe] {cfg.name} serve: prefill {batch}x{seq} in "
        f"{tm['prefill_s']:.3f} s ({rec['prefill_tok_s']:.0f} tok/s), decode "
        f"{steps} steps in {tm['decode_s']:.3f} s ({rec['decode_tok_s']:.1f} "
        f"tok/s, {rec['decode_step_ms']:.2f} ms a step; bound "
        f"{step_bound_ms:.2f} ms a step from "
        f"{(weight_bytes + cache_bytes) / 1e9:.2f} GB read, {batch / step_bound_ms * 1e3:.1f} tok/s); peak device "
        f"memory {peak / 2**30:.2f} GiB")
    log(f"[moe] {cfg.name} launches {launches} (expected {want}: "
        + ("one flash_fwd per layer in prefill, none in decode)" if n_full else
           "windowed layers stay on the banded path, as in the reference)"))
    if launches != want:
        raise AssertionError(f"{cfg.name} launches {launches} != {want}")
    if tokens.shape != (batch, gen_len) or not (
            (tokens >= 0) & (tokens < cfg.vocab)).all():
        raise AssertionError(f"{cfg.name}: generated tokens {tokens.shape} "
                             f"out of range")
    return params, prompts, tokens, rec


def moe_llama4_phase(cfg, batch: int, seq: int, gen_len: int, seed: int):
    """Phase 14b: llama4-maverick served at full width through the kernel
    (``moe_serve``), then its prefill on the kernel and the plain attention
    path with the routes recorded: ``flash_fwd`` once per layer on the
    kernel path and never on the plain one, each layer's share of (token,
    choice) routes that differ, the last-position logits held on the lanes
    whose last token took the same experts in every layer; the plain path's
    greedy tokens against the kernel path's; a profile of the prefill and
    of 4 decode steps."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.lm_serve import serve
    from repro_torch.models import transformer as tr

    dev = torch.device("cuda")
    params, prompts, tokens, rec = moe_serve(cfg, batch, seq, gen_len, seed)
    plain_cfg = dataclasses.replace(cfg, use_pallas_attention=False)
    toks = torch.as_tensor(prompts, dtype=torch.long, device=dev)
    cap = seq + gen_len
    ops.reset_launches()
    with recorded_routes() as routes_k:
        logits_k, _ = tr.prefill(params, toks, cfg, pad_cache_to=cap)
    prefill_launches = dict(ops.launches)
    with recorded_routes() as routes_p:
        logits_p, _ = tr.prefill(params, toks, plain_cfg, pad_cache_to=cap)
    if prefill_launches != dict(NO_LAUNCHES, flash_fwd=cfg.n_layers) or \
            ops.launches != prefill_launches:
        raise AssertionError(f"prefill launches {prefill_launches}, then the "
                             f"plain path {dict(ops.launches)}")
    if not bool(torch.isfinite(logits_k).all()):
        raise AssertionError("non-finite logits on the kernel path")
    differ = [float(((ek != ep) | (kk != kp)).float().mean())
              for (ek, kk, _), (ep, kp, _) in zip(routes_k, routes_p,
                                                  strict=True)]
    drops = [[int((~keep).sum()) for _, keep, _ in r] for r in (routes_k,
                                                                 routes_p)]
    log(f"[moe] 14b prefill, kernel vs plain attention path: share of "
        f"(token, choice) routes that differ, per layer {differ}; entries "
        f"dropped per layer {drops[0]} and {drops[1]} of "
        f"{batch * seq * cfg.moe.top_k}")
    last = [b * seq + seq - 1 for b in range(batch)]
    held = held_logits("14b last-position logits, kernel vs plain path",
                       logits_k, logits_p, same_routes(routes_k, routes_p,
                                                       last, last))
    del logits_k, logits_p, routes_k, routes_p
    plain_tokens, plain_tm = serve(plain_cfg, params, prompts, gen_len, dev)
    agree = (tokens == plain_tokens).sum(axis=1).tolist()
    log(f"[moe] 14b plain path: prefill {plain_tm['prefill_s']:.3f} s, decode "
        f"{plain_tm['decode_s']:.3f} s; generated tokens equal to the kernel "
        f"path's, per lane (of {gen_len}): {agree}")
    prof = {"prefill": profile_call(
        lambda: tr.prefill(params, toks, cfg, pad_cache_to=cap),
        f"llama4 prefill {batch}x{seq}")}
    _, cache = tr.prefill(params, toks, cfg, pad_cache_to=cap)
    first = torch.as_tensor(tokens[:, 0], dtype=torch.long, device=dev)

    def decode_steps(n=4):
        for i in range(n):
            tr.decode_step(params, cache, first, seq + i, cfg)

    prof["decode_4_steps"] = profile_call(decode_steps,
                                          "llama4 decode, 4 steps")
    del params, cache
    torch.cuda.empty_cache()
    return dict(rec, prefill_launches=prefill_launches, routes_differ=differ,
                prefill_drops=drops,
                **held, plain_prefill_s=plain_tm["prefill_s"],
                plain_decode_s=plain_tm["decode_s"], tokens_agree=agree,
                profile=prof)


def moe_mixtral_phase(cfg, batch: int, seq: int, gen_len: int, seed: int):
    """Phase 14c: mixtral-8x22b served at full width (``moe_serve``; every
    layer windowed, so no kernel launch), its decode past the window (the
    ring caches wrap: 4096 + 63 positions).  Then the decode's last logits
    against a fresh forward over the prompt and the generated tokens (their
    logits at the same position).  A decode step routes 4 tokens into 8
    slots per expert and drops none, where a prefill drops the entries
    past an expert's capacity, so this check runs at the capacity factor
    E/top_k, where no entry drops (C = T): the prompt's prefill, the decode
    replayed on the served tokens with the last step's routes recorded, and
    the fresh forward; held on the lanes whose last token took the same
    experts in every layer.  The served prefill's drops are logged."""
    import torch

    from repro_torch.models import transformer as tr

    dev = torch.device("cuda")
    params, prompts, tokens, rec = moe_serve(cfg, batch, seq, gen_len, seed)
    toks = torch.as_tensor(prompts, dtype=torch.long, device=dev)
    gen = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    cap = seq + gen_len
    with recorded_routes() as routes_s:
        tr.prefill(params, toks, cfg, pad_cache_to=cap)
    drops = [int((~keep).sum()) for _, keep, _ in routes_s]
    last = [b * seq + seq - 1 for b in range(batch)]
    dropped_last = sorted({b for _, keep, _ in routes_s for b in range(batch)
                           if not bool(keep[last[b]].all())})
    log(f"[moe] 14c the served prefill ({batch * seq} tokens, capacity "
        f"{routes_s[0][2]}) drops {drops} (token, choice) entries per layer "
        f"of {batch * seq * cfg.moe.top_k}; lanes whose last prompt token "
        f"lost a choice: {dropped_last}")
    del routes_s
    cf = cfg.moe.n_experts / cfg.moe.top_k
    chk = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))
    with recorded_routes() as routes_c:
        _, cache = tr.prefill(params, toks, chk, pad_cache_to=cap)
    for i in range(gen_len - 2):
        tr.decode_step(params, cache, gen[:, i], seq + i, chk)
    last_pos = seq + gen_len - 2
    with recorded_routes() as routes_d:
        logits_d, cache = tr.decode_step(params, cache, gen[:, gen_len - 2],
                                         last_pos, chk)
    ring = cache["local_k"].shape[2]
    del cache
    full = torch.cat([toks, gen], dim=1)                    # [B, seq + gen]
    fresh_cfg = dataclasses.replace(chk, q_chunk=FRESH_CHUNK,
                                    k_chunk=FRESH_CHUNK)
    with recorded_routes() as routes_f:
        h, _ = tr.forward(params, full, fresh_cfg)
    logits_f = (h[:, last_pos] @ params["embed"].T).float()
    del h
    S = full.shape[1]
    if not all(bool(keep.all())
               for _, keep, _ in routes_c + routes_d + routes_f):
        raise AssertionError(f"14c: an entry dropped at capacity factor {cf}")
    log(f"[moe] 14c at capacity factor {cf} (nothing dropped): decode to "
        f"position {last_pos} through ring caches of {ring} slots (window "
        f"{cfg.window}) on the served tokens; fresh forward over {S} tokens "
        f"in chunks of {FRESH_CHUNK}")
    held = held_logits(
        "14c decode's last logits vs a fresh forward", logits_d, logits_f,
        same_routes(routes_d, routes_f, list(range(batch)),
                    [b * S + last_pos for b in range(batch)]))
    del params, logits_d, logits_f
    torch.cuda.empty_cache()
    return dict(rec, served_prefill_drops=drops,
                served_last_token_dropped_lanes=dropped_last,
                check_capacity_factor=cf, ring_slots=ring,
                decode_positions=last_pos + 1, **held)


def moe_phase(seed: int):
    """Phase 14: ``flash_fwd`` alone at llama4's attention shape (14a), the
    MoE layer alone at both archs' layer shapes (14d), then llama4 (14b)
    and mixtral (14c) served at full width, one at a time on the card."""
    import torch

    from repro_torch.configs import lm as lm_configs

    t = time.perf_counter()
    log(f"[moe] phase 14 starts with {torch.cuda.memory_allocated() / 2**30:.2f}"
        f" GiB allocated on the card")
    llama4 = dataclasses.replace(
        lm_configs.llama4_maverick(), use_pallas_attention=True,
        n_layers=MOE_DEPTH["llama4-maverick-400b-a17b"])
    mixtral = dataclasses.replace(
        lm_configs.mixtral_8x22b(), use_pallas_attention=True,
        n_layers=MOE_DEPTH["mixtral-8x22b"])
    log(f"[moe] 14a: flash_fwd at llama4's attention shape ({llama4.n_heads} "
        f"query heads over {llama4.n_kv_heads} KV heads)")
    out = {"flash_fwd": flash_fwd_alone(llama4, LM_BATCH, LM_SEQ, seed)}
    torch.cuda.empty_cache()
    out["alone"] = {c.name: moe_alone(c, seed) for c in (llama4, mixtral)}
    out["llama4"] = moe_llama4_phase(llama4, LM_BATCH, LM_SEQ, LM_GEN, seed)
    out["mixtral"] = moe_mixtral_phase(mixtral, LM_BATCH, LM_SEQ, LM_GEN, seed)
    out["launches"] = out["llama4"]["launches"]
    out["seconds"] = time.perf_counter() - t
    log(f"[moe] phase 14 in {out['seconds']:.1f} s")
    return out


# -- phase 15: the sharded server and the perf gate -------------------------

# each sharded server's burst: the undrifted weights, then requests that
# each drift DRIFT_FRAC of the edges from the one before (phase 11's walk)
SHARD_SERVE_BURST = 4
# 15b's grid side: 13b's 48 cut to 32, since the whole run at 48 took
# 1,160 s of its 1,200 (15b 133 s of it; 47 s at 32)
SHARD_SERVE_SIDE = 32
# 15c: a served solve or a host solve may count at most this share above
# the card's rates (a count above the peak is a wrong count)
ROOF_SLACK = 1.05


def sharded_traffic(inst, seed: int, burst: int = SHARD_SERVE_BURST):
    """One tenant's burst: the instance's weights, then ``burst`` − 1
    drifted ones (1% of the edges, σ 0.05, each from the one before)."""
    import numpy as np

    from repro_torch.core import Weights

    rng = np.random.default_rng(seed)
    c = np.asarray(inst.graph.weight, dtype=np.float64)
    ws = [Weights(c, inst.s_weight, inst.t_weight)]
    for _ in range(burst - 1):
        c, _ = drift_edges(rng, c, DRIFT_FRAC)
        ws.append(Weights(c, inst.s_weight, inst.t_weight))
    return ws


def sharded_server_phase(inst, labels, cfg, fused_cut: float, seed: int):
    """Phase 15a: ``MinCutServer(backend="sharded")`` in a world of one
    over NCCL at full width — 13a's instance, labels (registered with the
    topology) and fused-halo kernel config — serving one tenant's burst
    one request a batch; launch counters set to 0 just before the burst
    and read just after.  Each served cut is held against the session's
    own sharded solve of the same weights (rel 1e-5), the first against
    13a's fused-halo cut (rel 1e-5)."""
    import numpy as np
    import torch

    from repro_torch.distributed.collectives import release_world
    from repro_torch.kernels import ops
    from repro_torch.serve import MinCutServer

    rc = shard_cfg(cfg)
    ws = sharded_traffic(inst, seed + 15)
    with MinCutServer(cfg=rc, backend="sharded", rounding="sweep",
                      max_batch=1, device="cuda") as srv:
        key = srv.register(inst, labels=labels)
        torch.cuda.synchronize()
        ops.reset_launches()
        t = time.perf_counter()
        served = [f.result(timeout=900)
                  for f in srv.submit_many(key, ws, tenant="volume")]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = dict(ops.launches)
        stats = srv.stats()
        sess = srv.cache.get(key)
    t = time.perf_counter()
    direct = [sess.solve(weights=w, rounding="sweep") for w in ws]
    direct_s = time.perf_counter() - t
    release_world()
    want = dict(NO_LAUNCHES, fused_ell_sweep=len(ws) * rc.n_irls)
    rels = [abs(a.cut_value - b.cut_value) / abs(b.cut_value)
            for a, b in zip(served, direct)]
    rel13 = abs(served[0].cut_value - fused_cut) / abs(fused_cut)
    setup = served[0].timings.get("setup", 0.0)
    refill = served[-1].telemetry["sharded_refill"]
    tm = {k: [r.timings[k] for r in served]
          for k in ("queue", "irls", "rounding", "total")}
    log(f"[sharded serve] {len(ws)} requests in {wall:.2f} s "
        f"({len(ws) / wall:.3f} solves/s; the first's setup {setup:.2f} s, "
        f"then {(len(ws) - 1) / max(wall - tm['total'][0], 1e-9):.3f} "
        f"solves/s); IRLS s {[round(x, 3) for x in tm['irls']]}; launches "
        f"{launches} (expected {want}); warm {stats['warm']}; delta refill "
        f"{refill}")
    log(f"[sharded serve] cuts {[r.cut_value for r in served]} vs the "
        f"session's {[r.cut_value for r in direct]} (rel max "
        f"{max(rels):.2e}, tolerance 1e-5; {direct_s:.2f} s); first vs "
        f"13a's fused halo {fused_cut!r}: rel {rel13:.2e} (tolerance 1e-5)")
    if launches != want:
        raise AssertionError(f"sharded serve launches {launches} != {want}")
    if stats["warm"]["sharded_excluded"] != len(ws) or stats["failed"]:
        raise AssertionError(f"sharded serve: warm {stats['warm']}, failed "
                             f"{stats['failed']}")
    if not (all(np.isfinite(r.voltages).all() for r in served)
            and max(rels) <= 1e-5 and rel13 <= 1e-5):
        raise AssertionError(f"sharded serve cuts: vs session {rels}, vs "
                             f"13a {rel13}")
    return dict(wall_s=wall, solves_per_sec=len(ws) / wall, setup_s=setup,
                timings=tm, launches=launches, warm=stats["warm"],
                refill=refill, cuts=[r.cut_value for r in served],
                rel_session=max(rels), rel_13a=rel13,
                pcg_total=sum(int(np.sum(r.pcg_iters)) for r in served),
                telemetry=stats["telemetry"])


def served_cfg():
    """15b's config: the server's default one with ``use_pallas``, and the
    halo sweep unfused — the sharded solver fuses the halo build under
    ``fuse_edge_sweep`` whatever the layout (in both packages), and the
    unfused build is the one that runs ``edge_reweight`` on each shard."""
    return dataclasses.replace(server_cfg(True), fuse_edge_sweep=False)


def _served_rank(rank: int, store: str, out_path: str, seed: int,
                 side: int) -> None:
    """One rank of 15b (a spawned process): rank 0 serves the burst, the
    others follow; every rank writes what it launched."""
    import datetime
    import warnings

    import torch
    import torch.distributed as dist

    from repro_torch.distributed.solver import Float32DivergenceWarning
    from repro_torch.kernels import ops
    from repro_torch.serve import MinCutServer, follow_sharded

    warnings.simplefilter("ignore", Float32DivergenceWarning)
    dist.init_process_group("gloo", store=dist.FileStore(store, SHARD_RANKS),
                            rank=rank, world_size=SHARD_RANKS,
                            timeout=datetime.timedelta(seconds=300))
    torch.cuda.set_device(0)
    ops.reset_launches()
    t = time.perf_counter()
    if rank == 0:
        inst = segmentation_grid(side, seed)
        ws = sharded_traffic(inst, seed + 16)
        with MinCutServer(cfg=served_cfg(), backend="sharded",
                          rounding="two_level", max_batch=1,
                          device="cuda") as srv:
            served = [f.result(timeout=500)
                      for f in srv.submit_many(inst, ws, tenant="volume")]
            stats = srv.stats()
        out = {"cuts": [r.cut_value for r in served],
               "irls_s": [r.timings["irls"] for r in served],
               "pcg_iters": [r.pcg_iters.tolist() for r in served],
               "warm": stats["warm"], "failed": stats["failed"]}
    else:
        out = {"follow": follow_sharded(device="cuda")}
    torch.cuda.synchronize()
    out.update(wall_s=time.perf_counter() - t, launches=dict(ops.launches))
    Path(f"{out_path}.{rank}").write_text(json.dumps(out))
    dist.destroy_process_group()


def sharded_ranks_server_phase(seed: int, out_dir: Path,
                               side: int = SHARD_SERVE_SIDE):
    """Phase 15b: the sharded server over four spawned ranks on the one card
    (gloo over CUDA tensors, 13b's spawn), rank 0 serving a burst at
    ``side``³ and ranks 1–3 following; first the same burst
    through a world-one sharded session on the same config, whose two-level
    cuts the served ones must equal (rel 1e-5)."""
    import warnings

    from repro_torch.core import MinCutSession, Problem
    from repro_torch.distributed.collectives import release_world
    from repro_torch.distributed.solver import Float32DivergenceWarning

    inst = segmentation_grid(side, seed)
    ws = sharded_traffic(inst, seed + 16)
    t = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", Float32DivergenceWarning)
        sess = MinCutSession(Problem.build(inst, n_blocks=1), served_cfg(),
                             backend="sharded", device="cuda")
        one = [sess.solve(weights=w, rounding="two_level",
                          delta_key="volume").cut_value for w in ws]
    one_s = time.perf_counter() - t
    release_world()
    del sess
    out_path = out_dir / "chip_smoke_served4.json"
    wall = run_ranks(_served_rank, out_path, (seed, side), timeout_s=400)
    ranks = [json.loads(Path(f"{out_path}.{r}").read_text())
             for r in range(SHARD_RANKS)]
    head = ranks[0]
    want = dict(NO_LAUNCHES, edge_reweight=len(ws) * served_cfg().n_irls)
    rels = [abs(a - b) / abs(b) for a, b in zip(head["cuts"], one)]
    follows = [r["follow"] for r in ranks[1:]]
    log(f"[sharded serve 4] {side}³, {len(ws)} requests: world "
        f"one {one} in {one_s:.2f} s; four ranks served {head['cuts']} "
        f"(rel max {max(rels):.2e}, tolerance 1e-5), IRLS s "
        f"{[round(x, 2) for x in head['irls_s']]}, warm {head['warm']}; "
        f"launches per rank {[r['launches'] for r in ranks]} (expected "
        f"{want}); followers {follows}; {wall:.1f} s for the four ranks")
    if any(r["launches"] != want for r in ranks):
        raise AssertionError(f"served ranks launches "
                             f"{[r['launches'] for r in ranks]} != {want}")
    done = {"registrations": 1, "batches": len(ws), "solves": len(ws),
            "failed": 0, "skipped": 0}
    if any(f != done for f in follows) or head["failed"]:
        raise AssertionError(f"followers {follows}, failed {head['failed']}")
    if not (max(rels) <= 1e-5
            and head["warm"]["sharded_excluded"] == len(ws)):
        raise AssertionError(f"served ranks cuts vs world one: {rels}; warm "
                             f"{head['warm']}")
    return dict(side=side, world_one=one, world_one_s=one_s,
                cuts=head["cuts"], rel_world_one=max(rels),
                irls_s=head["irls_s"], pcg_iters=head["pcg_iters"],
                wall_s=wall, rank_walls=[r["wall_s"] for r in ranks],
                launches=head["launches"], follow=follows,
                warm=head["warm"])


def perf_gate_phase(inst, labels, n_blocks: int, cfg, kern: dict,
                    served: dict, out_dir: Path):
    """Phase 15c: phase 4's host solve with ``profile=True`` on the kernel
    route and the plain route: the same count on both, rates under the
    card's, each term beside the kernel table's bound; then two payloads
    (15a's serving, this solve) into a history under ``chiprun_out/`` and
    ``launch.bench_diff --from-payload`` on an unchanged rerun (exit 0, 0
    regressed) and on 15a's payload with its wall doubled (exit 1)."""
    import os

    from repro_torch.core import MinCutSession, Problem
    from repro_torch.obs import bench_snapshot
    from repro_torch.obs.perf import history as hist
    from repro_torch.obs.perf import profile as perf_profile

    from repro_torch.kernels import ops

    prob = Problem.build(inst, n_blocks=n_blocks, labels=labels)
    tel, costs, launched = {}, {}, {}
    for route, use_pallas in (("kernel", True), ("plain", False)):
        sess = MinCutSession(prob, dataclasses.replace(
            cfg, use_pallas=use_pallas), device="cuda", profile=True)
        ops.reset_launches()
        res = sess.solve(rounding="sweep")
        launched[route] = dict(ops.launches)
        tel[route] = dict(res.telemetry, cut_value=res.cut_value)
        costs[route] = sess.program_costs()["host"]
    want = host_launches_want(tel["kernel"]["pcg_per_iter"], block=True)
    if launched != {"kernel": want, "plain": NO_LAUNCHES}:
        raise AssertionError(f"profiled host solves launched {launched}, "
                             f"want {want} on the kernel route")
    shape = perf_profile.SolveShape(**costs["kernel"]["shape"])
    recount = {r: perf_profile.solve_work(shape, len(t["pcg_per_iter"]),
                                          t["pcg_total"])
               for r, t in tel.items()}
    same_trace = tel["kernel"]["pcg_per_iter"] == tel["plain"]["pcg_per_iter"]
    for route, t in tel.items():
        log(f"[perf] host solve, {route} route: {t['flops']:.6g} flops, "
            f"{t['hbm_bytes']:.6g} bytes in {t['phases']['irls']:.3f} s of "
            f"IRLS: {t['achieved_gflops']:.3f} GFLOP/s, "
            f"{t['achieved_gbps']:.3f} GB/s, roofline fraction "
            f"{t['roofline_fraction']:.4f}; PCG {t['pcg_per_iter']}")
    # each term beside the bound the kernel table computed from the
    # kernel's own tensors in phase 3
    t_ms = {name: max(w["flops"] / perf_profile.PEAK_F32_FLOP_PER_S,
                      w["hbm_bytes"] / perf_profile.HBM_BYTES_PER_S) * 1e3
            for name, w in costs["kernel"]["terms"].items()}
    table = {"matvec": "ell_spmv", "system": "fused_ell_sweep",
             "precond": "block_diag_matvec"}
    for name, w in costs["kernel"]["terms"].items():
        beside = (f", kernel table {kern[table[name]]['bound_ms']:.4f} ms"
                  if name in table else "")
        log(f"[perf] term {name}: {w['flops']:.6g} flops, "
            f"{w['hbm_bytes']:.6g} bytes: {t_ms[name]:.4f} ms at the card's "
            f"rates{beside}")
    table_rel = {name: abs(t_ms[name] - kern[k]["bound_ms"])
                 / kern[k]["bound_ms"] for name, k in table.items()}
    if costs["kernel"] != costs["plain"]:
        raise AssertionError(f"the routes count differently: {costs}")
    for route, t in tel.items():
        # the telemetry scales a per-iteration average back up: equal to
        # the count up to that division's rounding
        if not all(abs(t[key] - recount[route][key])
                   <= 1e-12 * recount[route][key]
                   for key in ("flops", "hbm_bytes")):
            raise AssertionError(f"{route}: telemetry {t['flops']} flops, "
                                 f"count {recount[route]['flops']}")
        if not (t["achieved_gbps"] <= ROOF_SLACK * 3350
                and 0 < t["roofline_fraction"] <= ROOF_SLACK):
            raise AssertionError(f"{route}: {t['achieved_gbps']} GB/s, "
                                 f"roofline {t['roofline_fraction']}")
    if same_trace and (tel["kernel"]["flops"], tel["kernel"]["hbm_bytes"]) \
            != (tel["plain"]["flops"], tel["plain"]["hbm_bytes"]):
        raise AssertionError("same PCG trace, other counts")
    if max(table_rel.values()) > 1e-6:
        raise AssertionError(f"terms vs the kernel table: {table_rel}")
    log(f"[perf] the routes' PCG traces equal: {same_trace}; counts equal "
        f"for equal traces; terms vs the kernel table's bounds max rel "
        f"{max(table_rel.values()):.1e} (tolerance 1e-6)")

    # -- the gate: two payloads, a history, bench_diff as a subprocess
    k = tel["kernel"]
    payloads = {
        "chip_sharded_serve": dict(
            name="chip_sharded_serve", cfg={"side": round(inst.n ** (1 / 3)),
                                            "burst": SHARD_SERVE_BURST},
            wall_s=served["wall_s"], solves_per_sec=served["solves_per_sec"],
            pcg_total=served["pcg_total"], cut_value=served["cuts"][0],
            obs=bench_snapshot()),
        "chip_host_solve": dict(
            name="chip_host_solve", cfg={"side": round(inst.n ** (1 / 3)),
                                         "n_irls": cfg.n_irls},
            irls_s=k["phases"]["irls"], pcg_total=k["pcg_total"],
            cut_value=k["cut_value"], flops=k["flops"],
            hbm_bytes=k["hbm_bytes"], achieved_gflops=k["achieved_gflops"],
            achieved_gbps=k["achieved_gbps"],
            roofline_fraction=k["roofline_fraction"], obs=bench_snapshot())}
    history = out_dir / "chip_smoke_history.jsonl"
    history.unlink(missing_ok=True)
    files = []
    for name, pl in payloads.items():
        path = out_dir / f"chip_smoke_{name}.json"
        path.write_text(json.dumps(pl))
        files.append(str(path))
        for _ in range(2):                  # a baseline of two runs
            hist.append_history(pl, str(history))
    slow = dict(payloads["chip_sharded_serve"],
                wall_s=2 * served["wall_s"])
    slow_path = out_dir / "chip_smoke_chip_sharded_serve_slow.json"
    slow_path.write_text(json.dumps(slow))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = {}
    for label, paths in (("rerun", files), ("doubled", [str(slow_path)])):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.bench_diff",
             "--from-payload", *paths, "--history", str(history)],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
        runs[label] = dict(rc=proc.returncode, stdout=proc.stdout,
                           stderr=proc.stderr[-2000:])
        log(f"[perf] bench_diff, {label}: exit {proc.returncode}; "
            + " | ".join(line for line in proc.stdout.splitlines()
                         if "regressed" in line))
    ok_rerun = (runs["rerun"]["rc"] == 0
                and runs["rerun"]["stdout"].count("0 regressed") == 2)
    ok_slow = (runs["doubled"]["rc"] == 1
               and "wall_s" in runs["doubled"]["stderr"])
    if not (ok_rerun and ok_slow):
        raise AssertionError(f"bench_diff: {runs}")
    return dict(telemetry={r: {key: t[key] for key in (
                    "flops", "hbm_bytes", "achieved_gflops", "achieved_gbps",
                    "roofline_fraction", "pcg_per_iter", "cut_value")}
                    | {"irls_s": t["phases"]["irls"]}
                    for r, t in tel.items()},
                terms=costs["kernel"]["terms"], shape=costs["kernel"]["shape"],
                term_ms=t_ms, table_rel=table_rel, same_trace=same_trace,
                bench_diff={k: v["rc"] for k, v in runs.items()},
                launches=launched["kernel"])


# -- phase 16: LM training at full width ----------------------------------------

# 16a: the flash backward at training shapes, (label, B, S, H, KV, D,
# window, q_chunk, k_chunk): qwen2-1.5b's attention (causal, the config's
# chunks) and one gemma3-27b local layer (window 1024 at S 4096: the banded
# path)
TRAIN_BWD_SHAPES = (("qwen2-1.5b", 2, 4096, 12, 2, 128, None, 512, 1024),
                    ("gemma3-27b local", 1, 4096, 32, 16, 128, 1024, 512,
                     1024))
# each gradient of the recomputing backward against autograd through the
# plain forward, of its own max |·|: both sides sum in float32 and round
# once to bf16 (u = 2^-8), other float32 orders below that
TRAIN_BWD_RTOL = 1e-2
# 16b: qwen2-1.5b at full width, the train_4k cell's sequence length at
# batch 4 on one card, at 14 of its 28 layers: at 28 the phase took 99.8
# s of its ~90 s, at 14 85.9–91.0 s, at 7 77.5 s.  Depth costs the run
# ~0.8 s a layer and the host phases vary by ~80 s between runs (phases
# 1–15: 962.1 s and 1,039 s on an H100), so phases 11c and 12 were cut to
# make room for phase 17 rather than this depth
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 4096, 3
TRAIN_LAYERS = 14
# the microbatched step (two halves of the batch, each its own forward:
# bf16 GEMMs of other shapes round elsewhere; the halves' gradients summed
# in float32 where one batch's are rounded to bf16) against one batch's:
# its loss, its grad_norm, and its gradient as the first moments hold it
# after the step (m = (1 - b1)·g below the clip norm), as ||Δm|| / ||m||
MICRO_RTOL = 1e-3
MICRO_NORM_RTOL = 2e-2
MICRO_GRAD_RTOL = 5e-2
# 16c: depth 2 of 28 at full width (3.27e8 bf16 parameters, float32
# moments: ~3.3 GB of state); resumed losses against the uninterrupted
# run's (bit-equality logged: the embedding's backward adds with atomics)
CKPT_LAYERS = 2
RESUME_RTOL = 1e-3


def plain_attention(q, k, v, window, q_chunk, k_chunk):
    """The blockwise forward with no custom backward: autograd records every
    tile (what the recomputing backward avoids)."""
    from repro_torch.models import layers as nn

    B, S, H, D = q.shape
    KV = k.shape[2]
    out, _ = nn._flash_fwd_impl(q.reshape(B, S, KV, H // KV, D), k, v,
                                causal=True, window=window, q_offset=0,
                                q_chunk=q_chunk, k_chunk=k_chunk,
                                scale=1.0 / D ** 0.5)
    return out.reshape(B, S, H, D).to(q.dtype)


def flash_backward_phase(seed: int):
    """Phase 16a: ``FlashAttention`` (the tile-recomputing backward) against
    autograd through the plain forward at training shapes in bf16: each
    gradient within TRAIN_BWD_RTOL of its own max; both backward times
    (CUDA events) and both peak memories above the inputs (forward and
    backward), the recomputing one's below the plain one's."""
    import torch

    from repro_torch.models import layers as nn

    dev = torch.device("cuda")
    out = {}
    for label, B, S, H, KV, D, window, qc, kc in TRAIN_BWD_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(seed + S + H)
        q, k, v = (torch.randn((B, S, n, D), generator=gen, device=dev)
                   .to(torch.bfloat16) for n in (H, KV, KV))
        do = torch.randn((B, S, H, D), generator=gen, device=dev).to(
            torch.bfloat16)
        runs = {
            "recompute": lambda *a: nn.flash_attention(
                *a, causal=True, window=window, q_chunk=qc, k_chunk=kc),
            "plain": lambda *a: plain_attention(*a, window, qc, kc)}
        res = {}
        for name, fwd in runs.items():
            for _ in range(2):               # a warm-up, then the measured
                leaves = [t.detach().clone().requires_grad_()
                          for t in (q, k, v)]
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                o = fwd(*leaves)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                grads = torch.autograd.grad(o, leaves, grad_outputs=do)
                end.record()
                end.synchronize()
                peak = torch.cuda.max_memory_allocated() - base
                del o, leaves
            res[name] = dict(grads=grads, bwd_ms=start.elapsed_time(end),
                             peak_bytes=peak)
        errs = {}
        for i, part in enumerate("qkv"):
            got, want = res["recompute"]["grads"][i], res["plain"]["grads"][i]
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"16a {label}: non-finite d{part}")
            errs[part] = float((got.float() - want.float()).abs().max()
                               / want.float().abs().max())
        r, p = res["recompute"], res["plain"]
        log(f"[train] 16a flash backward, {label} q [{B}, {S}, {H}, {D}] over "
            f"{KV} KV heads, window {window}, chunks {qc}/{kc} (bf16): dq dk "
            f"dv vs plain autograd rel {errs['q']:.2e} {errs['k']:.2e} "
            f"{errs['v']:.2e} (tolerance {TRAIN_BWD_RTOL}); backward "
            f"{r['bwd_ms']:.2f} ms recomputing vs {p['bwd_ms']:.2f} ms plain; "
            f"peak {r['peak_bytes'] / 2**30:.3f} GiB vs "
            f"{p['peak_bytes'] / 2**30:.3f} GiB")
        if not max(errs.values()) <= TRAIN_BWD_RTOL:
            raise AssertionError(f"16a {label}: gradients {errs}")
        if not r["peak_bytes"] < p["peak_bytes"]:
            raise AssertionError(f"16a {label}: recomputing peak "
                                 f"{r['peak_bytes']} ≥ plain {p['peak_bytes']}")
        out[label] = dict(shape=[B, S, H, KV, D], window=window,
                          chunks=[qc, kc], rel_err=errs,
                          bwd_ms=r["bwd_ms"], plain_bwd_ms=p["bwd_ms"],
                          peak_bytes=r["peak_bytes"],
                          plain_peak_bytes=p["peak_bytes"])
        del res, q, k, v, do
        torch.cuda.empty_cache()
    return out


def train_state(cfg, opt_cfg, seed: int):
    """Seeded parameters on the card (as the reference's pytree) and fresh
    AdamW state."""
    import torch

    from repro_torch.models import transformer as tr
    from repro_torch.train.optimizer import init_state

    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = tr.init_params(cfg, gen, device="cuda").tree()
    return params, init_state(opt_cfg, params)


def train_steps_phase(seed: int):
    """Phase 16b: ``build_train_step(lm_loss, AdamWConfig())`` on qwen2-1.5b
    at full width and TRAIN_LAYERS of its 28 layers (``remat`` as its
    config has it) over ``TokenStream(vocab, TRAIN_BATCH, TRAIN_SEQ)``: a
    warm-up step,
    the same step microbatched in two from the same state (its loss,
    grad_norm and gradient held against the warm-up's), the first half of
    the batch alone (how far a gradient that dropped half the batch would
    be), then TRAIN_STEPS timed steps from that state again (launch
    counters zeroed just before, read just after)."""
    import math

    import numpy as np
    import torch

    from repro_torch.configs import lm as lm_configs
    from repro_torch.data.lm import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tr
    from repro_torch.train.optimizer import AdamWConfig, named_leaves
    from repro_torch.train.train_step import build_train_step

    cfg = dataclasses.replace(lm_configs.qwen2_1_5b(), n_layers=TRAIN_LAYERS)
    opt_cfg = AdamWConfig()
    t = time.perf_counter()
    stream = TokenStream(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=seed)
    batches = [torch.from_numpy(next(stream)).to("cuda")
               for _ in range(TRAIN_STEPS + 1)]
    data_s = time.perf_counter() - t
    loss_fn = lambda p, b: tr.lm_loss(p, b, cfg)
    step = build_train_step(loss_fn, opt_cfg)
    step2 = build_train_step(loss_fn, opt_cfg, n_microbatches=2)
    n_tok = TRAIN_BATCH * TRAIN_SEQ
    ln_v = math.log(cfg.vocab)
    log(f"[train] 16b {cfg.name}: {cfg.param_count():,} parameters "
        f"({cfg.dtype}, {cfg.n_layers} layers, remat {cfg.remat}); "
        f"{TRAIN_STEPS + 1} batches of {TRAIN_BATCH}x{TRAIN_SEQ} tokens made "
        f"in {data_s:.1f} s")

    def run(fn, params, state, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, m = fn(params, state, batch)
        torch.cuda.synchronize()
        return time.perf_counter() - t, {k: float(v) for k, v in m.items()}

    def first_moments(fn, batch):
        """One step of ``fn`` from the seeded state: (seconds, metrics, the
        first moments after it)."""
        params, state = train_state(cfg, opt_cfg, seed)
        dt, m = run(fn, params, state, batch)
        return dt, m, state["m"]

    def grad_dist(a, b) -> float:
        """||a - b|| / ||b|| over every leaf, in float32."""
        num = den = 0.0
        for (_, x), (_, y) in zip(named_leaves(a), named_leaves(b)):
            num += float((x.float() - y.float()).square().sum())
            den += float(y.float().square().sum())
        return math.sqrt(num / den)

    # the warm-up step, the same step microbatched from the same state, and
    # the first half of the batch alone
    warm_s, warm, warm_m = first_moments(step, batches[0])
    micro_s, micro, micro_m = first_moments(step2, batches[0])
    _, half, half_m = first_moments(step, batches[0][:TRAIN_BATCH // 2])
    torch.cuda.empty_cache()
    micro_rel = abs(micro["loss"] - warm["loss"]) / abs(warm["loss"])
    norm_rel = abs(micro["grad_norm"] - warm["grad_norm"]) / warm["grad_norm"]
    grad_rel = grad_dist(micro_m, warm_m)
    half_rel = grad_dist(half_m, warm_m)
    del warm_m, micro_m, half_m
    torch.cuda.empty_cache()
    log(f"[train] warm-up step {warm_s:.3f} s: loss {warm['loss']!r} (ln V "
        f"{ln_v:.4f}); 2 microbatches from the same state {micro_s:.3f} s: "
        f"loss {micro['loss']!r}, rel {micro_rel:.2e} (tolerance "
        f"{MICRO_RTOL}); grad_norm {micro['grad_norm']!r} vs "
        f"{warm['grad_norm']!r}, rel {norm_rel:.2e} (tolerance "
        f"{MICRO_NORM_RTOL}); gradient ||dm||/||m|| {grad_rel:.2e} "
        f"(tolerance {MICRO_GRAD_RTOL}); the first half of the batch alone: "
        f"grad_norm {half['grad_norm']!r}, ||dm||/||m|| {half_rel:.2e}")

    # the timed steps, from the same initial state again
    params, state = train_state(cfg, opt_cfg, seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    steps = []
    for b in batches[:TRAIN_STEPS]:
        dt, m = run(step, params, state, b)
        steps.append(dict(seconds=dt, tok_s=n_tok / dt, **m))
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    for i, s in enumerate(steps):
        log(f"[train] step {i + 1}: {s['seconds']:.3f} s ({s['tok_s']:.0f} "
            f"tok/s), loss {s['loss']!r}, grad_norm {s['grad_norm']!r}, lr "
            f"{s['lr']!r}")
    step_s = float(np.median([s["seconds"] for s in steps]))
    log(f"[train] median {step_s:.3f} s a step, {n_tok / step_s:.0f} tok/s; "
        f"peak device memory {peak / 2**30:.2f} GiB; launches {launches}; "
        f"first timed loss equal to the warm-up's: "
        f"{steps[0]['loss'] == warm['loss']}")
    values = [v for s in [warm, micro, half] + steps
              for k, v in s.items() if k in ("loss", "grad_norm", "lr")]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"16b: non-finite metrics {steps}")
    if not abs(steps[0]["loss"] - ln_v) <= 0.25 * ln_v:
        raise AssertionError(f"16b: first loss {steps[0]['loss']} vs ln V "
                             f"{ln_v}")
    if not micro_rel <= MICRO_RTOL:
        raise AssertionError(f"16b: microbatched loss {micro['loss']} vs "
                             f"{warm['loss']}")
    if not (norm_rel <= MICRO_NORM_RTOL and grad_rel <= MICRO_GRAD_RTOL):
        raise AssertionError(f"16b: microbatched grad_norm rel {norm_rel}, "
                             f"gradient rel {grad_rel}")
    if launches != NO_LAUNCHES:
        raise AssertionError(f"16b: the training path launched {launches}")

    # the kernel route under grad raises (a short batch at full width)
    pallas_cfg = dataclasses.replace(cfg, use_pallas_attention=True)
    try:
        tr.lm_loss(params, batches[0][:1, :128], pallas_cfg)
    except RuntimeError as err:
        log(f"[train] use_pallas_attention=True under grad raises: {err}")
    else:
        raise AssertionError("16b: use_pallas_attention=True under grad did "
                             "not raise")
    del params, state, batches
    torch.cuda.empty_cache()
    return dict(config=dataclasses.asdict(cfg) | {"dtype": str(cfg.dtype)},
                batch=TRAIN_BATCH, seq=TRAIN_SEQ, data_s=data_s,
                warmup=dict(seconds=warm_s, **warm),
                microbatched=dict(seconds=micro_s, rel=micro_rel,
                                  grad_norm_rel=norm_rel, grad_rel=grad_rel,
                                  **micro),
                half_batch=dict(grad_rel=half_rel, **half),
                steps=steps, step_s=step_s, tok_s=n_tok / step_s,
                peak_bytes=peak, launches=launches)


def same_bits(a, b) -> bool:
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return bool(torch.equal(a, b))


def checkpoint_phase(seed: int, out_dir: Path):
    """Phase 16c: ``TrainController`` at full width and CKPT_LAYERS layers.
    Run A takes 4 steps checkpointed every 2; run B takes 2, then a fresh
    controller resumes from B's checkpoint and takes 2 more.  Every leaf
    B restored is bit-equal to B's state at the save; B's losses at steps
    3–4 equal A's within RESUME_RTOL.  A sync save, an async save and a
    restore of A's final state timed.  The directories are deleted."""
    import os
    import shutil

    import torch

    from repro_torch.configs import lm as lm_configs
    from repro_torch.data.lm import TokenStream
    from repro_torch.models import transformer as tr
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.fault import TrainController
    from repro_torch.train.optimizer import AdamWConfig, named_leaves
    from repro_torch.train.train_step import build_train_step

    cfg = dataclasses.replace(lm_configs.qwen2_1_5b(), n_layers=CKPT_LAYERS)
    opt_cfg = AdamWConfig()
    stream = TokenStream(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=seed + 1)
    batches = [torch.from_numpy(next(stream)).to("cuda") for _ in range(4)]
    step = build_train_step(lambda p, b: tr.lm_loss(p, b, cfg), opt_cfg)

    def step_fn(state, batch):
        p, o = state
        p, o, m = step(p, o, batch)
        return (p, o), m

    root = out_dir / "train_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    dirs = {name: str(root / name) for name in ("A", "B", "timed")}

    def controller(d):
        return TrainController(step_fn, d, ckpt_every=2,
                               install_signal_handler=False)

    def losses(ctl):
        return {r["step"]: r["loss"] for r in ctl.journal.read()
                if "loss" in r}

    t = time.perf_counter()
    ctl_a = controller(dirs["A"])
    start, state_a = ctl_a.resume_or_init(
        lambda: train_state(cfg, opt_cfg, seed))
    end_a, state_a, stop_a = ctl_a.run(state_a, iter(batches), start, 4)
    a_s = time.perf_counter() - t
    t = time.perf_counter()
    ctl_b = controller(dirs["B"])
    start, state_b = ctl_b.resume_or_init(
        lambda: train_state(cfg, opt_cfg, seed))
    mid_b, state_b, stop_b1 = ctl_b.run(state_b, iter(batches[:2]), start, 2)
    ctl_b2 = controller(dirs["B"])
    t_r = time.perf_counter()
    resumed, state_r = ctl_b2.resume_or_init(lambda: None)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t_r
    mine = dict(named_leaves(state_b))
    restored = dict(named_leaves(state_r))
    bit_equal = sorted(mine) == sorted(restored) and all(
        same_bits(mine[k], restored[k]) for k in mine)
    del state_b, mine
    end_b, state_r, stop_b2 = ctl_b2.run(state_r, iter(batches[2:]),
                                         resumed, 2)
    b_s = time.perf_counter() - t
    la, lb = losses(ctl_a), losses(ctl_b) | losses(ctl_b2)
    rels = {s: abs(lb[s] - la[s]) / abs(la[s]) for s in (2, 3)}
    journal = ctl_b2.journal.read()
    log(f"[train] 16c {cfg.name} at {cfg.n_layers} layers: run A {stop_a} at "
        f"step {end_a} in {a_s:.1f} s, losses {[la[s] for s in sorted(la)]}; "
        f"run B {stop_b1} at {mid_b}, resumed at {resumed} "
        f"({resume_s:.2f} s), {stop_b2} at {end_b} in {b_s:.1f} s, losses "
        f"{[lb[s] for s in sorted(lb)]}; steps 3-4 rel {rels} (tolerance "
        f"{RESUME_RTOL}), bit-equal {[lb[s] == la[s] for s in (2, 3)]}; "
        f"restored leaves bit-equal to the saved state: {bit_equal}")
    if not (stop_a == stop_b1 == stop_b2 == "completed" and end_a == 4
            and mid_b == 2 and resumed == 2 and end_b == 4):
        raise AssertionError(f"16c: runs {stop_a} {stop_b1} {stop_b2}")
    if {"event": "resumed", "step": 2} not in journal:
        raise AssertionError(f"16c: journal {journal}")
    if not bit_equal:
        raise AssertionError("16c: a restored leaf differs from the save")
    if not max(rels.values()) <= RESUME_RTOL:
        raise AssertionError(f"16c: resumed losses {lb} vs {la}")
    del state_r

    # A's final state: a sync save and an async save (the restore timed is
    # B's resume: latest step, read, to the card)
    timed = dirs["timed"]
    t = time.perf_counter()
    path = ck.save(timed, 100, state_a)
    sync_s = time.perf_counter() - t
    ckpt_bytes = os.path.getsize(path)
    saver = ck.AsyncCheckpointer(timed)
    t = time.perf_counter()
    saver.save(101, state_a)
    async_return_s = time.perf_counter() - t
    saver.wait()
    async_s = time.perf_counter() - t
    n_params = sum(t.numel() for k, t in named_leaves(state_a)
                   if k.startswith("0/"))
    log(f"[train] checkpoint of {n_params:,} parameters and their moments: "
        f"{ckpt_bytes / 1e9:.3f} GB; sync save {sync_s:.2f} s, async save "
        f"returns in {async_return_s:.2f} s (the host copy) and is written "
        f"in {async_s:.2f} s; restore to the card (B's resume) "
        f"{resume_s:.2f} s")
    # where a step's time goes, at this depth (a trace of all 28 layers
    # holds ~89,000 launches and takes minutes to read)
    prof = profile_call(lambda: step_fn(state_a, batches[0]),
                        f"one train step of {cfg.name} at {cfg.n_layers} "
                        f"layers, {TRAIN_BATCH * TRAIN_SEQ} tokens")
    del state_a
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return dict(layers=cfg.n_layers, params=n_params, ckpt_bytes=ckpt_bytes,
                sync_save_s=sync_s, async_return_s=async_return_s,
                async_save_s=async_s, restore_s=resume_s,
                run_a_s=a_s, run_b_s=b_s,
                losses_a=[la[s] for s in sorted(la)],
                losses_b=[lb[s] for s in sorted(lb)], resume_rel=rels,
                resume_bit_equal=[lb[s] == la[s] for s in (2, 3)],
                restored_bit_equal=bit_equal, profile=prof)


def train_cli_phase(out_dir: Path):
    """Phase 16d: ``launch.train.main`` on the card, reduced qwen2-1.5b, 6
    steps checkpointed every 3, then the same with ``--steps 9``: the
    journal shows ``resumed`` at step 6 and both runs end."""
    import contextlib
    import io
    import shutil

    from repro_torch.launch import train as launch_train

    d = out_dir / "train_cli"
    shutil.rmtree(d, ignore_errors=True)
    base = ["--arch", "qwen2-1.5b", "--reduced", "--ckpt-every", "3",
            "--log-every", "3", "--ckpt-dir", str(d), "--device", "cuda"]
    outs, ctls = [], []
    t = time.perf_counter()
    for n in (6, 9):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ctls.append(launch_train.main(base + ["--steps", str(n)]))
        outs.append(buf.getvalue())
    cli_s = time.perf_counter() - t
    journal = ctls[1].journal.read()
    steps = [r["step"] for r in journal if "loss" in r]
    log(f"[train] 16d launch.train on the card in {cli_s:.1f} s: "
        + " | ".join(o.strip().splitlines()[-1] for o in outs)
        + f"; journal steps {steps}")
    if {"event": "resumed", "step": 6} not in journal or \
            steps != list(range(9)):
        raise AssertionError(f"16d: journal {journal}")
    shutil.rmtree(d, ignore_errors=True)
    return dict(seconds=cli_s, stdout=outs, journal_steps=steps)


def train_phase(seed: int, out_dir: Path):
    """Phase 16: LM training (16a-16d), every kernel's launches 0."""
    import torch

    from repro_torch.kernels import ops

    t = time.perf_counter()
    ops.reset_launches()
    out = {"flash_backward": flash_backward_phase(seed)}
    if dict(ops.launches) != NO_LAUNCHES:
        raise AssertionError(f"16a launched {dict(ops.launches)}")
    out["steps"] = train_steps_phase(seed)
    out["checkpoint"] = checkpoint_phase(seed, out_dir)
    out["cli"] = train_cli_phase(out_dir)
    out["launches"] = out["steps"]["launches"]
    if dict(ops.launches) != NO_LAUNCHES:
        raise AssertionError(f"phase 16 launched {dict(ops.launches)}")
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t
    log(f"[train] phase 16 in {out['seconds']:.1f} s")
    return out


# -- phase 17: LM sharding on the one card -------------------------------------

# 17a-c: qwen2-1.5b at full width and LM_SHARD_LAYERS of its 28 layers (the
# phase's ~110 s cut the depth; the widths all divide the model axis of 2)
LM_SHARD_LAYERS = 2
# the train_4k cell's S (on an H100 phase 17 took 54.8 s at 4096 and
# 47.6 s at 1024: a step's bytes are mostly FSDP's, whatever S)
LM_SHARD_BATCH, LM_SHARD_SEQ = 4, 4096
LM_SHARD_STEPS, LM_SHARD_DECODE = 3, 16
# 17c: GPipe microbatches over the pod axis of 2 (one layer a stage)
PIPE_MICRO = 4
# 17d: mixtral-8x22b's MoE layer at full width, 2 groups of 4096 tokens
MOE_SHARD_GROUPS, MOE_SHARD_TOKENS = 2, 4096
# a rank's collectives fail the rank after this long (a dead peer)
LM_SHARD_TIMEOUT_S = 180
# the collectives of the redistribute matrix (17b), on CUDA tensors over
# gloo; ``GLOO_CUDA_STAGED`` of distributed/collectives.py names those that
# the port runs on host copies instead
GLOO_MATRIX = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
               "send_recv")


def lm_shard_cfg(**kw):
    from repro_torch.configs import lm as lm_configs

    return dataclasses.replace(lm_configs.qwen2_1_5b(),
                               n_layers=LM_SHARD_LAYERS, **kw)


def lm_shard_batches(cfg, seed: int):
    """LM_SHARD_STEPS training batches and the serving prompt, [B, S] int32
    numpy each, the same on every rank (``TokenStream`` from a seed)."""
    from repro_torch.data.lm import TokenStream

    stream = TokenStream(cfg.vocab, LM_SHARD_BATCH, LM_SHARD_SEQ,
                         seed=seed + 17)
    return [next(stream) for _ in range(LM_SHARD_STEPS + 1)]


def moe_shard_layer(seed: int):
    """mixtral-8x22b's MoE layer at full width (router [D, E], w1/w3
    [E, D, F], w2 [E, F, D], bf16, N(0, 1/fan_in)) and its tokens
    [groups·tokens, D], seeded on the card alike on every rank."""
    import torch

    from repro_torch.configs import lm as lm_configs
    from repro_torch.models import layers as nn

    cfg = lm_configs.mixtral_8x22b()
    D, F, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    gen = torch.Generator(device="cuda").manual_seed(seed + 1717)

    def draw(shape, fan_in):
        x = torch.empty(shape, dtype=torch.bfloat16, device="cuda")
        for i in range(shape[0]):         # one expert's slice at a time
            x[i] = (torch.randn(shape[1:], generator=gen, device="cuda")
                    / fan_in ** 0.5).to(torch.bfloat16)
        return x

    router = (torch.randn((D, E), generator=gen, device="cuda")
              / D ** 0.5).to(torch.bfloat16)
    p = nn.MoEParams(router, draw((E, D, F), D), draw((E, D, F), D),
                     draw((E, F, D), F))
    x = torch.randn((MOE_SHARD_GROUPS * MOE_SHARD_TOKENS, D), generator=gen,
                    device="cuda").to(torch.bfloat16)
    return cfg, p, x


def lm_shard_reference(seed: int, path: Path):
    """The unsharded runs phase 17's ranks are held against, on the card,
    saved to ``path``: LM_SHARD_STEPS train steps from the seeded state
    (each step's loss and grad_norm; the first is 17c's reference too: the
    pipeline runs that batch as PIPE_MICRO microbatches), the prompt's
    prefill through ``flash_fwd`` and LM_SHARD_DECODE greedy decode steps
    (their logits and tokens), and mixtral's MoE layer by the one-rank
    ``moe_layer_grouped(n_groups=MOE_SHARD_GROUPS)`` with its routes."""
    import torch

    from repro_torch.models import layers as nn
    from repro_torch.models import transformer as tr
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import build_train_step

    t = time.perf_counter()
    cfg = lm_shard_cfg()
    batches = [torch.from_numpy(b).to("cuda")
               for b in lm_shard_batches(cfg, seed)]
    opt = AdamWConfig()
    params, state = train_state(cfg, opt, seed)
    step = build_train_step(lambda p, b: tr.lm_loss(p, b, cfg), opt)
    train = []
    for b in batches[:LM_SHARD_STEPS]:
        _, _, m = step(params, state, b)
        train.append({k: float(v) for k, v in m.items()})
    del params, state
    kcfg = lm_shard_cfg(use_pallas_attention=True)
    params = tr.init_params(kcfg, torch.Generator(device="cuda").manual_seed(
        seed), device="cuda").tree()
    prompt = batches[LM_SHARD_STEPS]
    with torch.no_grad():
        logits, cache = tr.prefill(params, prompt, kcfg,
                                   pad_cache_to=LM_SHARD_SEQ + LM_SHARD_DECODE)
        decode, tokens = [], []
        for i in range(LM_SHARD_DECODE):
            tok = logits.argmax(dim=-1) if i == 0 else decode[-1].argmax(-1)
            tokens.append(tok)
            got, cache = tr.decode_step(params, cache, tok, LM_SHARD_SEQ + i,
                                        kcfg)
            decode.append(got)
    del params, cache
    torch.cuda.empty_cache()
    mcfg, p, x = moe_shard_layer(seed)
    with torch.no_grad():
        y = nn.moe_layer_grouped(x, p, mcfg.moe.top_k,
                                 mcfg.moe.capacity_factor, MOE_SHARD_GROUPS)
        r = nn.moe_routes(x.reshape(MOE_SHARD_GROUPS, MOE_SHARD_TOKENS, -1),
                          p.router, mcfg.moe.top_k, mcfg.moe.capacity_factor)
    torch.save({"train": train, "prefill": logits.cpu(),
                "decode": torch.stack(decode).cpu(),
                "tokens": torch.stack(tokens).cpu(),
                "moe": {"y": y.cpu(), "experts": r.experts.cpu(),
                        "keep": r.keep.cpu()}}, path)
    del p, x, y, r
    torch.cuda.empty_cache()
    return {"train": train, "seconds": time.perf_counter() - t}


def lm_world_one_phase(seed: int):
    """Phase 17a: ``lm_rules`` on a (1, 1) mesh of a world of one over NCCL
    (``make_host_mesh``), qwen2-1.5b at full width and LM_SHARD_LAYERS
    layers: the sharded ``lm_loss`` of the first training batch against the
    unsharded one, the sharded prefill (through ``flash_fwd``) and four
    decode steps' logits against the unsharded ones (LOGIT_RTOL of max
    |logits|), and one all-reduce over the mesh's model group."""
    import torch

    from repro_torch.distributed.collectives import census, release_world
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tr
    from repro_torch.models.sharding import lm_rules

    t = time.perf_counter()
    cfg = lm_shard_cfg(use_pallas_attention=True)
    batches = lm_shard_batches(cfg, seed)
    toks = torch.from_numpy(batches[0]).to("cuda")
    params = tr.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        seed), device="cuda").tree()
    mesh = make_host_mesh((1, 1), device="cuda")
    backend = torch.distributed.get_backend(mesh.get_group("model"))
    rules = lm_rules(mesh)
    sp = tr.shard_params(params, tr.param_shardings(cfg, rules))
    census.reset()
    with torch.no_grad():
        one = float(tr.lm_loss(params, toks, cfg))
        got = float(tr.lm_loss(sp, toks, cfg, rules))
        cap = LM_SHARD_SEQ + 4
        want_l, wc = tr.prefill(params, toks, cfg, pad_cache_to=cap)
        got_l, gc = tr.prefill(sp, toks, cfg, rules, pad_cache_to=cap)
        errs = []
        for i in range(5):
            g = got_l.full_tensor()
            errs.append(float((g - want_l).abs().max()
                              / want_l.abs().max()))
            if i == 4:
                break
            tok = want_l.argmax(-1)
            want_l, wc = tr.decode_step(params, wc, tok, LM_SHARD_SEQ + i,
                                        cfg)
            got_l, gc = tr.decode_step(sp, gc, tok, LM_SHARD_SEQ + i, cfg,
                                       rules)
    x = torch.ones(4, device="cuda")
    torch.distributed.all_reduce(x, group=mesh.get_group("model"))
    rel = abs(got - one) / abs(one)
    log(f"[lm shard] 17a world one ({backend} on the model group), "
        f"{cfg.name} at {cfg.n_layers} layers: sharded lm_loss {got!r} vs "
        f"unsharded {one!r} (rel {rel:.2e}, tolerance {MICRO_RTOL}); "
        f"prefill and 4 decode steps' logits rel {[f'{e:.2e}' for e in errs]}"
        f" (tolerance {LOGIT_RTOL}); collectives {census.snapshot()}")
    if not (rel <= MICRO_RTOL and max(errs) <= LOGIT_RTOL
            and float(x[0]) == 1.0):
        raise AssertionError(f"17a: loss rel {rel}, logits {errs}")
    del params, sp, wc, gc
    release_world()
    torch.cuda.empty_cache()
    return dict(loss=got, unsharded=one, rel=rel, logits_rel=errs,
                backend=backend, seconds=time.perf_counter() - t)


def gloo_cuda_matrix(rank: int, native: bool, ops=GLOO_MATRIX):
    """17b's redistribute matrix: each collective of ``ops`` on small CUDA
    tensors over the default gloo group of the four ranks, its values
    checked; ``native`` passes the CUDA tensors to gloo, else the ops of
    ``GLOO_CUDA_STAGED`` get host copies as the port's collectives give
    them.  {op: "native" | "staged" | the error}."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import collectives as C

    n = dist.get_world_size()
    rows = [torch.arange(8.0) + 8 * r for r in range(n)]
    x = rows[rank].to("cuda")
    out = {}

    def run(op):
        src = x.cpu() if not native and op in C.GLOO_CUDA_STAGED else x
        if op == "all_reduce":
            y = src.clone()
            dist.all_reduce(y)
            want = sum(rows)
        elif op == "all_gather":
            parts = [torch.empty_like(src) for _ in range(n)]
            dist.all_gather(parts, src)
            y, want = torch.cat(parts), torch.cat(rows)
        elif op == "reduce_scatter":
            y = src.new_empty(8 // n)
            dist.reduce_scatter_tensor(y, src)
            want = sum(rows).chunk(n)[rank]
        elif op == "all_to_all":
            y = torch.empty_like(src)
            dist.all_to_all_single(y, src)
            want = torch.cat([r.chunk(n)[rank] for r in rows])
        else:           # send_recv: to the next rank, from the previous
            y = torch.empty_like(src)
            for w in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, src, (rank + 1) % n),
                    dist.P2POp(dist.irecv, y, (rank - 1) % n)]):
                w.wait()
            want = rows[(rank - 1) % n]
        if not torch.equal(y.cpu(), want):
            raise AssertionError(f"{op}: {y.tolist()} vs {want.tolist()}")
        return "native" if src.is_cuda else "staged"

    for op in ops:
        try:
            out[op] = run(op)
        except Exception as err:                    # noqa: BLE001
            out[op] = f"{type(err).__name__}: {str(err)[:160]}"
    return out


def _probe_rank(rank: int, store: str, out_path: str, op: str) -> None:
    """One rank of ``gloo_native_probe``: ``op`` on CUDA tensors passed to
    gloo as they are."""
    import datetime

    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(store, SHARD_RANKS),
                            rank=rank, world_size=SHARD_RANKS,
                            timeout=datetime.timedelta(seconds=60))
    torch.cuda.set_device(0)
    res = gloo_cuda_matrix(rank, native=True, ops=(op,))
    Path(f"{out_path}.{rank}").write_text(json.dumps(res))
    dist.destroy_process_group()


def gloo_native_probe(out_dir: Path) -> dict:
    """Which collectives gloo carries on CUDA tensors: each op of
    GLOO_MATRIX natively in four spawned ranks of its own (a rank that gloo
    aborts ends only that op's ranks).  Not run by ``main`` (five spawns
    cost ~40 s); ``GLOO_CUDA_STAGED`` holds what it found.  {op: "native" |
    the error}."""
    out = {}
    for op in GLOO_MATRIX:
        path = out_dir / f"gloo_probe_{op}.json"
        try:
            run_ranks(_probe_rank, path, (op,), timeout_s=120)
            res = {json.loads(Path(f"{path}.{r}").read_text())[op]
                   for r in range(SHARD_RANKS)}
            out[op] = res.pop() if len(res) == 1 else sorted(res)
        except AssertionError as err:
            out[op] = f"ranks aborted: {err}"
    log(f"[gloo probe] CUDA tensors passed to gloo as they are: {out}")
    return out


def _rel(got, want) -> float:
    """max |got − want| / max |want|, in float32 on the host."""
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / want.abs().max())


def _lm_rank(rank: int, store: str, out_path: str, seed: int, ref_path: str,
             ckpt_dir: str) -> None:
    """One rank of 17b-e (a spawned process, gloo over CUDA tensors, every
    rank on the one card).  Each step all-reduces an ok flag, so a rank
    that fails fails every rank at that step instead of leaving them in a
    collective; the rank writes its numbers to ``out_path.<rank>``."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist

    from repro_torch.configs import lm as lm_configs
    from repro_torch.distributed import collectives as C
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as nn
    from repro_torch.models import transformer as tr
    from repro_torch.models.sharding import ShardingRules, lm_rules, whole
    from repro_torch.train import checkpoint as ck
    from repro_torch.train import pipeline as pl
    from repro_torch.train.optimizer import (AdamWConfig, init_state,
                                             named_leaves)
    from repro_torch.train.train_step import build_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, SHARD_RANKS),
                            rank=rank, world_size=SHARD_RANKS,
                            timeout=datetime.timedelta(
                                seconds=LM_SHARD_TIMEOUT_S))
    torch.cuda.set_device(0)
    res = {"rank": rank}

    def phase(name, fn):
        t = time.perf_counter()
        err, got = None, None
        try:
            got = fn()
            torch.cuda.synchronize()
        except Exception:                           # noqa: BLE001
            err = traceback.format_exc()
        flag = torch.tensor([0.0 if err else 1.0])
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        if err:
            raise RuntimeError(f"rank {rank}, {name}:\n{err}")
        if float(flag) < 1.0:
            raise RuntimeError(f"rank {rank}, {name}: another rank failed")
        res[name] = got
        res[f"{name}_s"] = time.perf_counter() - t

    phase("matrix", lambda: gloo_cuda_matrix(rank, native=False))
    want = torch.load(ref_path)
    cfg = lm_shard_cfg()
    kcfg = lm_shard_cfg(use_pallas_attention=True)
    B, S = LM_SHARD_BATCH, LM_SHARD_SEQ
    batches = [torch.from_numpy(b).to("cuda")
               for b in lm_shard_batches(cfg, seed)]
    mesh = make_host_mesh((2, 2), ("data", "model"), device="cuda")
    pmesh = make_host_mesh((2, 2), ("pod", "model"), device="cuda")
    rules = lm_rules(mesh)
    opt = AdamWConfig()

    def seeded(c):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return tr.init_params(c, gen, device="cuda").tree()

    def flash_local():
        """flash_fwd at a model rank's local heads of qwen2's prefill."""
        H_l, KV_l, D = cfg.n_heads // 2, cfg.n_kv_heads // 2, cfg.d_head
        gen = torch.Generator(device="cuda").manual_seed(seed + 23)
        q, k, v = (torch.randn((B // 2, S, n, D), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for n in (H_l, KV_l, KV_l))
        kw = dict(g_per_kv=H_l // KV_l, causal=True, scale=D ** -0.5)
        out, _ = ops.flash_fwd(q, k, v, **kw)
        q3, k3, v3 = (t.contiguous() for t in ops._regroup(q, k, v))
        plain, _ = ref.flash_fwd_ref(q3, k3, v3, **kw)
        s_out, _ = ref.flash_fwd_scales(q3, k3, v3, **kw)
        err = check_close(f"[lm shard] rank {rank} flash_fwd [{B // 2}, {S}, "
                          f"{H_l}, {D}] over {KV_l} KV heads",
                          [ops._regroup(out, k, v)[0].float()],
                          [plain.float()], FLASH_RTOL["bfloat16"], [s_out])
        return dict(shape=[B // 2, S, H_l, D], kv=KV_l, max_abs_err=err,
                    ms=time_ms(lambda: ops.flash_fwd(q, k, v, **kw), 10))

    def serve():
        """Sharded prefill of the prompt through flash_fwd on the local
        heads, then LM_SHARD_DECODE decode steps on the sharded caches fed
        the unsharded run's greedy tokens; params TP only (no FSDP gather
        at every step)."""
        tp_rules = ShardingRules(mesh, dict(rules.rules, fsdp=None))
        sp = tr.shard_params(seeded(kcfg), tr.param_shardings(kcfg, tp_rules))
        C.census.reset()
        ops.reset_launches()
        with torch.no_grad():
            logits, cache = tr.prefill(sp, batches[-1], kcfg, rules,
                                       pad_cache_to=S + LM_SHARD_DECODE)
            launches = dict(ops.launches)
            prefill_bytes = C.census.snapshot()
            errs = [_rel(whole(logits), want["prefill"])]
            for i in range(LM_SHARD_DECODE):
                logits, cache = tr.decode_step(
                    sp, cache, want["tokens"][i].to("cuda"), S + i, kcfg,
                    rules)
                errs.append(_rel(whole(logits), want["decode"][i]))
            placements = {k: str(v.placements) for k, v in cache.items()}
            # split-KV: a batch of 1, the caches' sequence over data
            logits, cache = tr.prefill(sp, batches[-1][:1], kcfg, rules,
                                       pad_cache_to=S + LM_SHARD_DECODE)
            kv_errs = [_rel(whole(logits), want["prefill"][:1])]
            C.census.reset()
            for i in range(LM_SHARD_DECODE):
                logits, cache = tr.decode_step(
                    sp, cache, want["tokens"][i][:1].to("cuda"), S + i, kcfg,
                    rules)
                kv_errs.append(_rel(whole(logits), want["decode"][i][:1]))
        return dict(logits_rel=errs, launches=launches,
                    prefill_census=prefill_bytes,
                    cache_placements=placements,
                    split_kv=dict(logits_rel=kv_errs,
                                  decode_census=C.census.snapshot(),
                                  cache_placements={
                                      k: str(v.placements)
                                      for k, v in cache.items()}))

    def train():
        sp = tr.shard_params(seeded(cfg), tr.param_shardings(cfg, rules))
        state = init_state(opt, sp)
        step = build_train_step(lambda p, b: tr.lm_loss(p, b, cfg, rules),
                                opt)
        steps, first = [], None
        torch.cuda.reset_peak_memory_stats()
        for i, b in enumerate(batches[:LM_SHARD_STEPS]):
            C.census.reset()
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, _, m = step(sp, state, b)
            m = {k: float(v) for k, v in m.items()}
            steps.append(dict(m, seconds=time.perf_counter() - t))
            first = first or C.census.snapshot()
        return dict(steps=steps, census_step=first,
                    peak_bytes=torch.cuda.max_memory_allocated())

    def pipe():
        staged = pl.stage_params_from_flat(seeded(cfg), 2)
        sp = tr.shard_params(staged, pl.stage_param_shardings(cfg, pmesh))
        state = init_state(opt, sp)
        step = build_train_step(pl.build_pipeline_loss(cfg, pmesh, None,
                                                       PIPE_MICRO), opt)
        C.census.reset()
        toks = batches[0].reshape(PIPE_MICRO, B // PIPE_MICRO, S)
        _, _, m = step(sp, state, toks)
        return dict({k: float(v) for k, v in m.items()},
                    census=C.census.snapshot())

    def moe():
        mcfg, p, x = moe_shard_layer(seed)
        specs = {"router": ("fsdp", None),
                 "w1": ("expert_ep", "fsdp", "d_ff"),
                 "w3": ("expert_ep", "fsdp", "d_ff"),
                 "w2": ("expert_ep", "d_ff", "fsdp")}
        pd = nn.MoEParams(*(
            tr.shard_params(getattr(p, k), rules.named_sharding(
                *specs[k], shape=getattr(p, k).shape))
            for k in nn.MoEParams._fields))
        router = p.router
        del p
        torch.cuda.empty_cache()
        g = C.mesh_coord(mesh, ("data",))
        T = MOE_SHARD_TOKENS
        xl = x[g * T:(g + 1) * T]
        C.census.reset()
        with torch.no_grad():
            y = nn.moe_layer_grouped(xl, pd, mcfg.moe.top_k,
                                     mcfg.moe.capacity_factor,
                                     MOE_SHARD_GROUPS, rules)
            r = nn.moe_routes(xl, router, mcfg.moe.top_k,
                              mcfg.moe.capacity_factor)
        ref_y = want["moe"]["y"][g * T:(g + 1) * T]
        return dict(
            group=g, y_rel=_rel(y, ref_y),
            routes_equal=bool(torch.equal(r.experts.cpu(),
                                          want["moe"]["experts"][g])
                              and torch.equal(r.keep.cpu(),
                                              want["moe"]["keep"][g])),
            dropped=int((~r.keep).sum()), entries=int(r.keep.numel()),
            placements={k: str(getattr(pd, k).placements)
                        for k in nn.MoEParams._fields},
            census=C.census.snapshot())

    def elastic():
        """A reduced qwen2 state on the (data 2, model 2) mesh: a step,
        a save, the next step uninterrupted; restored onto the same mesh
        and stepped again, and onto (pod 2, model 2)."""
        ecfg = lm_configs.reduced_lm("qwen2-1.5b")
        psh = tr.param_shardings(ecfg, rules)
        gen = torch.Generator(device="cuda").manual_seed(seed + 29)
        sp = tr.shard_params(tr.init_params(ecfg, gen, device="cuda").tree(),
                             psh)
        state = init_state(opt, sp)
        step = build_train_step(lambda p, b: tr.lm_loss(p, b, ecfg, rules),
                                opt)
        toks = torch.randint(0, ecfg.vocab, (2, B, 64), generator=gen,
                             device="cuda")
        step(sp, state, toks[0])
        t = time.perf_counter()
        ck.save(ckpt_dir, 1, [sp, state])
        save_s = time.perf_counter() - t
        saved = [whole(v).clone() for _, v in named_leaves([sp, state])]
        if rank == 0:
            torch.save([v.cpu() for v in saved], f"{ckpt_dir}/saved.pt")
        _, _, m = step(sp, state, toks[1])
        out = dict(save_s=save_s, loss=float(m["loss"]))
        for label, msh in (("same", mesh), ("pod", pmesh)):
            r = lm_rules(msh)
            ps = tr.param_shardings(ecfg, r)
            t = time.perf_counter()
            _, tree, _ = ck.restore(ckpt_dir, 1, device="cuda", shardings=[
                ps, {"m": ps, "v": ps, "count": None}])
            out[f"{label}_restore_s"] = time.perf_counter() - t
            leaves = [v for _, v in named_leaves(tree)]
            out[f"{label}_equal"] = all(
                torch.equal(whole(a), b) for a, b in zip(leaves, saved))
            out[f"{label}_placed"] = (
                tree[0]["embed"].device_mesh is msh
                and list(tree[0]["embed"].placements) == ps["embed"][1])
            if label == "same":
                rstep = build_train_step(
                    lambda p, b: tr.lm_loss(p, b, ecfg, r), opt)
                _, _, m2 = rstep(tree[0], tree[1], toks[1])
                out["resumed_loss"] = float(m2["loss"])
        return out

    if rank == 0:
        phase("flash_local", flash_local)
    else:
        phase("flash_local", lambda: None)
    for name, fn in (("serve", serve), ("train", train), ("pipe", pipe),
                     ("moe", moe), ("elastic", elastic)):
        phase(name, fn)
        torch.cuda.empty_cache()
    Path(f"{out_path}.{rank}").write_text(json.dumps(res))
    dist.destroy_process_group()


def lm_elastic_world_one(seed: int, ckpt_dir: Path):
    """17e's third layout: the checkpoint the four ranks saved, restored
    onto a (1, 1) mesh of a world of one (NCCL) and whole: array-equal to
    the saved leaves."""
    import torch

    from repro_torch.configs import lm as lm_configs
    from repro_torch.distributed.collectives import release_world
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tr
    from repro_torch.models.sharding import lm_rules
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.optimizer import named_leaves

    saved = torch.load(ckpt_dir / "saved.pt")
    ecfg = lm_configs.reduced_lm("qwen2-1.5b")
    mesh = make_host_mesh((1, 1), device="cuda")
    ps = tr.param_shardings(ecfg, lm_rules(mesh))
    _, tree, _ = ck.restore(str(ckpt_dir), 1, device="cuda", shardings=[
        ps, {"m": ps, "v": ps, "count": None}])
    _, plain, _ = ck.restore(str(ckpt_dir), 1, device="cuda")
    ok = all(torch.equal(a.to_local().cpu() if hasattr(a, "to_local")
                         else a.cpu(), s) and torch.equal(b.cpu(), s)
             for (_, a), (_, b), s in zip(named_leaves(tree),
                                          named_leaves(plain), saved))
    release_world()
    return ok


def lm_shard_phase(seed: int, out_dir: Path):
    """Phase 17: LM sharding (17a world one over NCCL; the unsharded
    references; 17b-e in four spawned gloo ranks on the one card: the
    redistribute matrix, serving, training, the pipeline, the MoE layer,
    the elastic restore; then 17e's world-one restore)."""
    import shutil

    import torch

    t = time.perf_counter()
    out = {"world_one": lm_world_one_phase(seed)}
    ref_path = out_dir / "lm_shard_ref.pt"
    out["reference"] = lm_shard_reference(seed, ref_path)
    want = torch.load(ref_path)
    ckpt = out_dir / "lm_shard_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    ckpt.mkdir(parents=True)
    out_path = out_dir / "chip_smoke_lm_shard.json"
    wall = run_ranks(_lm_rank, out_path, (seed, str(ref_path), str(ckpt)),
                     timeout_s=600)
    ranks = [json.loads(Path(f"{out_path}.{r}").read_text())
             for r in range(SHARD_RANKS)]
    out["ranks_wall_s"] = wall
    out["elastic_world_one"] = lm_elastic_world_one(seed, ckpt)
    shutil.rmtree(ckpt, ignore_errors=True)
    ref_path.unlink()
    head = ranks[0]
    out.update({k: head[k] for k in ("matrix", "flash_local", "serve",
                                     "train", "pipe", "moe", "elastic")})
    out["rank_seconds"] = {k: [r[f"{k}_s"] for r in ranks]
                           for k in ("serve", "train", "pipe", "moe",
                                     "elastic")}
    log(f"[lm shard] 17b gloo on CUDA tensors, four ranks: "
        f"{[r['matrix'] for r in ranks]}")
    fl = head["flash_local"]
    log(f"[lm shard] 17b flash_fwd at the local heads {fl['shape']} over "
        f"{fl['kv']} KV head: {fl['ms']:.4f} ms, max abs err "
        f"{fl['max_abs_err']:.3e}")
    fails = [f"rank {r['rank']} matrix {r['matrix']}" for r in ranks
             if set(r["matrix"].values()) - {"native", "staged"}]
    # training against the unsharded steps
    for r in ranks:
        for i, (s, w) in enumerate(zip(r["train"]["steps"], want["train"])):
            lr = abs(s["loss"] - w["loss"]) / abs(w["loss"])
            nr = abs(s["grad_norm"] - w["grad_norm"]) / w["grad_norm"]
            if not (lr <= MICRO_RTOL and nr <= MICRO_NORM_RTOL):
                fails.append(f"rank {r['rank']} step {i}: loss rel {lr}, "
                             f"grad_norm rel {nr}")
    st = head["train"]["steps"]
    log(f"[lm shard] 17b train (data 2, model 2), {lm_shard_cfg().name} at "
        f"{LM_SHARD_LAYERS} layers, B {LM_SHARD_BATCH}, S {LM_SHARD_SEQ}: "
        + "; ".join(f"step {i + 1} {s['seconds']:.2f} s loss {s['loss']!r} "
                    f"(unsharded {w['loss']!r}) grad_norm {s['grad_norm']!r} "
                    f"(unsharded {w['grad_norm']!r})"
                    for i, (s, w) in enumerate(zip(st, want["train"])))
        + f"; peak {head['train']['peak_bytes'] / 2**30:.2f} GiB a rank; "
        f"bytes a rank in a step {head['train']['census_step']}")
    sv = head["serve"]
    log(f"[lm shard] 17b serve: prefill launches {sv['launches']}, logits "
        f"rel max {max(max(r['serve']['logits_rel']) for r in ranks):.3e} "
        f"(tolerance {LOGIT_RTOL}); caches {sv['cache_placements']}; "
        f"prefill bytes {sv['prefill_census']}")
    kv = sv["split_kv"]
    kv_calls = 3 * LM_SHARD_LAYERS * LM_SHARD_DECODE
    log(f"[lm shard] 17b split-KV serve (B 1): logits rel max "
        f"{max(max(r['serve']['split_kv']['logits_rel']) for r in ranks):.3e}"
        f" (tolerance {LOGIT_RTOL}); caches {kv['cache_placements']}; "
        f"decode bytes {kv['decode_census']} (all_reduce[data] calls "
        f"expected {kv_calls}, no all_gather[data])")
    for r in ranks:
        if max(r["serve"]["logits_rel"]) > LOGIT_RTOL:
            fails.append(f"rank {r['rank']} logits {r['serve']['logits_rel']}")
        rk = r["serve"]["split_kv"]
        seq_split = all(p.startswith("(Shard(dim=2)")
                        for p in rk["cache_placements"].values())
        dc = rk["decode_census"]
        if not (max(rk["logits_rel"]) <= LOGIT_RTOL and seq_split
                and "all_gather[data]" not in dc
                and dc.get("all_reduce[data]", {}).get("calls") == kv_calls):
            fails.append(f"rank {r['rank']} split-KV {rk}")
        if r["serve"]["launches"].get("flash_fwd") != LM_SHARD_LAYERS:
            fails.append(f"rank {r['rank']} prefill launches "
                         f"{r['serve']['launches']}")
    pw = want["train"][0]
    for r in ranks:
        p = r["pipe"]
        lr = abs(p["loss"] - pw["loss"]) / abs(pw["loss"])
        nr = abs(p["grad_norm"] - pw["grad_norm"]) / pw["grad_norm"]
        if not (lr <= MICRO_RTOL and nr <= MICRO_NORM_RTOL):
            fails.append(f"rank {r['rank']} pipeline loss rel {lr}, "
                         f"grad_norm rel {nr}")
    log(f"[lm shard] 17c pipeline (pod 2, model 2), {PIPE_MICRO} "
        f"microbatches: loss {head['pipe']['loss']!r} vs {pw['loss']!r}, "
        f"grad_norm {head['pipe']['grad_norm']!r} vs {pw['grad_norm']!r}; "
        f"bytes {head['pipe']['census']}")
    for r in ranks:
        m = r["moe"]
        if not (m["routes_equal"] and m["y_rel"] <= MOE_RTOL):
            fails.append(f"rank {r['rank']} moe {m}")
    log(f"[lm shard] 17d mixtral-8x22b MoE layer, {MOE_SHARD_GROUPS} groups "
        f"of {MOE_SHARD_TOKENS} tokens over data 2, EP over data, TP over "
        f"model: routes equal {[r['moe']['routes_equal'] for r in ranks]}, "
        f"y rel {[round(r['moe']['y_rel'], 5) for r in ranks]} (tolerance "
        f"{MOE_RTOL}); dropped per group "
        f"{sorted({(r['moe']['group'], r['moe']['dropped']) for r in ranks})}"
        f" of {head['moe']['entries']}; placements "
        f"{head['moe']['placements']}; bytes {head['moe']['census']}")
    for r in ranks:
        e = r["elastic"]
        if not (e["same_equal"] and e["pod_equal"] and e["same_placed"]
                and e["pod_placed"] and e["resumed_loss"] == e["loss"]):
            fails.append(f"rank {r['rank']} elastic {e}")
    if not out["elastic_world_one"]:
        fails.append("17e world-one restore differs")
    e = head["elastic"]
    log(f"[lm shard] 17e elastic: save {e['save_s']:.2f} s, restore same "
        f"mesh {e['same_restore_s']:.2f} s, (pod 2, model 2) "
        f"{e['pod_restore_s']:.2f} s, world one equal "
        f"{out['elastic_world_one']}; resumed loss {e['resumed_loss']!r} vs "
        f"uninterrupted {e['loss']!r}")
    out["seconds"] = time.perf_counter() - t
    log(f"[lm shard] phase 17 in {out['seconds']:.1f} s (four ranks "
        f"{wall:.1f} s: {out['rank_seconds']})")
    if fails:
        raise AssertionError("phase 17: " + "; ".join(fails))
    out["launches"] = sv["launches"]
    return out


# -- phase 18: GNN and recsys training on the card ------------------------------

# 18a: the four GNNs at full width on the launcher's cell (full_graph_sm);
# DimeNet and MeshGraphNet also at minibatch_lg's padded shapes (169,984
# nodes, 168,960 edges; DimeNet's 1,048,576 triplets).  ogb_products is
# not taken: its 123.7M triplets at h = 128 are 63 GB a tensor
GNN_LARGE, GNN_LARGE_CELL = ("dimenet", "meshgraphnet"), "minibatch_lg"
# the reference test's small step (warm-up 1, no decay) at lr 1e-4, or
# less where a step of 1e-4 on every parameter overshoots: Adam's first
# step moves each parameter by lr·sign(g), so its first-order change of the
# loss is -lr·Σ|g|; the step is taken at lr = min(1e-4, 1e-3·loss/Σ|g|),
# a first-order decrease of 0.1% of the loss at most (a single graph's
# energy over 2,708 atoms moves by far more than that at 1e-4)
GNN_STEP = dict(lr=1e-4, warmup_steps=1, weight_decay=0.0)
GNN_DESCENT = 1e-3
# 18b: DIN on din()'s full tables (100M item, 1M category and 100K tag
# rows at d = 18: 7.28 GB of float32), the train_batch cell's B = 65,536
# at S = 100, five AdamW steps at lr 1e-2 (the reference test's)
DIN_TRAIN_B, DIN_STEPS = 65536, 5
DIN_STEP = dict(lr=1e-2, warmup_steps=1)
# serve_p99's B, timed over this many calls; retrieval_cand's candidates,
# scored in chunks (at 1M × [100, 144] float32 one broadcast is 57.6 GB),
# of which this many are held against din_logits
DIN_SERVE_B, DIN_SERVE_CALLS = 512, 50
DIN_CANDIDATES, DIN_CHUNK, DIN_CHECKED = 1_000_000, 65536, 512


def tree_clone(tree):
    from repro_torch.train.checkpoint import tree_map

    return tree_map(lambda t: t.detach().clone(), tree)


def tree_same_bits(a, b) -> bool:
    from repro_torch.train.checkpoint import named_leaves

    la, lb = named_leaves(a), named_leaves(b)
    return [k for k, _ in la] == [k for k, _ in lb] and all(
        same_bits(x, y) for (_, x), (_, y) in zip(la, lb))


def bits_checksum(tree) -> list:
    """Each leaf's bits summed as int64 (in chunks of 2^26 entries): an
    exact fingerprint of a state too large to keep twice on the card."""
    import torch

    from repro_torch.train.checkpoint import named_leaves

    out = []
    for _, t in named_leaves(tree):
        flat = t.detach().reshape(-1)
        bits = flat.view({8: torch.int64, 4: torch.int32,
                          2: torch.int16, 1: torch.int8}[flat.element_size()])
        total = torch.zeros((), dtype=torch.int64, device=t.device)
        for i in range(0, bits.numel(), 1 << 26):
            total += bits[i:i + (1 << 26)].sum(dtype=torch.int64)
        out.append(int(total))
    return out


def gnn_case(label: str, arch: str, loss_fn, params, batch, on_cpu: bool):
    """One 18a case: the loss and its gradients, finite; the train step
    (AdamW at GNN_STEP, its lr cut to a first-order decrease of
    GNN_DESCENT of the loss) twice from the same state with PyTorch's
    defaults, bit-equal (loss, grad_norm, parameters, moments), and the
    loss after it below the loss before; with ``on_cpu``, the loss within
    rel 1e-4 of the port's CPU loss on the same parameters and batch."""
    import math

    import torch

    from repro_torch.train.checkpoint import named_leaves, tree_map
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.train_step import build_train_step

    p = tree_clone(params)
    leaves = [t.requires_grad_(True) for _, t in named_leaves(p)]
    loss = loss_fn(p, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    loss0 = float(loss.detach())
    finite = math.isfinite(loss0) and all(
        g is None or bool(torch.isfinite(g).all()) for g in grads)
    l1 = float(sum(g.abs().sum() for g in grads if g is not None))
    lr = min(GNN_STEP["lr"], GNN_DESCENT * loss0 / l1)
    del p, leaves, loss, grads
    opt = AdamWConfig(**dict(GNN_STEP, lr=lr))
    step = build_train_step(loss_fn, opt)
    state = init_state(opt, params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(2):
        p, s = tree_clone(params), tree_clone(state)
        t = time.perf_counter()
        p, s, m = step(p, s, batch)
        torch.cuda.synchronize()
        runs.append((p, s, m, time.perf_counter() - t))
    peak = torch.cuda.max_memory_allocated()
    (p1, s1, m1, t1), (p2, s2, m2, t2) = runs
    same = (same_bits(m1["loss"], m2["loss"])
            and same_bits(m1["grad_norm"], m2["grad_norm"])
            and tree_same_bits(p1, p2) and tree_same_bits(s1, s2))
    gnorm = float(m1["grad_norm"])
    with torch.no_grad():
        loss1 = float(loss_fn(p1, batch))
    out = dict(loss=loss0, grad_norm=gnorm, lr=lr, loss_after=loss1,
               bit_equal=same, step_s=t2, first_step_s=t1, peak_bytes=peak)
    msg = (f"[gnn] 18a {label}: loss {loss0!r} → {loss1!r} after one step "
           f"at lr {lr:.3g}, grad_norm {gnorm:.4g}, two runs bit-equal "
           f"{same}; step {t2 * 1e3:.1f} ms (first {t1 * 1e3:.1f} ms), peak "
           f"{peak / 2**30:.2f} GiB")
    if on_cpu:
        cpu_params = tree_map(lambda t: t.detach().cpu(), params)
        cpu_batch = {k: v.cpu() if torch.is_tensor(v) else v
                     for k, v in batch.items()}
        t = time.perf_counter()
        with torch.no_grad():
            cpu_loss = float(loss_fn(cpu_params, cpu_batch))
        rel = abs(loss0 - cpu_loss) / abs(cpu_loss)
        out.update(cpu_loss=cpu_loss, cpu_rel=rel,
                   cpu_s=time.perf_counter() - t)
        msg += f"; CPU loss {cpu_loss!r}, rel {rel:.2e} (tolerance 1e-4)"
        if not rel <= 1e-4:
            raise AssertionError(f"18a {label}: card loss {loss0} vs CPU "
                                 f"{cpu_loss}: rel {rel}")
    log(msg)
    if not (finite and math.isfinite(gnorm)):
        raise AssertionError(f"18a {label}: loss {loss0}, grad_norm {gnorm}, "
                             f"gradients finite {finite}")
    if not loss1 < loss0:
        raise AssertionError(f"18a {label}: the step did not lower the loss "
                             f"({loss0} → {loss1})")
    if not same:
        raise AssertionError(f"18a {label}: two runs of the step differ")
    return out


def gnn_phase(seed: int):
    """Phase 18a: the four GNNs at full width through
    ``launch.train.build_gnn_training`` on full_graph_sm (card vs CPU loss
    held), then DimeNet and MeshGraphNet at minibatch_lg; no kernel
    launches."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train

    cases = [(arch, "full_graph_sm") for arch in
             ("gcn-cora", "schnet", "dimenet", "meshgraphnet")]
    cases += [(arch, GNN_LARGE_CELL) for arch in GNN_LARGE]
    out = {}
    ops.reset_launches()
    for arch, cell in cases:
        t = time.perf_counter()
        cfg, params, loss_fn, batches = launch_train.build_gnn_training(
            arch, False, seed, "cuda", cell=cell)
        batch = next(batches)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        label = f"{arch} {cell}"
        sizes = {k: tuple(v.shape) for k, v in batch.items()
                 if k in ("edge_src", "node_mask", "tri_kj")}
        log(f"[gnn] 18a {label}: {sizes}, made in {build_s:.2f} s")
        out[label] = gnn_case(label, arch, loss_fn, params, batch,
                              on_cpu=cell == "full_graph_sm")
        out[label].update(build_s=build_s, shapes=sizes)
        del params, batch, batches
        torch.cuda.empty_cache()
    out["launches"] = dict(ops.launches)
    if out["launches"] != NO_LAUNCHES:
        raise AssertionError(f"18a launched {out['launches']}")
    return out


def compact_din(params, hb: dict):
    """The DIN parameters and batch ``hb`` (numpy, on the host) with each
    table cut to the rows the batch reads and its ids renumbered into
    them, on the CPU: the same arithmetic as the full tables without
    copying them to the host."""
    import numpy as np
    import torch

    out_p = {k: {"w": [t.detach().cpu() for t in params[k]["w"]],
                 "b": [t.detach().cpu() for t in params[k]["b"]]}
             for k in ("attn", "mlp")}
    out_b = {"hist_mask": torch.from_numpy(hb["hist_mask"]),
             "profile_mask": torch.from_numpy(hb["profile_mask"])}
    for table, keys in (("item_table", ("hist_items", "target_item")),
                        ("cate_table", ("hist_cates", "target_cate")),
                        ("tag_table", ("profile_tags",))):
        ids = np.concatenate([hb[k].ravel() for k in keys])
        rows, inv = np.unique(ids, return_inverse=True)
        dev = params[table].device
        out_p[table] = params[table][torch.from_numpy(rows).to(dev)].cpu()
        at = 0
        for k in keys:
            n = hb[k].size
            out_b[k] = torch.from_numpy(
                inv[at:at + n].reshape(hb[k].shape).astype(np.int32))
            at += n
    return out_p, out_b


def din_phase(seed: int):
    """Phase 18b: DIN at din()'s full tables on the card.  Training: the
    train_batch cell's B at S = 100; one step (AdamW at DIN_STEP) run twice
    from the same seeded state with PyTorch's defaults, bit-equal (the
    loss, grad_norm and an exact checksum of every parameter and moment:
    the 21.8 GB of tables and moments cannot be held twice beside a step),
    then DIN_STEPS steps in all on that batch lower its loss.  Serving:
    serve_p99's B through ``din_logits``, p50 and p99 over
    DIN_SERVE_CALLS calls, the logits within 1e-4 of max |logit| of the
    CPU's on compact tables.  Retrieval: one user against DIN_CANDIDATES
    candidates in chunks of DIN_CHUNK, DIN_CHECKED sampled scores within
    2e-4 (the reference test's bar) of ``din_logits`` on the tiled batch.
    No kernel launches."""
    import math

    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.data.recsys import din_batch, din_retrieval_batch
    from repro_torch.kernels import ops
    from repro_torch.models import recsys as r
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.train_step import build_train_step

    cfg = registry.get("din").make_config()
    ops.reset_launches()

    def fresh():
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return r.din_init(cfg, gen, "cuda")

    def on_card(hb):
        return {k: torch.from_numpy(v).to("cuda") for k, v in hb.items()}

    t = time.perf_counter()
    params = fresh()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    table_bytes = sum(params[k].nbytes for k in
                      ("item_table", "cate_table", "tag_table"))
    t = time.perf_counter()
    batch = on_card(din_batch(DIN_TRAIN_B, cfg.seq_len, cfg.n_items,
                              cfg.n_cates, cfg.n_tags, cfg.tag_bag_width,
                              seed=seed))
    batch_s = time.perf_counter() - t
    log(f"[din] 18b tables {table_bytes / 1e9:.2f} GB drawn on the card in "
        f"{init_s:.2f} s; batch B={DIN_TRAIN_B} S={cfg.seq_len} made in "
        f"{batch_s:.2f} s")

    opt = AdamWConfig(**DIN_STEP)
    loss_fn = lambda p, b: r.din_loss(p, b, cfg)
    step = build_train_step(loss_fn, opt)
    prints, step_s, peaks = [], [], []
    for run in range(2):
        if run:
            del params, state
            torch.cuda.empty_cache()
            params = fresh()
        state = init_state(opt, params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        params, state, m = step(params, state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        peaks.append(torch.cuda.max_memory_allocated())
        prints.append((m["loss"].clone(), m["grad_norm"].clone(),
                       bits_checksum(params), bits_checksum(state)))
    same = (same_bits(prints[0][0], prints[1][0])
            and same_bits(prints[0][1], prints[1][1])
            and prints[0][2:] == prints[1][2:])
    loss0, gnorm = float(prints[0][0]), float(prints[0][1])
    for _ in range(DIN_STEPS - 1):
        t = time.perf_counter()
        params, state, m = step(params, state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        loss_after = float(loss_fn(params, batch))
    log(f"[din] 18b train: loss {loss0!r} → {loss_after!r} after "
        f"{DIN_STEPS} steps, grad_norm {gnorm:.4g}; one step twice "
        f"bit-equal {same}; steps {[round(x * 1e3, 1) for x in step_s]} ms; "
        f"peak {max(peaks + [peak]) / 2**30:.2f} GiB")
    if not (math.isfinite(loss0) and math.isfinite(gnorm)
            and loss_after < loss0):
        raise AssertionError(f"18b: loss {loss0} → {loss_after}, grad_norm "
                             f"{gnorm}")
    if not same:
        raise AssertionError("18b: two runs of the DIN step differ")
    train = dict(loss=loss0, loss_after=loss_after, grad_norm=gnorm,
                 bit_equal=same, step_s=step_s, peak_bytes=max(peaks + [peak]),
                 table_bytes=table_bytes, init_s=init_s, batch_s=batch_s)
    del state, batch, m
    torch.cuda.empty_cache()

    # serving: serve_p99's B through din_logits
    hb = din_batch(DIN_SERVE_B, cfg.seq_len, cfg.n_items, cfg.n_cates,
                   cfg.n_tags, cfg.tag_bag_width, seed=seed + 1)
    hb.pop("labels")
    sb = on_card(hb)
    times = []
    with torch.no_grad():
        for i in range(DIN_SERVE_CALLS + 3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits = r.din_logits(params, sb, cfg)
            torch.cuda.synchronize()
            if i >= 3:                              # 3 warm-up calls
                times.append(time.perf_counter() - t)
        cpu_params, cpu_batch = compact_din(params, hb)
        want = r.din_logits(cpu_params, cpu_batch, cfg)
    err = float((logits.cpu() - want).abs().max() / want.abs().max())
    p50, p99 = (float(x) for x in np.percentile(np.array(times) * 1e3,
                                                [50, 99]))
    log(f"[din] 18b serve B={DIN_SERVE_B}: p50 {p50:.3f} ms, p99 {p99:.3f} ms "
        f"over {DIN_SERVE_CALLS} calls; logits vs CPU on compact tables "
        f"{err:.2e} of max |logit| (tolerance 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"18b serve: logits vs CPU {err}")
    serve = dict(p50_ms=p50, p99_ms=p99, cpu_err=err)

    # retrieval: one user against DIN_CANDIDATES candidates
    rh = din_retrieval_batch(DIN_CANDIDATES, cfg.seq_len, cfg.n_items,
                             cfg.n_cates, cfg.n_tags, cfg.tag_bag_width,
                             seed=seed + 2)
    rb = on_card(rh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        t = time.perf_counter()
        scores = r.din_retrieval_scores(params, rb, cfg, chunk=DIN_CHUNK)
        torch.cuda.synchronize()
        ret_s = time.perf_counter() - t
        pick = torch.from_numpy(np.sort(np.random.default_rng(seed).choice(
            DIN_CANDIDATES, DIN_CHECKED, replace=False))).to("cuda")
        tile = lambda x: x.expand(DIN_CHECKED, -1)
        pb = {"hist_items": tile(rb["hist_items"]),
              "hist_cates": tile(rb["hist_cates"]),
              "hist_mask": tile(rb["hist_mask"]),
              "target_item": rb["cand_items"][pick],
              "target_cate": rb["cand_cates"][pick],
              "profile_tags": tile(rb["profile_tags"]),
              "profile_mask": tile(rb["profile_mask"])}
        ref = r.din_logits(params, pb, cfg)
    got = scores[pick]
    gap = float(((got - ref).abs() - (2e-4 + 2e-4 * ref.abs())).max())
    ret_peak = torch.cuda.max_memory_allocated()
    log(f"[din] 18b retrieval: {DIN_CANDIDATES} candidates in chunks of "
        f"{DIN_CHUNK} in {ret_s:.3f} s (peak {ret_peak / 2**30:.2f} GiB); "
        f"{DIN_CHECKED} sampled scores vs din_logits: max |gap| "
        f"{float((got - ref).abs().max()):.2e} (tolerance 2e-4 + 2e-4·|ref|)")
    if not (scores.shape == (DIN_CANDIDATES,) and gap <= 0
            and bool(torch.isfinite(scores).all())):
        raise AssertionError(f"18b retrieval: scores {tuple(scores.shape)}, "
                             f"gap over tolerance {gap}")
    retrieval = dict(seconds=ret_s, peak_bytes=ret_peak,
                     max_gap=float((got - ref).abs().max()))
    launches = dict(ops.launches)
    if launches != NO_LAUNCHES:
        raise AssertionError(f"18b launched {launches}")
    del params, rb, scores
    torch.cuda.empty_cache()
    return dict(train=train, serve=serve, retrieval=retrieval,
                launches=launches)


def gnn_din_cli_phase(clis: dict, out_dir: Path):
    """Phase 18c: the two ``launch.train`` CLIs started with phase 11's
    (``cli_runs``): exit 0 (``finish_clis`` held it) and finite losses
    printed at steps 10 and 20; their checkpoints are deleted after."""
    import math
    import shutil

    out = {}
    for name in ("train_gcn", "train_din"):
        lines = [ln for ln in clis[name]["stdout"].splitlines()
                 if ln.startswith("step")]
        losses = [float(ln.split()[3]) for ln in lines]
        log(f"[cli] 18c {name}: {clis[name]['seconds']:.1f} s beside the "
            f"other CLIs; " + " | ".join(lines))
        if len(losses) != 2 or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"18c {name}: {clis[name]['stdout']}")
        out[name] = dict(seconds=clis[name]["seconds"], losses=losses)
        shutil.rmtree(out_dir / f"chip_smoke_{name}_ckpt", ignore_errors=True)
    return out


def gnn_din_phase(seed: int, clis: dict, out_dir: Path):
    """Phase 18: GNN and recsys training (18a-18c)."""
    import torch

    t = time.perf_counter()
    out = {"gnn": gnn_phase(seed)}
    torch.cuda.empty_cache()
    out["din"] = din_phase(seed)
    out["cli"] = gnn_din_cli_phase(clis, out_dir)
    out["seconds"] = time.perf_counter() - t
    log(f"[gnn] phase 18 in {out['seconds']:.1f} s")
    return out


# -- phase 19: the dry runs ------------------------------------------------------

# 19a: DIN on (data 1, model 4) at din()'s full tables, the batch cut from
# train_batch's 65,536 to MESH_DIN_B: every rank runs the whole batch (the
# data axis has one rank), so four ranks at 65,536 would hold four times
# 18b's ~12 GB of activations beside their tables and moments; candidates
# cut from retrieval_cand's 1,000,000 (a quarter a rank), of which
# MESH_DIN_CHECKED are held against din_logits
MESH_DIN_B = 8192
MESH_DIN_CANDIDATES, MESH_DIN_CHECKED = 65536, 512
# 19b: a planned peak against the peak the phase measured
PLAN_PEAK_RTOL = 0.2
# 19c: one cell a family through the dryrun CLI on the single-pod mesh
DRYRUN_CELLS = (("qwen2-1.5b", "train_4k"), ("gcn-cora", "ogb_products"),
                ("din", "train_batch"), ("pirmcut", "road_asia"))
GNN_ARCHS = ("gcn-cora", "schnet", "dimenet", "meshgraphnet")


def _mesh_rank(rank: int, store: str, out_path: str, seed: int,
               gnn_ref: dict) -> None:
    """One rank of 19a (a spawned process, gloo over CUDA tensors, every
    rank on the one card); an ok flag all-reduced after each part fails
    every rank when one fails.  Writes its numbers to ``out_path.<rank>``."""
    import datetime
    import math
    import traceback

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import registry
    from repro_torch.data.recsys import din_batch, din_retrieval_batch
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.cells import din_rules, gnn_rules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import gnn as g
    from repro_torch.models import recsys as r
    from repro_torch.models import transformer as tr
    from repro_torch.models.sharding import whole
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.train_step import build_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, SHARD_RANKS),
                            rank=rank, world_size=SHARD_RANKS,
                            timeout=datetime.timedelta(
                                seconds=LM_SHARD_TIMEOUT_S))
    torch.cuda.set_device(0)
    res = {"rank": rank}

    def part(name, fn):
        t = time.perf_counter()
        err = None
        try:
            res[name] = fn()
            torch.cuda.synchronize()
        except Exception:                           # noqa: BLE001
            err = traceback.format_exc()
        flag = torch.tensor([0.0 if err else 1.0])
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        if err:
            raise RuntimeError(f"rank {rank}, {name}:\n{err}")
        if float(flag) < 1.0:
            raise RuntimeError(f"rank {rank}, {name}: another rank failed")
        res[f"{name}_s"] = time.perf_counter() - t

    def gnn():
        rules = gnn_rules(make_host_mesh((2, 2), ("data", "model"),
                                         device="cuda"))
        out = {}
        for arch in GNN_ARCHS:
            cfg, params, _, batches = launch_train.build_gnn_training(
                arch, False, seed, "cuda")
            batch = g.pad_batch(next(batches), SHARD_RANKS)
            ng = registry.get(arch).shapes["full_graph_sm"].get("n_graphs", 1)

            def loss_fn(p, b, arch=arch, cfg=cfg, ng=ng):
                bb = dict(b, n_graphs=ng) \
                    if arch in ("schnet", "dimenet") else b
                return g.LOSSES[arch](p, bb, cfg, rules)

            want = gnn_ref[f"{arch} full_graph_sm"]
            # SchNet's and DimeNet's loss is (E - y)² of a graph energy E
            # summed over 2,708 atoms: E is held at rel 1e-5 (the shards sum
            # it in another order: 6.5e-6 for SchNet on the CPU), and
            # E - y then moves by up to 1e-5·|E|/|E - y| of itself, so the
            # loss is held at twice that and grad_norm (|E - y| times the
            # gradient of E, itself within 1e-5) at 1e-5·(1 + |E|/|E - y|)
            tol, tol_norm, e_rel = 1e-5, 1e-5, None
            if arch in ("schnet", "dimenet"):
                fwd = {"schnet": g.schnet_forward,
                       "dimenet": g.dimenet_forward}[arch]
                with torch.no_grad():
                    bb = dict(batch, n_graphs=ng)
                    e_u = fwd(params, bb, cfg)
                    e_s = fwd(params, bb, cfg, rules)
                scale = float(e_u.abs().max())
                e_rel = float((e_s - e_u).abs().max()) / scale
                ratio = scale / math.sqrt(want["loss"])
                tol, tol_norm = 2e-5 * max(1.0, ratio), 1e-5 * (1.0 + ratio)
            opt = AdamWConfig(**dict(GNN_STEP, lr=want["lr"]))
            step = build_train_step(loss_fn, opt)
            state = init_state(opt, params)
            runs = []
            for _ in range(2):
                p, s_ = tree_clone(params), tree_clone(state)
                torch.cuda.synchronize()
                t = time.perf_counter()
                p, s_, m = step(p, s_, batch)
                torch.cuda.synchronize()
                runs.append((p, s_, m, time.perf_counter() - t))
            (p1, s1, m1, t1), (p2, s2, m2, t2) = runs
            same = (same_bits(m1["loss"], m2["loss"])
                    and same_bits(m1["grad_norm"], m2["grad_norm"])
                    and tree_same_bits(p1, p2) and tree_same_bits(s1, s2))
            loss, gnorm = float(m1["loss"]), float(m1["grad_norm"])
            out[arch] = dict(
                loss=loss, grad_norm=gnorm, bit_equal=same, step_s=t2,
                tol=tol, tol_norm=tol_norm, energy_rel=e_rel,
                loss_rel=abs(loss - want["loss"]) / abs(want["loss"]),
                norm_rel=abs(gnorm - want["grad_norm"]) / want["grad_norm"],
                shapes={k: list(v.shape) for k, v in batch.items()
                        if k in ("node_mask", "edge_src", "tri_kj")})
            del params, batch, batches, runs, p1, s1, p2, s2, state
            torch.cuda.empty_cache()
        return out

    def din():
        cfg = registry.get("din").make_config()
        rules = din_rules(make_host_mesh((1, 4), ("data", "model"),
                                         device="cuda"))
        gen = torch.Generator(device="cuda").manual_seed(seed)
        full = r.din_init(cfg, gen, "cuda")     # the same draws on each rank
        on_card = lambda hb: {k: torch.from_numpy(v).to("cuda")
                              for k, v in hb.items()}
        batch = on_card(din_batch(MESH_DIN_B, cfg.seq_len, cfg.n_items,
                                  cfg.n_cates, cfg.n_tags, cfg.tag_bag_width,
                                  seed=seed))
        rb = on_card(din_retrieval_batch(MESH_DIN_CANDIDATES, cfg.seq_len,
                                         cfg.n_items, cfg.n_cates, cfg.n_tags,
                                         cfg.tag_bag_width, seed=seed + 2))
        pick = torch.from_numpy(np.sort(np.random.default_rng(seed).choice(
            MESH_DIN_CANDIDATES, MESH_DIN_CHECKED, replace=False))).to("cuda")
        tile = lambda x: x.expand(MESH_DIN_CHECKED, -1)
        pb = {"hist_items": tile(rb["hist_items"]),
              "hist_cates": tile(rb["hist_cates"]),
              "hist_mask": tile(rb["hist_mask"]),
              "target_item": rb["cand_items"][pick],
              "target_cate": rb["cand_cates"][pick],
              "profile_tags": tile(rb["profile_tags"]),
              "profile_mask": tile(rb["profile_mask"])}
        with torch.no_grad():
            want_loss = float(r.din_loss(full, batch, cfg))
            pointwise = r.din_logits(full, pb, cfg)
        shardings = {k: (rules.named_sharding("rows", None, shape=v.shape)
                         if k.endswith("_table") else {n: None for n in v})
                     for k, v in full.items()}
        sp = tr.shard_params(full, shardings)
        del full
        torch.cuda.empty_cache()
        block = {k: list(sp[k].to_local().shape)
                 for k in ("item_table", "cate_table", "tag_table")}
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.no_grad():
            scores = whole(r.din_retrieval_scores(sp, rb, cfg, rules,
                                                  chunk=DIN_CHUNK))
        torch.cuda.synchronize()
        ret_s = time.perf_counter() - t
        got = scores[pick]
        gap = float(((got - pointwise).abs()
                     - (2e-4 + 2e-4 * pointwise.abs())).max())
        opt = AdamWConfig(**DIN_STEP)
        state = init_state(opt, sp)
        step = build_train_step(lambda p, b: r.din_loss(p, b, cfg, rules),
                                opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        _, _, m = step(sp, state, batch)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        return dict(block=block, loss=loss, want_loss=want_loss,
                    loss_rel=abs(loss - want_loss) / abs(want_loss),
                    grad_norm=gnorm, step_s=step_s, retrieval_s=ret_s,
                    scores_finite=bool(torch.isfinite(scores).all()),
                    n_scores=int(scores.numel()), max_gap=float(
                        (got - pointwise).abs().max()), over_bar=gap,
                    peak_bytes=torch.cuda.max_memory_allocated())

    part("gnn", gnn)
    part("din", din)
    Path(f"{out_path}.{rank}").write_text(json.dumps(res))
    dist.destroy_process_group()


def mesh_models_phase(seed: int, gnn_ref: dict, out_dir: Path):
    """Phase 19a: the four GNNs and DIN on a mesh in four spawned gloo
    ranks on the one card."""
    import math

    out_path = out_dir / "chip_smoke_mesh_models.json"
    wall = run_ranks(_mesh_rank, out_path, (seed, gnn_ref), timeout_s=600)
    ranks = [json.loads(Path(f"{out_path}.{r}").read_text())
             for r in range(SHARD_RANKS)]
    fails = []
    for r in ranks:
        for arch, x in r["gnn"].items():
            if not (x["bit_equal"] and x["loss_rel"] <= x["tol"]
                    and x["norm_rel"] <= x["tol_norm"]
                    and (x["energy_rel"] is None
                         or x["energy_rel"] <= 1e-5)):
                fails.append(f"rank {r['rank']} {arch} {x}")
        d = r["din"]
        if not (d["loss_rel"] <= 1e-5 and math.isfinite(d["grad_norm"])
                and d["scores_finite"] and d["over_bar"] <= 0
                and d["n_scores"] == MESH_DIN_CANDIDATES):
            fails.append(f"rank {r['rank']} din {d}")
    head = ranks[0]
    for arch, x in head["gnn"].items():
        energy = ("" if x["energy_rel"] is None else
                  f"; graph energy rel {x['energy_rel']:.2e} (tolerance "
                  f"1e-5)")
        log(f"[mesh] 19a {arch} full_graph_sm on (data 2, model 2), "
            f"{x['shapes']}: loss {x['loss']!r} (rel {x['loss_rel']:.2e} of "
            f"18a's, tolerance {x['tol']:.2e}), grad_norm "
            f"{x['grad_norm']!r} (rel {x['norm_rel']:.2e}, tolerance "
            f"{x['tol_norm']:.2e}), two runs "
            f"bit-equal {x['bit_equal']}; step {x['step_s'] * 1e3:.1f} ms"
            + energy)
    d = head["din"]
    log(f"[mesh] 19a din on (data 1, model 4), table blocks {d['block']}, "
        f"B {MESH_DIN_B}: loss {d['loss']!r} vs unsharded "
        f"{d['want_loss']!r} (rel {d['loss_rel']:.2e}, tolerance 1e-5), "
        f"grad_norm {d['grad_norm']:.4g}, step {d['step_s']:.3f} s, peak "
        f"{d['peak_bytes'] / 2**30:.2f} GiB a rank; {MESH_DIN_CANDIDATES} "
        f"candidates over 4 ranks in {d['retrieval_s']:.3f} s, "
        f"{MESH_DIN_CHECKED} sampled scores vs din_logits max |gap| "
        f"{d['max_gap']:.2e} (tolerance 2e-4 + 2e-4·|ref|); ranks "
        f"{wall:.1f} s")
    if fails:
        raise AssertionError("19a: " + "; ".join(fails))
    return dict(gnn=head["gnn"], din=d, ranks_wall_s=wall,
                rank_seconds={k: [r[f"{k}_s"] for r in ranks]
                              for k in ("gnn", "din")})


def plan_worker(path: str, names=("16b", "18b", "17b")) -> None:
    """19b's planning runs ``names`` (``plan_runs``: host time only, no
    card time): 16b's step and 18b's DIN step at a world of one, 17b's
    sharded step on a fake (2, 2) world, all on fake CUDA tensors; writes
    their peaks, memory and census to ``path``."""
    import torch

    from repro_torch.configs import lm as lm_configs
    from repro_torch.kernels import ops
    from repro_torch.launch import cells
    from repro_torch.launch.mesh import make_plan_mesh, release_plan_world

    out = {}
    cases = {
        "16b": lambda mesh: cells.build_lm_cell(
            "qwen2-1.5b", "train_4k", mesh,
            dataclasses.replace(lm_configs.qwen2_1_5b(),
                                n_layers=TRAIN_LAYERS),
            dict(kind="train", global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)),
        "18b": lambda mesh: cells.build_din_cell("din", "train_batch", mesh),
        "17b": lambda mesh: cells.build_lm_cell(
            "qwen2-1.5b", "train_4k", mesh, lm_shard_cfg(),
            dict(kind="train", global_batch=LM_SHARD_BATCH,
                 seq_len=LM_SHARD_SEQ))}
    shapes = {"16b": (1, 1), "18b": (1, 1), "17b": (2, 2)}
    for name in names:
        shape = shapes[name]
        try:
            mesh = make_plan_mesh(shape, ("data", "model"), device="cuda")
            t = time.perf_counter()
            plan = cases[name](mesh).lower()
            out[name] = dict(memory=plan.memory, census=plan.census["models"],
                             ops=plan.ops, plan_s=time.perf_counter() - t,
                             device=mesh.device_type)
        finally:
            release_plan_world()
    out["launches"] = dict(ops.launches)
    out["torch"] = torch.__version__
    Path(path).write_text(json.dumps(out))


def planner_phase(report: dict, out_dir: Path):
    """Phase 19b: ``plan_worker``'s planned peaks against 16b's and 18b's
    measured ones, and its census of 17b's step against rank 0's."""
    import torch

    props = torch.cuda.get_device_properties(0)
    out = {"card": dict(name=props.name, total_memory=props.total_memory)}
    log(f"[plan] 19b card {props.name}: total_memory {props.total_memory} "
        f"bytes ({props.total_memory / 2**30:.2f} GiB)")
    plans, launches = {}, dict(NO_LAUNCHES)
    for path in sorted(out_dir.glob("chip_smoke_plans_*.json")):
        got = json.loads(path.read_text())
        for k, v in got.pop("launches").items():
            launches[k] += v
        got.pop("torch")
        plans.update(got)
    plans["launches"] = launches
    fails = []
    measured = {"16b": report["train"]["steps"]["peak_bytes"],
                "18b": report["gnn_din"]["din"]["train"]["peak_bytes"]}
    for name, want in measured.items():
        x = plans[name]
        peak = x["memory"]["peak_estimate_bytes"]
        rel = (peak - want) / want
        out[name] = dict(planned=peak, measured=want, rel=rel,
                         memory=x["memory"], ops=x["ops"], plan_s=x["plan_s"],
                         device=x["device"])
        log(f"[plan] 19b {name} at a world of one on fake {x['device']} "
            f"tensors: planned peak {peak / 2**30:.3f} GiB vs measured "
            f"{want / 2**30:.3f} GiB ({rel:+.3f}, tolerance "
            f"±{PLAN_PEAK_RTOL}); {x['ops']} ops planned in "
            f"{x['plan_s']:.1f} s")
        if not abs(rel) <= PLAN_PEAK_RTOL:
            fails.append(f"{name} planned peak {peak} vs {want}")
    got, want = plans["17b"]["census"], \
        report["lm_shard"]["train"]["census_step"]
    out["17b"] = dict(census=got, equal=got == want,
                      peak=plans["17b"]["memory"]["peak_estimate_bytes"],
                      measured_peak=report["lm_shard"]["train"]["peak_bytes"],
                      plan_s=plans["17b"]["plan_s"])
    log(f"[plan] 19b 17b's step planned on a fake (2, 2) world: census equal "
        f"to rank 0's {got == want} ({got}); planned peak "
        f"{out['17b']['peak'] / 2**30:.3f} GiB a rank vs measured "
        f"{out['17b']['measured_peak'] / 2**30:.3f} GiB (four ranks on one "
        f"card: logged only)")
    if got != want:
        fails.append(f"17b census planned {got} vs recorded {want}")
    if plans["launches"] != NO_LAUNCHES:
        fails.append(f"planning launched {plans['launches']}")
    if fails:
        raise AssertionError("19b: " + "; ".join(fails))
    return out


def dryrun_cli_phase(clis: dict, out_dir: Path, card_bytes: int):
    """Phase 19c: the dryrun CLI's records of DRYRUN_CELLS (the CLIs ran
    with phase 11's)."""
    out = {}
    for arch, cell in DRYRUN_CELLS:
        rec = json.loads((out_dir / "dryrun_torch"
                          / f"{arch}__{cell}__single.json").read_text())
        peak = rec["memory"]["peak_estimate_bytes"]
        need = rec["memory"]["peak_with_margin_bytes"]
        out[f"{arch} {cell}"] = dict(
            ok=rec["ok"], peak_bytes=peak, peak_with_margin_bytes=need,
            fits=rec["fits_h100"],
            t_plan_s=rec["t_plan_s"], plan_device=rec["plan_device"],
            roofline=rec["roofline"],
            kernel_launches=rec["hlo_costs"]["kernel_launches"],
            seconds=clis[f"dryrun_{arch}"]["seconds"])
        log(f"[dryrun] 19c {arch} {cell} single: ok {rec['ok']}, planned on "
            f"{rec['plan_device']} in {rec['t_plan_s']:.1f} s, peak "
            f"{peak / 2**30:.2f} GiB a rank ({need / 2**30:.2f} GiB with the "
            f"margin) against the card's {card_bytes / 2**30:.2f} GiB (fits "
            f"{rec['fits_h100']}), "
            f"dominant {rec['roofline']['dominant']}, useful ratio "
            f"{rec['roofline'].get('useful_ratio')}, kernels "
            f"{rec['hlo_costs']['kernel_launches']}")
    if not all(x["ok"] for x in out.values()):
        raise AssertionError(f"19c: {out}")
    return out


def dryrun_phase(seed: int, report: dict, plans: dict, out_dir: Path):
    """Phase 19: the dry runs (19a-19c); ``plans``: ``plan_runs``' processes
    as ``start_clis`` started them."""
    t = time.perf_counter()
    clis = finish_clis(plans)
    gnn_ref = {k: v for k, v in report["gnn_din"]["gnn"].items()
               if k.endswith("full_graph_sm")}
    out = {"mesh_models": mesh_models_phase(seed, gnn_ref, out_dir)}
    out["planner"] = planner_phase(report, out_dir)
    out["cli"] = dryrun_cli_phase(clis, out_dir,
                                  out["planner"]["card"]["total_memory"])
    out["seconds"] = time.perf_counter() - t
    log(f"[dryrun] phase 19 in {out['seconds']:.1f} s")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--side", type=int, default=96)
    ap.add_argument("--n-irls", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frame", type=int, default=1024,
                    help="side of the serving phase's 2-D frame tenant")
    ap.add_argument("--ell-side", type=int, default=48,
                    help="side of the batched ELL phase's grid")
    ap.add_argument("--tree-side", type=int, default=CUTTREE_SIDE,
                    help="side of the cut-tree phase's grid")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False); this script runs on the card only", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core import (IRLSConfig, MinCutSession, Problem,
                                  max_flow, pirmcut)
    from repro_torch.kernels import build, ops

    t_start = time.perf_counter()
    out_dir = OUT_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    report = {"device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "phase_end_s": {}}

    def lap(phase: int):
        """Keeps and logs the run's seconds at the end of ``phase``."""
        at = report["phase_end_s"][str(phase)] = time.perf_counter() - t_start
        log(f"[time] phase {phase} ends at {at:.1f} s")

    # -- 1. build ------------------------------------------------------------
    t = time.perf_counter()
    built = build.build_all()
    report["build_s"] = time.perf_counter() - t
    (out_dir / "chip_smoke_build.log").write_text(
        "\n".join(f"== {name} ({r['seconds']:.1f} s)\n{r['log']}"
                  for name, r in built.items()))
    report["redesigned"] = build_facts()
    card = card_line()
    report["card"] = card
    log(f"[build] {len(built)} kernels built in {report['build_s']:.1f} s "
        f"(torch {torch.__version__}, CUDA {torch.version.cuda})")
    log(card)

    # -- 2. full-width instance ---------------------------------------------
    t = time.perf_counter()
    inst = segmentation_grid(args.side, args.seed)
    labels, n_blocks = box_labels(args.side)
    report["generate_s"] = time.perf_counter() - t
    log(f"[instance] side {args.side}: n={inst.n} m={inst.graph.m} "
        f"P={n_blocks} in {report['generate_s']:.1f} s")
    cfg = IRLSConfig(layout="ell", fuse_edge_sweep=True, use_pallas=True,
                     precond="block_jacobi", explicit_block_inverse=True,
                     n_blocks=n_blocks, n_irls=args.n_irls)

    # -- 3. kernels alone -----------------------------------------------------
    # the host setup pirmcut repeats in phase 4, timed part by part here
    t = time.perf_counter()
    prob = Problem.build(inst, n_blocks=n_blocks, labels=labels)
    setup = {"Problem.build": time.perf_counter() - t}
    for part, fn in (("component_labels", prob.component_labels),
                     ("device_graph", lambda: prob.device_graph(device="cuda")),
                     ("ell_plan", lambda: prob.ell_plan("cuda")),
                     ("block_plan", lambda: prob.block_plan("cuda"))):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        setup[part] = time.perf_counter() - t
    report["setup_parts_s"] = setup
    log("[setup] " + ", ".join(f"{k} {v:.2f} s" for k, v in setup.items()))
    kern = kernels_alone(prob, inst, cfg, args.seed)

    # -- 4. the main path ---------------------------------------------------
    # pirmcut's two steps, so that the session's own timings are at hand
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t = time.perf_counter()
    res = MinCutSession(Problem.build(inst, n_blocks=n_blocks, labels=labels),
                        cfg, device="cuda").solve(rounding="sweep")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    cut, diag, tm = res.cut, res.diagnostics, res.timings
    steps = sum(1 + it for it in diag.pcg_iters)   # r0 matvec + one per step
    want = dict(NO_LAUNCHES, fused_ell_sweep=args.n_irls, ell_spmv=steps,
                block_diag_matvec=steps)
    log(f"[main] solve {wall_s:.2f} s: Problem.build and connectivity check "
        f"{wall_s - tm['total']:.2f} s, setup {tm['setup']:.2f} s, IRLS "
        f"{tm['irls']:.2f} s, rounding {tm['rounding']:.2f} s")
    log(f"[main] PCG iterations per IRLS iteration: {diag.pcg_iters}")
    log(f"[main] launches {launches} (expected {want})")
    log(f"[main] peak device memory {peak / 2**30:.2f} GiB; cut "
        f"{cut.cut_value!r}")
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")
    if not np.isfinite(res.voltages).all():
        raise AssertionError("non-finite voltages")
    report["main"] = dict(wall_s=wall_s, timings=tm,
                          pcg_iters=diag.pcg_iters, launches=launches,
                          peak_bytes=peak, cut=cut.cut_value,
                          l1_objective=diag.l1_objective)

    # -- 5. the plain path on the card ---------------------------------------
    # The kernels sum in other orders than torch, so the PCG iterates drift
    # apart at float32 roundoff amplified by ε = 1e-6, and the sweep picks
    # its threshold from near-tied voltages.  Three full-width runs read cut
    # gaps of 7.8e-6, 2.4e-7 and 1.6e-7 (PERF.md); the limit leaves ~13×
    # room over the largest.  A faulty kernel shows in how PCG converges,
    # so each IRLS iteration's PCG count must also agree within two steps:
    # the runs read gaps of 0 and 1 where PCG stops at its 1e-3 residual,
    # and the atomic index adds on the card (initial degrees, block
    # assembly) make no two runs bit-equal.
    plain = MinCutSession(prob, dataclasses.replace(cfg, use_pallas=False),
                          device="cuda").solve(rounding="sweep")
    if ops.launches != launches:
        raise AssertionError("the plain path launched a kernel")
    rel = abs(plain.cut_value - cut.cut_value) / abs(plain.cut_value)
    plain_iters = plain.diagnostics.pcg_iters
    iter_gap = max(abs(a - b) for a, b in zip(diag.pcg_iters, plain_iters))
    log(f"[plain] cut {plain.cut_value!r}, rel diff {rel:.3e} (tolerance "
        f"1e-4); PCG iterations {plain_iters}, largest gap {iter_gap} "
        f"(tolerance 2); IRLS {plain.timings['irls']:.2f} s")
    if not rel <= 1e-4:
        raise AssertionError(f"kernel cut {cut.cut_value} vs plain "
                             f"{plain.cut_value}: rel {rel}")
    if len(plain_iters) != len(diag.pcg_iters) or iter_gap > 2:
        raise AssertionError(f"PCG iterations: kernel path {diag.pcg_iters} "
                             f"vs plain path {plain_iters}")
    report["plain"] = dict(cut=plain.cut_value, rel_diff=rel,
                           pcg_iters=plain_iters, iter_gap=iter_gap,
                           irls_s=plain.timings["irls"])
    del prob, plain
    torch.cuda.empty_cache()
    lap(5)

    # -- 6. two-level rounding at reduced sides -------------------------------
    small = {}
    for side in (32, 16):
        inst_s = segmentation_grid(side, args.seed)
        labels_s, p_s = box_labels(side)
        cfg_s = dataclasses.replace(cfg, n_blocks=p_s)
        t = time.perf_counter()
        cut_k, v_k, _ = pirmcut(inst_s, cfg_s, labels=labels_s, device="cuda")
        t_k = time.perf_counter() - t
        if side == 32:
            cut_p, _, _ = pirmcut(inst_s, dataclasses.replace(
                cfg_s, use_pallas=False), labels=labels_s, device="cuda")
            want_cut, what = cut_p.cut_value, "plain path"
        else:
            want_cut, what = max_flow(inst_s).value, "exact Dinic"
        rel = abs(cut_k.cut_value - want_cut) / abs(want_cut)
        log(f"[two_level] side {side}: cut {cut_k.cut_value!r} vs {what} "
            f"{want_cut!r} (rel {rel:.2e}, tolerance 1e-6); contour "
            f"{cut_k.meta['coarse_n']} nodes; {t_k:.1f} s")
        if not (np.isfinite(v_k).all() and rel <= 1e-6):
            raise AssertionError(f"two-level cut at side {side}: rel {rel}")
        small[side] = dict(cut=cut_k.cut_value, reference=want_cut,
                           reference_kind=what, rel=rel,
                           contour=cut_k.meta["coarse_n"], seconds=t_k)
    report["two_level"] = small
    lap(6)

    # -- 7. edge_reweight alone at the COO shapes of both serving tenants ---
    t = time.perf_counter()
    frame = frame_instance(args.frame, args.seed + 2)
    t_frame = time.perf_counter() - t
    prob_coo = Problem.build(inst, n_blocks=1)
    er = edge_reweight_alone(prob_coo, cfg.eps, args.seed)
    report["edge_reweight"] = {f"B={b}": r for b, r in er.items()}
    kern["edge_reweight"] = er[8]          # the serving batch's shape
    del prob_coo
    er_frame = edge_reweight_alone(Problem.build(frame, n_blocks=1), cfg.eps,
                                   args.seed, lane_counts=(8,),
                                   label="frame ")
    report["edge_reweight"]["frame B=8"] = er_frame[8]
    torch.cuda.empty_cache()

    # -- 8. the serving path -------------------------------------------------
    log(f"[serve] tenants: volume n={inst.n} m={inst.graph.m}, frame "
        f"{args.frame}² n={frame.n} m={frame.graph.m} (made in "
        f"{t_frame:.1f} s)")
    serve = serving_phase({"volume": inst, "frame": frame}, SERVE_ROUNDS,
                          args.seed)
    torch.cuda.empty_cache()
    report["serve"] = serve
    lap(8)

    # -- 9. the batched ELL path ---------------------------------------------
    report["batched_ell"] = batched_ell_phase(args.ell_side, 4, args.seed)
    torch.cuda.empty_cache()
    lap(9)

    # -- 10. LM serving ----------------------------------------------------------
    from repro_torch.configs import lm as lm_configs

    lm_cfg = dataclasses.replace(lm_configs.qwen2_1_5b(),
                                 use_pallas_attention=True)
    kern["flash_fwd"] = flash_fwd_alone(lm_cfg, LM_BATCH, LM_SEQ, args.seed)
    report["lm"] = lm_phase(lm_cfg, LM_BATCH, LM_SEQ, LM_GEN, args.seed)
    torch.cuda.empty_cache()
    lap(10)

    # -- 11. delta staging, presolve and the CLIs ------------------------------
    report["delta_host"] = delta_host_phase(inst, labels, n_blocks, cfg,
                                            args.seed)
    torch.cuda.empty_cache()
    report["delta_serve"] = delta_serve_phase({"volume": inst, "frame": frame},
                                              args.seed)
    del frame
    torch.cuda.empty_cache()
    report["presolve"] = presolve_phase(args.seed)
    torch.cuda.empty_cache()
    clis = finish_clis(start_clis(cli_runs(out_dir), out_dir))
    report["cli"] = cli_phase(clis, out_dir)
    for stale in out_dir.glob("chip_smoke_plans_*.json"):
        stale.unlink()
    plans = start_clis(plan_runs(out_dir), out_dir)      # joined in phase 19
    lap(11)

    # -- 12. cut trees --------------------------------------------------------
    t = time.perf_counter()
    report["cuttree"] = cuttree_build_phase(args.tree_side, args.seed, out_dir)
    torch.cuda.empty_cache()
    report["cuttree_route"] = cuttree_route_phase(ROUTE_SIDE, args.seed)
    report["cuttree_exact"], ctx = cuttree_exact_phase(EXACT_SIDE,
                                                       args.seed)
    report["cuttree_service"] = cuttree_service_phase(
        ctx, args.seed, report["cuttree"]["sink"], out_dir,
        clis["cut_tree"])
    report["cuttree_s"] = time.perf_counter() - t
    log(f"[cuttree] phase 12 in {report['cuttree_s']:.1f} s")
    torch.cuda.empty_cache()
    lap(12)

    # -- 13. the sharded solver ------------------------------------------------
    report["sharded"] = sharded_phase(inst, labels, cfg, cut.cut_value,
                                      args.seed, out_dir,
                                      clis["solve_sharded"])
    lap(13)
    # -- 14. MoE serving ------------------------------------------------------
    report["moe"] = moe_phase(args.seed)
    torch.cuda.empty_cache()
    lap(14)

    # -- 15. the sharded server and the perf gate --------------------------------
    import warnings

    from repro_torch.distributed.solver import Float32DivergenceWarning

    t = time.perf_counter()
    fused_cut = report["sharded"]["world_one"]["halo_fused"]["measured"]["cut"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", Float32DivergenceWarning)
        report["sharded_serve"] = sharded_server_phase(inst, labels, cfg,
                                                       fused_cut, args.seed)
        torch.cuda.empty_cache()
        report["sharded_serve4"] = sharded_ranks_server_phase(args.seed,
                                                              out_dir)
    report["perf"] = perf_gate_phase(inst, labels, n_blocks, cfg, kern,
                                     report["sharded_serve"], out_dir)
    report["phase15_s"] = time.perf_counter() - t
    log(f"[phase 15] {report['phase15_s']:.1f} s")
    lap(15)

    # -- 16. LM training ----------------------------------------------------------
    report["train"] = train_phase(args.seed, out_dir)
    torch.cuda.empty_cache()
    lap(16)

    # -- 17. LM sharding ------------------------------------------------------------
    report["lm_shard"] = lm_shard_phase(args.seed, out_dir)
    lap(17)

    # -- 18. GNN and recsys training ---------------------------------------------------
    report["gnn_din"] = gnn_din_phase(args.seed, clis, out_dir)
    torch.cuda.empty_cache()
    lap(18)

    # -- 19. the dry runs --------------------------------------------------------------
    report["dryrun"] = dryrun_phase(args.seed, report, plans, out_dir)
    torch.cuda.empty_cache()
    lap(19)

    for route in SHARD_ROUTES:
        report["sharded_" + route] = {
            "launches": report["sharded"]["world_one"][route]["measured"][
                "launches"]}
    for path, name in (("delta_host", "ell_spmv"),
                       ("delta_host", "fused_ell_sweep"),
                       ("delta_host", "block_diag_matvec"),
                       ("delta_serve", "ell_spmv"),
                       ("delta_serve", "fused_ell_sweep"),
                       ("presolve", "ell_spmv"),
                       ("presolve", "fused_ell_sweep"),
                       ("cuttree", "edge_reweight"),
                       ("sharded_halo_fused", "fused_ell_sweep"),
                       ("sharded_halo_unfused", "edge_reweight"),
                       ("sharded_psum", "edge_reweight"),
                       ("moe", "flash_fwd"), ("lm_shard", "flash_fwd"),
                       ("sharded_serve", "fused_ell_sweep"),
                       ("sharded_serve4", "edge_reweight"),
                       ("perf", "ell_spmv"), ("perf", "fused_ell_sweep"),
                       ("perf", "block_diag_matvec")):
        if report[path]["launches"][name] == 0:
            raise AssertionError(f"{name} was not launched on the {path} path")

    path_launches = {"main": launches, "serve": serve["launches"],
                     "batched_ell": report["batched_ell"]["launches"],
                     "lm": report["lm"]["launches"],
                     "lm_moe": report["moe"]["launches"],
                     "delta_host": report["delta_host"]["launches"],
                     "delta_serve": report["delta_serve"]["launches"],
                     "presolve": report["presolve"]["launches"],
                     "cuttree": report["cuttree"]["launches"],
                     **{"sharded_" + r: report["sharded_" + r]["launches"]
                        for r in SHARD_ROUTES},
                     "sharded_serve": report["sharded_serve"]["launches"],
                     "sharded_serve4": report["sharded_serve4"]["launches"],
                     "perf": report["perf"]["launches"],
                     "train": report["train"]["launches"],
                     "lm_shard": report["lm_shard"]["launches"]}
    for name in KERNELS:
        if path_launches[LAUNCH_PATH[name]][name] == 0:
            raise AssertionError(f"{name} was not launched on its path")
    log(f"[launches] per path: {path_launches}")
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1],
         "launches": path_launches[LAUNCH_PATH[name]][name],
         "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"],
         "bound_ms": kern[name]["bound_ms"],
         "bound_by": kern[name]["bound_by"],
         "library_ms": kern[name]["library_ms"]}
        for name in KERNELS]}
    report["kernels"] = kern
    report["launches_by_path"] = path_launches
    report["seconds"] = time.perf_counter() - t_start
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(f"[done] {report['seconds']:.1f} s")
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
