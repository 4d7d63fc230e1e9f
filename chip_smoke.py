#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and
``nvcc``.  It imports nothing of JAX or of the reference package ``repro``.
Phases, each printing one JSON line:

1. device — the card's name and ``nvidia-smi`` name and power limit;
2. build  — compiles ``src/repro_torch/kernels/csrc`` with nvcc (sm_90a),
   prints each kernel's registers and spill bytes, and counts the
   tensor-core instructions in the bf16 kernels' SASS (``cuobjdump``):
   B4's forward and its dK/dV and dQ backward kernels at every head-dim
   pair, and B5's forward; it fails if one is missing or has none, or if
   cuobjdump is missing;
3. kernels — B1 ``wd_relax_lanes``, B2 ``relax_lanes`` and B3
   ``find_offsets`` at the main path's shapes (rmat20: N = 2^20, frontiers
   of 2^10..2^20 slots, up to 2^23 lanes), each held for exact equality
   against its plain PyTorch version on the card for all four built-in
   operators, B1 and B2 in both contracts (the proposal, and the fold into
   a copy of dist and a running mask: ``wd_apply_relax``,
   ``apply_relax``), with the cases that take the kernels' other paths:
   B2 lane counts that are not multiples of its tile, HP-shaped tiles of
   mostly invalid lanes, and a B1 frontier whose zero-degree runs outgrow
   a tile's shared memory; B3 also against ``torch.searchsorted``, on
   that frontier's prefix (slices too wide to stage) and with no slot at
   all.  Each is timed with CUDA events beside the plain version (B3 also
   beside ``torch.searchsorted``);
4. path  — the paper's rmat20 (``rmat_graph(scale=20, edge_factor=8,
   weighted=True, seed=1)``) from its highest-degree source: ``sssp`` with
   WD, BS, HP, AD, EP (chunked pushes) and NS and ``bfs`` with WD on the
   card (``PATH_RUNS``), each equal to an exact Dijkstra oracle (scipy);
   WD equal to the same run on the CPU; WD, BS, HP and AD at rmat16 equal
   to their CPU runs.  The launch counts are set to 0 just before the
   seven rmat20 runs and read just after them, before anything else
   launches: the kernel line's B1 and B2 launches are those of all seven,
   and show B1 and B2 carried the path (B3 is not on it and reads 0).
   Each run also prints its mean lanes a launch of B1 and B2
   (``_build.LANES``).  Then the WD (B1) and BS, HP, AD, EP and NS (B2)
   runs are run again (``PATH_LANES``), some of their kernel calls are
   kept with the lanes and dist the path gave them (``path_calls``), and
   B1 and B2 are timed on those, in both contracts, L2-cold and warm; a
   traced ``apply_relax`` and ``wd_apply_relax`` must each be two device
   activities (the copy of dist and the launch).  The find_offsets entry point
   (``ops.wd_find_offsets``) is checked afterwards in its own phase, on
   rmat20's whole-graph degree prefix; its launch is in no row.
   strategies_cpu: at rmat16, ``sssp`` EP with chunked and unchunked
   pushes and NS, ``bfs`` EP and NS, each on the card equal to the CPU
   (dist, iterations, edges_relaxed, every iteration's accounting) and to
   the oracle.  memory_wall: EP's, WD's and NS's ``state_bytes`` at
   rmat20, NS's split (MDT, children), and EP with a budget of the CSR's
   bytes raising ``MemoryError`` with nothing allocated.  algos:
   ``connected_components`` on the symmetrized rmat20 with WD, HP and NS
   and at rmat16 with BS and AD (card and CPU), each equal to scipy's
   components labelled by their minimum id; ``widest_path`` with all six
   strategies on rmat20, all equal, and at rmat16, each equal to
   ``reference_widest``.  None of these runs is in the counted window.
   fused: ``mode="fused"``, one launch of the persistent kernel
   ``csrc/fused.cu`` a traversal.  The seven rmat20 runs fused, each equal
   to the oracle and to its stepped card run above in ``(dist,
   iterations, edges_relaxed)`` and AD's choices; the launch counts are
   set to 0 just before them and read just after (seven fused launches,
   no B1/B2 launch: the kernel line's fused row).  The kernel against its
   plain loop on the same card tensors for all six strategies at rmat16
   (grid-wide and one-block chunks included) and sssp-WD at rmat20, timed
   there; the grid barrier's µs alone (``barrier_probe``: a cooperative
   grid of the fused kernel's size that only meets at barriers); each of
   the seven runs' grid-wide and one-block chunks, grid barriers and
   device ms beside its bytes bound (``fused_chunks``); fused and stepped
   runs interleaved on rmat20 (median ms, MTEPS, spread, ratio); one
   traced fused traversal per run (one fused kernel, no B1/B2; the idle
   share).
   batch: ``run_batch`` (ROADMAP A8) on rmat20 with K = 8 sources by
   fig12's rule (the highest out-degrees).  The launch counts are set to 0
   just before the sssp and bfs batches, stepped and fused, and read just
   after: one launch of B1's batch contract (``wd_relax_lanes_batch``:
   ``wd_relax_union_kernel``, one merge path over the union of the rows'
   frontiers, node-major) a stepped iteration and no single-row B1, one
   ``fused_fixed_point`` launch a row of a fused batch (the kernel line's
   B1-batch row and the fused row's ``batch_launches``).  Every row equals
   Dijkstra, stepped equals fused, the batch's iterations and edges are
   the maximum and the sum of the eight single-source fused WD runs,
   ``pad_to=16`` keeps the rows; a K = 32 fused batch (the next 32 nodes)
   equals its stepped batch (one B1 batch launch an iteration) and, in
   four rows, Dijkstra.  B1's batch contract against its plain version
   and the row-by-row oracle on every launch of the K = 8 stepped run
   and on derived cases (an empty row, a ``cap_work`` off the tile, a
   ``cap`` and a ``cap_work`` that cut rows, all four operators, K of 1,
   5 and 8, and the K = 32 run's widest launch), timed there beside both
   bounds (the union's and a row at a time); the fused batch against its
   plain loop (rmat16, four operators; rmat20, sssp), timed; the batches
   against eight sequential single runs, fused and stepped, and the K =
   32 batches, interleaved (3 rounds, medians, spread, MTEPS, queries/s);
   one traced fused batch (one fused kernel, idle share).
   graph_serve: ``GraphServer(mode="fused", max_batch=8)`` with rmat20
   resident, through ``repro_torch.launch.serve_graph.serve`` with the
   example's traffic (64 sssp queries from the 10% highest-degree nodes,
   bursts of 4, 30 s deadlines, 2 landmarks; the server steps after each
   burst, so no batch is wider than 4): one fused launch a dispatched
   lane (a row of a batch, padding included), every
   ``ok`` row equal to its source's fused run, four to Dijkstra;
   ``stats()`` (p50/p99, batches, occupancy, cache hits) and queries/s
   over the submit-to-drain window (the landmarks' warm-up excluded).
   costmodel (ROADMAP A9): AD's cost model calibrated on rmat20 (one fused
   launch a timed step, CUDA events; a second call is a cache hit), its
   coefficients, rows and step times, the block feasibility of B1's,
   B2's and the fused kernel's shapes; measured AD sssp stepped
   (``online=False``) and fused, counted from 0: both equal Dijkstra and
   each other, with ``kernel_counts`` equal to ``choose`` replayed from
   the stepped ``IterStats`` (the fused row's ``measured_ad_launches``);
   fused measured AD, fixed-tree AD and WD interleaved (3 rounds).
   delta (ROADMAP A10): road1024 (``road_grid_graph(side=1024,
   weighted=True, seed=4)``) at the auto Δ and at Δ = 25, sssp with BS,
   WD, NS, HP and AD, bfs and widest path, and rmat20 sssp WD, each
   stepped (one launch of the fused kernel's delta mode an epoch) and
   fused (one a traversal), counted from 0 (the fused row's
   ``delta_launches``): each equal to Dijkstra, scipy or
   ``reference_widest``, stepped equal to fused, the buckets strictly
   increasing, each run's rounds split between the grid and one block the
   same stepped and fused (``delta_run``: grid and narrow rounds, the
   fused launch's grid barriers); a K = 8 delta batch (one single-row
   launch a row) equal to its single runs; the delta kernel against its
   plain loop on the CPU at road256 and on the card at road1024 (values,
   counts and the rounds' split; timed: the fused row's ``at_delta``,
   bound by a worklist's bytes, 12 B an edge and a frontier node, and
   beside it, as ``dense_bound_ms``, by N bytes a round more); delta
   requests through ``GraphServer``; delta against
   BSP interleaved (epochs, rounds, ms).
   shard (ROADMAP A11): one process holding every shard on the card.
   ``ShardInfo`` of rmat20 at 2, 4 and 8 shards (cut share, halo bytes,
   edge imbalance, partition bytes); sssp WD and HP at 2 and 4 shards
   (degree), WD at 4 (contiguous), BS and NS at 2, each equal to Dijkstra
   and to the single-device run in ``(dist, iterations, edges_relaxed)``,
   with B1/B2 launched once a held shard a chunk (S times the run's
   folds, which a wrapper of ``ShardGroup.fold`` counts and times with
   CUDA events) and the fused kernel never; async WD and HP at 4 shards
   (epochs, rounds); a K = 8 batch at 2 shards equal to the single-device
   batch row by row (one B1 launch a live row and shard an iteration);
   ``distributed_sssp`` at 4 shards equal to Dijkstra (B3 a shard an
   iteration).  These are entry calls, each made once; the launch counts
   are set to 0 just before them and read just after them: the kernel
   line's B1, B2 and B3 rows add them (``shard_launches``).  Then each
   run timed beside the single-device fused and stepped runs
   (interleaved; each run's folds' CUDA-event spans and its traversal
   from the same run; one card runs every shard in turn, so this is the
   fold's cost and not a multi-GPU speed-up), and one sharded WD run
   under ``torch.profiler``: the device time of the kernels inside its
   folds beside the event spans; at rmat16 CC (symmetrized, against
   scipy) and widest path, and reach_count on a 16-layer DAG of 2^16
   nodes, sharded on the card, sharded on the CPU and on one device, all
   equal; two ranks, one shard each (NCCL on two cards, else gloo over
   CUDA tensors on one), sssp WD and BS at rmat16 from a graph on the
   host, equal to the one-process run, each rank holding one shard's
   slice on the card.
   custom_ops (ROADMAP queue C): user-defined operators, their
   callables lowered to C++ (``kernels/opgen.py``) and B1, B2, B1's batch
   contract and the fused kernel (BSP and delta) built for each at first
   use, four libraries at once (``_build.custom_lib``): each build's
   seconds and each custom instantiation's registers, spill bytes and
   blocks a SM.  The reference's slack operator (an update predicate), a
   penalty doubling weights above 50 and a budget spent along the path
   (max), each in B1, B2 and the batch contract against the plain
   versions on the same card tensors, bit for bit, int32 extremes among
   the values and weights; the penalty and the budget through the six
   strategies stepped and fused on rmat20, each equal to its oracle
   (Dijkstra over the penalised weights, max(B - d, 0)); slack stepped
   equal to fused; all three at rmat16 card against CPU (six strategies
   and a K = 4 batch, stepped and fused); a K = 8 penalty batch equal to
   its single runs; penalty delta-stepping on road1024 against Dijkstra;
   two shards against one device; the fused kernel against its plain
   loop; every custom instantiation timed for the kernel line (a row an
   operator and kernel, its launches those of the operator's entry
   calls); and fused WD sssp with ``shortest_path`` against the penalty
   above the heaviest weight (the same distances), interleaved.
   float_ops (ROADMAP queue C): float32 operators, each its own build of
   B1, B2, B1's batch contract and the fused kernel (BSP, batch, delta)
   with float values, three libraries at once: SSSP in hundredths (min,
   ``v + w * 0.01``), the most reliable path (max, ``v * (w / (w +
   1.0))``) and damped path counts (add, ``v * 0.5``, on a layered DAG).
   The lowered message's SASS has no FFMA; each kernel against its plain
   version on CPU copies (min/max bit for bit, add at rtol 1e-4), float
   extremes among the values; on rmat20 the six strategies stepped and
   fused agree and equal the plain loop; at rmat16 card against CPU and
   the float SSSP against a float32 Dijkstra; a K = 8 batch equal to its
   single runs; delta on road256 against the CPU and on road1024 against
   Dijkstra; two shards against one device; each float kernel timed for
   the kernel line (``<kernel><op>`` rows with ``dtype`` float32).
   subword_ops (ROADMAP queue C): sub-word operators, each its own build
   of B1, B2, B1's batch contract and the fused kernel (BSP, batch,
   delta) with values of its type, seven libraries: SSSP in bfloat16 and
   in int16 (an int32 message the fold narrows), the most reliable path
   in float16 (a float32 message), BFS levels in int8, the widest path in
   uint8, path counts in uint8 (add, wrapping) and damped counts in
   bfloat16 (add, on a layered DAG).  The 16-bit float builds' B1, B2
   and union hold no FFMA and their fused kernel as many as the int16
   build's; each kernel against its plain version on CPU copies at
   rmat20's N (min, max and integer add bit for bit, the bfloat16 add
   at rtol 4e-2), each type's extremes, ±0 and NaN among the values; on
   rmat20
   the six strategies fused agree, and WD stepped with fused; at rmat16
   the six stepped and fused agree, card against the CPU's stepped WD,
   a K = 8 batch equal to its rows, two shards
   against one device; delta on road256, stepped equal to fused, the two
   SSSPs against a Dijkstra in their type; the fused kernel against its
   plain loop (rmat20 WD; road64 delta on CPU copies); each instance
   timed for the kernel line (``<kernel><op>`` rows with its ``dtype``).
   Every operator library of custom_ops, float_ops and subword_ops
   starts building beside the base build (``start_prebuilds``: nvcc
   subprocesses, ``PREBUILD_WORKERS`` operators at a time, nothing
   loaded); each phase waits for its own and loads them.
   (The analysis phase runs right after the build: ``python -m
   repro_torch.analysis src/repro_torch`` in-process, which must report
   no finding, and the ``smem`` pass's footprint model of every kernel
   (threads, static shared bytes, the dynamic shared bytes its launcher
   requests) held equal to what the card reports
   (``costmodel.block_feasibility``: B1, B2, B3, B1's batch contract, the
   fused and delta kernels, B4 at each dtype and head dim, B5 at each
   dtype), with at least the blocks a SM their launch bounds promise.)
5. lm_kernels — B4 ``flash_attention`` (1 batch, 16 query heads over 8 KV
   heads, hd 128: S = 512 and 2048 bf16 causal, 512 f32, 512 bf16
   non-causal, ragged 1000; and a B4 row of the kernel line for each of
   granite_moe_3b_a800m's shape, 24 query heads over 8, hd 64, S = 2048
   bf16 causal, deepseek_v3_671b's MLA prefill, 128 heads each its own
   KV head, q/k head dim 192 and v head dim 128, S = 2048 bf16 causal,
   and llama_3_2_vision_11b's cross-attention, 32 heads over 8, hd 128,
   2048 text over 1601 image tokens, bf16 non-causal) and B5
   ``ssd_chunk_dual`` (8 chunks of 256, 48
   heads, P 64, N 128: bf16, f32, ragged c = 200) against their plain
   versions on the card, each timed beside its plain version and, for B4,
   ``scaled_dot_product_attention`` (timed only; the port never calls it).
   bf16 runs the tensor-core kernels, float32 the CUDA-core ones.
   Tolerances: B4 2e-2 (bf16) and 2e-6 (f32); B5 1e-4 (bf16) and 1e-5
   (f32), ``ATTN_TOL`` and ``SSD_TOL``.
   moe: one granite_moe_3b_a800m MoE layer at full width (d 1536, 40
   experts, top 8, expert d_ff 512) on 2048 tokens, routed once on the
   CPU: each of the four dispatch policies in bf16 on the card against
   float32 on the CPU at a capacity where nothing drops (and the four
   card results against each other), then at a capacity that drops:
   each assignment's queue position (so every keep mask) equal to the
   CPU's bit for bit, and ``dropped_frac`` equal; each policy timed;
6. lm_cpu — ``qwen3_0_6b`` and ``mamba2_780m`` at full width in float32
   (TF32 off): the same seeded weights on the card and the CPU, a 512-
   (Qwen3) or 600-token (Mamba-2: three chunks, ragged tail) prefill and 4
   greedy decode steps; every prefill and decode logit within 1e-3
   (Qwen3) or 5e-3 (Mamba-2, see ``main``) of the largest logit, equal
   greedy tokens; and ``granite_moe_3b_a800m`` at full width with
   ``num_layers`` cut to 4 (the whole model in float32 is 13.5 GB on the
   host), a 512-token prefill and 4 decode steps, teacher-forced (every
   layer on the card takes the CPU's input to it): each layer's output
   within 1e-4 of its scale, the routing ids of every MoE layer and call
   compared (a disagreement is reported with its layer, token and the
   gap between the CPU's router probabilities at the place it differs,
   and fails above 1e-6), the logits within 1e-3 of the largest and
   equal tokens.  Then both run free, beside the CPU with its embeddings
   perturbed by 2^-22 (the model's own float32 conditioning): the card's
   logit deviation and routing flips fail above 4x the perturbed run's;
7. lm_serve — each config at full width in bf16: a ``ServeLoop`` of 4
   slots over 8 requests (prompts of 256..2048 tokens, 32 new tokens
   each).  The launch counts are set to 0 just before each run and read
   just after it: every prefill layer launches its kernel once, so B4
   reads 28 x 8 in the Qwen3 run, B5 48 x 8 in the Mamba-2 run and B4
   32 x 8 in the granite_moe_3b_a800m run (its MoE layers are plain
   PyTorch, as the reference's are XLA: no kernel).
   After each run, one 2048-token prefill of the same model is traced with
   ``torch.profiler``: its kernel's share of device time, the number of
   device activities, and the device's idle share (the traced device time
   over the median wall time of five untraced prefills of that prompt).
8. A15's serving side.  deepseek_v3_671b at full width in bf16, its
   depth cut to its 3 dense layers and 1 MoE layer and its MTP block
   dropped (``DEEPSEEK_CUT``; 15.1 B parameters, 30 GB), built once:
   moe_sharded — its MoE layer (256 experts, top 8, expert d_ff 2048) on
   2048 seeded tokens at a capacity where nothing drops,
   ``sharded_moe_dispatch`` and ``ep_global_dispatch`` over 8 shards
   held on the card against the single-device ``padded`` dispatch
   (``MOE_SHARD_TOL``), and granite's 40 experts padded to 48 over 16
   shards, each timed; lm_serve deepseek_v3_671b — as phase 7, its MoE
   layer under ``use_group`` of 8 held shards (the config's
   ``moe_impl="shard_map"``), B4 4 x 8 launches.  lm_cpu
   deepseek_v3_671b (1 dense MLA layer), llama_3_2_vision_11b (one
   period of 5 layers with its cross layer, 1601 seeded image
   embeddings, every cross gate at 0.5 on both sides) and musicgen_large
   (4 layers, tokens [1, S, 4], logits [1, S, 4, 2048]), each as phase 6
   at full width in float32 (1e-3 of the largest logit, equal tokens);
   for deepseek also the absorbed decode against the expanded prefill
   over the same tokens on the card, float32 within 1e-3 and bf16 held
   to bf16's own deviation from float32 (``mla_decode_check``).
   lm_lockstep — vision (10 layers) and audio (48 layers) in bf16, the
   families ``ServeLoop`` refuses, driven by ``forward``/``decode_step``
   as the reference's prefill and serve steps drive them: a 4 x 1024
   prefill and 16 lockstep decode steps, prefill ms, decode ms a step
   and B4 launches (a layer and a cross layer each, the prefill only).
   pad_heads — granite at full width (4 of 32 layers, float32) with
   ``pad_heads=True`` (B4 at 32 query slots over 16 KV heads) against
   the unpadded model on the same weights, within 5e-4.
9. Training (ROADMAP A15 item 4).  train_kernels — B4's backward
   kernels (``flash_attention_bwd``: D, dK/dV, dQ) against
   ``flash_attention_bwd_plain`` at qwen3's training shape (4 x 2048,
   16/8 heads, hd 128, bf16 and f32), granite's (hd 64, G 3), MLA's
   (192/128, bf16 and f32) and the cross shape (2048 x 1601,
   non-causal), each beside SDPA's backward; B5's backward kernel
   against ``ssd_chunk_dual_bwd_plain`` at mamba2's training shape (BN
   16, c 256, H 48, P 64, N 128; bf16 and f32) and under a strong decay
   (a chunk's span > 88), finite; f32 within 1e-4 and bf16 within 2e-2
   of each output's largest magnitude; B4's second call gives the same
   bits, and each case's line gives its dK/dV and dQ kernels' registers
   and spill bytes (bf16: the tensor-core kernels, f32: the CUDA-core
   ones).  train_cpu qwen3_0_6b — one
   ``build_train_step`` step at full width, 2 of 28 layers, float32,
   card against CPU: the loss within 1e-4, every gradient leaf within
   1e-3 of its largest |g|, the parameters after AdamW within 1e-3.
   train — qwen3_0_6b (28 layers, 4 x 2048, 8 steps) and mamba2_780m
   (48 layers, 2 x 2048, 4 steps) at full width in bf16 through the
   ``Trainer`` (``TokenPipeline``, AdamW under a warm-up cosine of peak
   1e-3): finite losses and grad norms, step ms, tokens/s, peak memory
   and the launches of B4/B5 forward and backward (counts set to 0 just
   before the run); qwen3 checkpoints at step 4 and a fresh ``Trainer``
   restores it and replays steps 5-8 within 1e-5 of the first run.
10. dryrun — ``launch.dryrun.count_cell``'s count of one training step of
   each trained config at its run's batch on a 1 x 1 mesh, over meta
   tensors on the host: its B4/B5 calls a step equal the train phase's
   launches a step, each call's FLOPs the closed form of its kernel's
   bound; prints the counted FLOPs, ``model_flops_for``, the roofline's
   compute and memory terms and the measured share of the peak,
   ``model_flops / (step_s x 989e12)``, beside the step ms.

Every phase prints its seconds (``phase_seconds``).  Then one
``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}`` line.
Any failed check raises, and the script exits non-zero.  Without a
CUDA device, or outside a checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
CSRC = "src/repro_torch/kernels/csrc/relax.cu"

CSRC_FLASH = "src/repro_torch/kernels/csrc/flash_attention.cu"
#: B4's bf16 kernels, each of which the build line must show on the
#: tensor cores at every head-dim pair (B5's ``ssd_bf16_kernel`` too)
TC_FLASH_KERNELS = ("flash_bf16_kernel", "flash_bwd_dkdv_bf16_kernel",
                    "flash_bwd_dq_bf16_kernel")
CSRC_SSD = "src/repro_torch/kernels/csrc/ssd_chunk.cu"
#: cycles of the spin kernel ``time_ms`` queues ahead of each timed call
#: (about 1 ms at the H100's 1.98 GHz boost clock)
SLEEP_CYCLES = 2_000_000

OP_NAMES = ("shortest_path", "min_label", "widest_path", "reach_count")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _template_args(rest: str) -> list:
    """The template arguments at the head of a mangled ``I...E`` list:
    int literals, ``f32`` and ``bf16``."""
    out, i = [], 1
    while rest.startswith("I") and i < len(rest) and rest[i] != "E":
        m = re.match(r"Li(\d+)E", rest[i:])
        if m:
            out.append(m.group(1))
            i += m.end()
            continue
        m = re.match(r"(\d+)", rest[i:])
        if m:
            n = int(m.group(1))
            name = rest[i + m.end(): i + m.end() + n]
            out.append("bf16" if "bfloat16" in name else name)
            i += m.end() + n
            continue
        if rest[i] == "f":
            out.append("f32")
            i += 1
            continue
        break
    return out


def kernel_name(mangled: str) -> str | None:
    """``name<template args>`` of a mangled kernel symbol, or None: the
    length-prefixed identifier ending in ``_kernel``.  The anonymous
    namespace's file-unique prefix holds digits and lower-case letters
    too, so a digit run inside it can pass for a length prefix that takes
    in the real name; the real name is the candidate that starts last."""
    found = None
    for i, ch in enumerate(mangled):
        if not ch.isdigit():
            continue
        j = i
        while j < len(mangled) and mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name = mangled[j:j + n]
        if (len(name) == n and name.endswith("_kernel")
                and re.fullmatch(r"[a-z_][a-z0-9_]*", name)):
            found = (name, mangled[j + n:])
    if found is None:
        return None
    args = _template_args(found[1])
    return found[0] + (f"<{','.join(args)}>" if args else "")


def ptxas_summary(build_log: list) -> dict:
    """Registers and spill bytes (stores + loads) per compiled kernel from
    nvcc's ``-Xptxas -v`` output."""
    out, current = {}, None
    for line in "".join(build_log).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = kernel_name(m.group(1))
            if current:
                out[current] = {"registers": None, "spill_bytes": None}
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[current]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[current]["registers"] = int(m.group(1))
    return out


def sass_mma_counts(library: Path) -> dict:
    """Tensor-core instructions (``HMMA`` from mma.sync, ``HGMMA`` from
    wgmma) per compiled kernel of ``library``, read from ``cuobjdump
    -sass``; raises when the toolkit has no cuobjdump."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        raise RuntimeError("cuobjdump not found on PATH or at "
                           "/usr/local/cuda/bin/cuobjdump: the bf16 kernels' "
                           "tensor-core instructions cannot be counted")
    out = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    counts, current = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = kernel_name(m.group(1))
            if current:
                counts[current] = {"HMMA": 0, "HGMMA": 0}
        elif current and "HGMMA" in line:
            counts[current]["HGMMA"] += 1
        elif current and "HMMA" in line:
            counts[current]["HMMA"] += 1
    return counts


def time_ms(fn, *, reps: int = 10, flush=None, spin: bool = True) -> float:
    """Median device milliseconds of ``fn`` by CUDA events, after one
    warm-up call; ``flush`` (a tensor larger than L2) is overwritten
    before each timed call, so every run starts with a cold cache.  With
    ``spin``, a spin kernel of about a millisecond (``torch.cuda._sleep``)
    runs just before the start event, so the host has queued the whole
    call before the card reaches it: the time is the card's, not the
    wrapper's Python and launch overhead (which exceeds a small kernel's
    device time).  Without it the time also holds whatever host enqueue
    the card waits for."""
    import torch
    fn()
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        if spin:
            torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def hardware() -> dict:
    """The H100 SXM data sheet's peaks (700 W), from
    ``repro_torch.roofline.analysis``: ``hbm_bw``; ``peak_flops`` (dense
    bf16 on the tensor cores, the bf16 B4 and B5 kernels' bound) and
    ``peak_flops_f32`` (float32 outside the tensor cores, the closest the
    data sheet gives to the integer ALU work of the graph kernels)."""
    from repro_torch.roofline.analysis import HARDWARE
    return HARDWARE


def peak_rate(dtype) -> float:
    """The peak rate of a float kernel of ``dtype``."""
    hw = hardware()
    return (hw["peak_flops"] if str(dtype).endswith("bfloat16")
            else hw["peak_flops_f32"])


def bound(nbytes: float, ops: float,
          peak_ops: float | None = None) -> tuple[float, str]:
    hw = hardware()
    t_bytes = nbytes / hw["hbm_bw"] * 1e3
    t_ops = ops / (hw["peak_flops_f32"] if peak_ops is None
                   else peak_ops) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(got, want) -> int:
    """Largest elementwise difference over paired outputs (bools as 0/1);
    raises on a shape mismatch."""
    err = 0
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"output {tuple(a.shape)}/{a.dtype} vs "
                                 f"plain {tuple(b.shape)}/{b.dtype}")
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def random_dist(rng, op, n, dev):
    import numpy as np
    import torch
    if op.combine == "min":
        d = rng.integers(0, 1 << 20, n)
        d[rng.random(n) < 0.4] = op.identity
    elif op.combine == "max":
        d = rng.integers(0, 200, n)
    else:
        d = rng.integers(0, 4, n)
    return torch.from_numpy(d.astype(np.int32)).to(dev)


def wd_inputs(g, rng, f_slots, cursor_max, dev, nodes=None, runs=()):
    """The arguments of one WD step (as ``strategies.wd_relax`` builds
    them) over a frontier of ``f_slots`` random nodes (or the sorted
    ``nodes``) with random cursors in ``[0, cursor_max]`` (non-zero
    cursors: HP's tail).  The slots of each ``(lo, hi)`` of ``runs`` get
    a cursor past the end: runs of zero-degree slots."""
    import numpy as np
    import torch
    from repro_torch.core.worklist import bucket
    if nodes is None:
        nodes = np.sort(rng.choice(g.num_nodes, f_slots, replace=False))
    f_slots = len(nodes)
    f = torch.from_numpy(nodes.astype(np.int32)).to(dev)
    cursor = rng.integers(0, cursor_max + 1, f_slots).astype(np.int32)
    for lo, hi in runs:
        cursor[lo:hi] = 1 << 20
    cursor = torch.from_numpy(cursor).to(dev)
    deg = (g.row_ptr[f + 1] - g.row_ptr[f] - cursor).clamp_(min=0)
    prefix = torch.cumsum(deg, 0, dtype=torch.int32)
    total = int(prefix[-1])
    return dict(prefix=prefix, exclusive=prefix - deg,
                start=g.row_ptr[f] + cursor, src_ids=f,
                cap_work=bucket(total), total=total)


def lane_inputs(rng, n, lanes, dev):
    import numpy as np
    import torch

    def t(a):
        return torch.from_numpy(a).to(dev)
    return dict(src=t(rng.integers(0, n, lanes).astype(np.int32)),
                dst=t(rng.integers(0, n, lanes).astype(np.int32)),
                w=t(rng.integers(1, 101, lanes).astype(np.int32)),
                valid=t(rng.random(lanes) < 0.7))


def hp_tile_inputs(g, rng, rows, mdt, dev):
    """One HP sub-iteration's ``[rows, mdt]`` tile over random nodes from
    cursor 0, built as ``strategies.hp_sub_relax`` builds it: most lanes
    are invalid (a node has fewer than ``mdt`` edges left)."""
    import numpy as np
    import torch
    nodes = np.sort(rng.choice(g.num_nodes, rows, replace=rows > g.num_nodes))
    n = torch.from_numpy(nodes.astype(np.int32)).to(dev)
    deg = g.row_ptr[n + 1] - g.row_ptr[n]
    pos = torch.arange(mdt, dtype=torch.int32, device=dev)[None, :]
    eidx = (g.row_ptr[n][:, None] + pos).clamp_(0, g.num_edges - 1)
    eidx = eidx.reshape(-1)
    return dict(src=n[:, None].expand(-1, mdt).reshape(-1),
                dst=g.col[eidx], w=g.wt[eidx],
                valid=(pos < deg[:, None]).reshape(-1))


def time_pair(fn, plain, reps, flush) -> dict:
    """``fn`` timed L2-cold (``flush`` overwritten before each call) and
    warm (no flush: what consecutive BS columns see), and ``plain``
    cold."""
    return dict(ms=time_ms(fn, reps=reps, flush=flush),
                ms_warm=time_ms(fn, reps=reps),
                plain_ms=time_ms(plain, reps=reps, flush=flush))


def fold_bytes(n: int, contract: str, improving: int,
               width: int = 4) -> int:
    """The bytes over ``dist [n]`` (values ``width`` bytes wide) and the
    outputs of a B1/B2 call with ``improving`` improving lanes.  The
    proposal contract reads dist once and writes the whole proposal and
    ``updated``: 9n for int32.  The fold into a copy of dist
    (``apply_relax``, ``wd_apply_relax``) reads dist once and writes the
    next dist once, 8n for int32, and writes ``updated`` only where a lane
    improves: the running mask is neither read nor cleared."""
    if contract in ("relax_lanes", "wd_relax_lanes"):
        return (2 * width + 1) * n
    return 2 * width * n + improving


def b1_work(prefix, total) -> tuple[int, int]:
    """The slot-table bytes and the operations of B1 over the rows of
    ``prefix`` ([f] or [K, f]) with ``total`` ([] or [K]) valid lanes a
    row.  A tile stages only the slots of its valid lanes: over a row,
    the slots with 0 < prefix < total and the last lane's, 16 B each
    (prefix, exclusive, start, src_ids); padded slots and the tiles past
    a row's total are never read.  Each valid lane searches the row's
    slots and then does 6 operations."""
    import numpy as np
    prefix, total = prefix.reshape(-1, prefix.shape[-1]), total.reshape(-1, 1)
    slots = (((prefix > 0) & (prefix < total)).sum(1)
             + (total[:, 0] > 0)).tolist()
    lanes = total[:, 0].tolist()
    steps = [int(np.ceil(np.log2(s + 1))) for s in slots]
    return (16 * sum(slots),
            sum(t * (st + 6) for t, st in zip(lanes, steps)))


def time_b1(g, a, dist, op, reps, flush, contract="wd_relax_lanes") -> dict:
    """B1 timed on one WD step's arguments ``a`` (``wd_inputs``,
    ``path_calls``) beside its plain version, with its bound.
    ``contract`` "wd_relax_lanes" returns the proposal; "wd_apply_relax"
    times what ``wd_relax`` runs per WD iteration: a fresh mask, the copy
    of dist, the launch."""
    import torch
    from repro_torch.kernels import relax
    n = g.num_nodes
    cap, f_slots, total = a["cap_work"], a["prefix"].numel(), a["total"]
    args = (a["prefix"], a["exclusive"], a["start"], a["src_ids"], g.col,
            g.wt)
    if contract == "wd_relax_lanes":
        def fn():
            return relax.wd_relax_lanes(dist, *args, cap_work=cap, op=op)

        def plain():
            return relax.wd_relax_lanes_plain(dist, *args, cap_work=cap,
                                              op=op)
    else:
        def fn():
            return relax.wd_apply_relax(
                dist, torch.zeros(n, dtype=torch.bool, device=dist.device),
                *args, cap_work=cap, op=op)

        def plain():
            return relax.wd_apply_relax_plain(
                dist, torch.zeros(n, dtype=torch.bool, device=dist.device),
                *args, cap_work=cap, op=op)
    improving = int(plain()[2].sum())
    slot_bytes, ops = b1_work(a["prefix"], a["prefix"][-1].clamp(max=cap))
    # + cap: the improve flag of every lane, which this contract writes
    t_b, by = bound(fold_bytes(n, contract, improving, dist.element_size())
                    + slot_bytes + 8 * total + cap, ops)
    return dict(contract=contract, **time_pair(fn, plain, reps, flush),
                bound_ms=t_b, bound_by=by,
                shape=dict(n=n, f=f_slots, cap_work=cap, edges=total,
                           improving=improving, weighted=True, op=op.name))


def time_b2(b, dist, op, reps, flush, contract="relax_lanes") -> dict:
    """B2 timed on the lanes ``b`` (``lane_inputs``, ``path_calls``)
    beside its plain version, with its bound.  ``contract``
    "relax_lanes" returns the proposal; "apply_relax" is what a BS column
    or HP tile runs: the copy of dist and the launch, folding into a
    running mask."""
    import torch
    from repro_torch.kernels import relax
    n, lanes = dist.numel(), b["src"].numel()
    lane_args = (b["src"], b["dst"], b["w"], b["valid"])
    valid_lanes = int(b["valid"].sum())
    mask = torch.zeros(n, dtype=torch.bool, device=dist.device)
    if contract == "relax_lanes":
        def fn():
            return relax.relax_lanes(dist, *lane_args, op=op)

        def plain():
            return relax.relax_lanes_plain(dist, *lane_args, op=op)
    else:
        def fn():
            return relax.apply_relax(dist, mask, *lane_args, op=op)

        def plain():
            return relax.apply_relax_plain(dist, mask, *lane_args, op=op)
    improving = int(plain()[2].sum())
    # valid read and improve written per lane, src/dst/w per valid lane
    # (an invalid lane needs nothing else)
    nbytes = fold_bytes(n, contract, improving, dist.element_size()) \
        + 2 * lanes + 12 * valid_lanes
    t_b, by = bound(nbytes, 6 * valid_lanes)
    return dict(contract=contract, **time_pair(fn, plain, reps, flush),
                bound_ms=t_b, bound_by=by,
                shape=dict(n=n, lanes=lanes, valid=valid_lanes,
                           improving=improving, op=op.name))


#: B1's case whose block tiles outgrow the shared memory that stages their
#: slot slice: every node of rmat20 in the frontier, with runs of
#: thousands of zero-degree slots (cursors past the end, as in HP's tail)
ZERO_RUNS = ((100, 5100), (6000, 8500), (9000, 9001), (500000, 800000))


def kernel_phase(g, dev, *, frontiers, lanes_list, reps=10):
    """Hold B1/B2/B3 against their plain versions (exact) at every shape
    and operator, B1 and B2 in both contracts: the proposal
    (``wd_relax_lanes``, ``relax_lanes``) and the fold into dist and a
    running mask (``wd_apply_relax``, ``apply_relax``).  Time each at the
    largest shape.  Returns the kernel rows of the final JSON line
    (launches filled in later)."""
    import numpy as np
    import torch
    from repro_torch.core import operators
    from repro_torch.kernels import find_offsets as fo
    from repro_torch.kernels import relax

    rng = np.random.default_rng(0)
    n = g.num_nodes
    err = {"wd_relax_lanes": 0, "relax_lanes": 0, "find_offsets": 0}
    checked = []

    def check(kernel, case, got, want):
        e = max_abs_err(got, want)
        err[kernel] = max(err[kernel], e)
        checked.append([kernel, *case, e])

    def running_mask():
        return torch.from_numpy(rng.random(n) < 0.2).to(dev)

    def check_b1(a, wt, case):
        for name in OP_NAMES:
            op = operators.OPERATORS[name]
            dist = random_dist(rng, op, n, dev)
            args = (a["prefix"], a["exclusive"], a["start"], a["src_ids"],
                    g.col, wt)
            kw = dict(cap_work=a["cap_work"], op=op)
            check("wd_relax_lanes", case + ["proposal", name],
                  relax.wd_relax_lanes(dist, *args, **kw),
                  relax.wd_relax_lanes_plain(dist, *args, **kw))
            mask = running_mask()
            want = relax.wd_apply_relax_plain(dist, mask.clone(), *args,
                                              **kw)
            check("wd_relax_lanes", case + ["apply", name],
                  relax.wd_apply_relax(dist, mask, *args, **kw), want)

    def check_b2(b, case):
        for name in OP_NAMES:
            op = operators.OPERATORS[name]
            dist = random_dist(rng, op, n, dev)
            args = (dist, b["src"], b["dst"], b["w"], b["valid"])
            check("relax_lanes", case + ["proposal", name],
                  relax.relax_lanes(*args, op=op),
                  relax.relax_lanes_plain(*args, op=op))
            mask = running_mask()
            want = relax.apply_relax_plain(dist, mask.clone(), *args[1:],
                                           op=op)
            check("relax_lanes", case + ["apply", name],
                  relax.apply_relax(dist, mask, *args[1:], op=op), want)

    def check_b3(prefix, cap, case):
        got = fo.find_offsets(prefix, cap)
        check("find_offsets", case, [got],
              [fo.find_offsets_plain(prefix, cap)])
        if prefix.numel():
            check("find_offsets", case + ["searchsorted"], [got],
                  [torch.searchsorted(prefix, torch.arange(
                      cap, dtype=torch.int32, device=dev), right=True,
                      out_int32=True)])

    for f_slots in frontiers:
        for weighted in (True, False):
            for cursor_max in (0, 2):
                a = wd_inputs(g, rng, f_slots, cursor_max, dev)
                check_b1(a, g.wt if weighted else None,
                         [f_slots, weighted, cursor_max])
        a = wd_inputs(g, rng, f_slots, 0, dev)
        check_b3(a["prefix"], a["cap_work"], [f_slots])
    a = wd_inputs(g, rng, n, 1, dev, nodes=np.arange(n), runs=ZERO_RUNS)
    check_b1(a, g.wt, [n, "zero-degree runs"])
    # B3: tiles whose prefix slice is too wide to stage, and no slot
    check_b3(a["prefix"], a["cap_work"], [n, "zero-degree runs"])
    check_b3(a["prefix"], a["total"] + 1001, [n, "zero-degree runs",
                                               "off-tile"])
    for cap in (1000, 1 << 23):
        check_b3(torch.zeros(0, dtype=torch.int32, device=dev), cap,
                 [0, cap])
    for lanes in lanes_list:
        check_b2(lane_inputs(rng, n, lanes, dev), [lanes])
    check_b2(hp_tile_inputs(g, rng, 4096, 64, dev), ["hp tile", 4096, 64])
    bad = [c for c in checked if c[-1] != 0]
    emit("kernels_check", cases=len(checked), mismatches=bad)
    if bad:
        raise AssertionError(f"kernel != plain version: {bad}")

    # timing at the largest shapes, shortest_path (SSSP's operator)
    op = operators.shortest_path
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > L2
    rows = []

    a = wd_inputs(g, rng, max(frontiers), 0, dev)
    rows.append(dict(
        name="wd_relax_lanes", route="cuda", source=CSRC,
        replaces="src/repro/kernels/relax.py:349", launches=0,
        max_abs_err=err["wd_relax_lanes"], library_ms=None,
        **time_b1(g, a, random_dist(rng, op, n, dev), op, reps, flush)))
    b = lane_inputs(rng, n, max(lanes_list), dev)
    rows.append(dict(
        name="relax_lanes", route="cuda", source=CSRC,
        replaces="src/repro/kernels/relax.py:243", launches=0,
        max_abs_err=err["relax_lanes"], library_ms=None,
        **time_b2(b, random_dist(rng, op, n, dev), op, reps, flush)))

    cap, f_slots = a["cap_work"], max(frontiers)
    log2f = int(np.ceil(np.log2(f_slots + 1)))
    prefix = a["prefix"]
    k = torch.arange(cap, dtype=torch.int32, device=dev)
    t_b, by = bound(4 * f_slots + 4 * cap, cap * log2f)
    rows.append(dict(
        name="find_offsets", route="cuda", source=CSRC,
        replaces="src/repro/kernels/find_offsets.py:46", launches=0,
        max_abs_err=err["find_offsets"],
        ms=time_ms(lambda: fo.find_offsets(prefix, cap), reps=reps,
                   flush=flush),
        plain_ms=time_ms(lambda: fo.find_offsets_plain(prefix, cap),
                         reps=reps, flush=flush),
        bound_ms=t_b, bound_by=by,
        library_ms=time_ms(lambda: torch.searchsorted(
            prefix, k, right=True, out_int32=True), reps=reps, flush=flush),
        shape=dict(f=f_slots, cap_work=cap)))
    emit("kernels_time", rows=rows)
    return rows


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def dijkstra_oracle(g, source: int, weighted: bool):
    """Exact distances by scipy's Dijkstra (float64 holds these integer
    sums exactly); unreachable nodes get the port's INF."""
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra
    from repro_torch.core.graph import INF
    row_ptr = g.row_ptr.cpu().numpy()
    col = g.col.cpu().numpy()
    data = (g.wt.cpu().numpy().astype(np.float64) if weighted
            else np.ones(g.num_edges))
    m = sp.csr_matrix((data, col, row_ptr), shape=(g.num_nodes,) * 2)
    d = dijkstra(m, directed=True, indices=source)
    out = np.full(g.num_nodes, INF, np.int64)
    reach = np.isfinite(d)
    out[reach] = d[reach].astype(np.int64)
    return out.astype(np.int32)


def kernel_counts(r) -> dict:
    """How often AD chose each kernel (empty for the fixed strategies)."""
    counts: dict = {}
    for st in r.iter_stats:
        if st.kernel is not None:
            counts[st.kernel] = counts.get(st.kernel, 0) + 1
    return counts


def same_run(a, b) -> bool:
    import numpy as np
    return (np.array_equal(a.dist, b.dist) and a.iterations == b.iterations
            and a.edges_relaxed == b.edges_relaxed)


#: the main path's runs on rmat20: (algo, strategy); EP is the chunked
#: push (its default)
PATH_RUNS = (("sssp", "WD"), ("sssp", "BS"), ("sssp", "HP"), ("sssp", "AD"),
             ("bfs", "WD"), ("sssp", "EP"), ("sssp", "NS"))


def path_phase(g, dev):
    """The main path on the rmat graph ``g``: the seven ``PATH_RUNS``,
    each equal to the Dijkstra oracle.  The launch counts are set to 0
    just before the runs and read just after them, so B1's and B2's
    launches are those of all seven; returns ``(launches, results,
    per_run)``, the last each run's launches and mean lanes a launch of
    B1/B2."""
    import numpy as np
    from repro_torch.algos import bfs, sssp
    from repro_torch.kernels.relax import LANES, LAUNCHES

    name = f"rmat{g.num_nodes.bit_length() - 1}"
    source = int(g.degrees.argmax())
    oracle_w = dijkstra_oracle(g, source, weighted=True)
    oracle_u = dijkstra_oracle(g, source, weighted=False)
    sssp(g, source, strategy="WD", device=dev)           # warm-up, uncounted

    runs = [(algo, strategy, oracle_w if algo == "sssp" else oracle_u)
            for algo, strategy in PATH_RUNS]
    results, per_run = {}, {}
    for counts in (LAUNCHES, LANES):
        for key in counts:
            counts[key] = 0
    for algo, strategy, oracle in runs:
        before, lanes_before = dict(LAUNCHES), dict(LANES)
        fn = sssp if algo == "sssp" else bfs
        r = fn(g, source, strategy=strategy, device=dev)
        if r.dist.shape != (g.num_nodes,) or not np.array_equal(r.dist,
                                                                oracle):
            raise AssertionError(f"{algo}-{strategy} on {name} != Dijkstra")
        results[(algo, strategy)] = r
        launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        mean_lanes = {k: (LANES[k] - lanes_before[k]) / launched[k]
                      for k in LANES if launched[k]}
        per_run[(algo, strategy)] = dict(launches=launched,
                                         mean_lanes=mean_lanes)
        emit("path_run", graph=name, algo=algo, strategy=strategy,
             device=str(dev), nodes=g.num_nodes, edges=g.num_edges,
             source=source, iterations=r.iterations,
             edges_relaxed=r.edges_relaxed,
             traversal_seconds=r.traversal_seconds, mteps=r.mteps,
             setup_seconds=r.setup_seconds, state_bytes=r.state_bytes,
             kernel_counts=kernel_counts(r),
             launches=launched, mean_lanes_per_launch=mean_lanes,
             equals_oracle=True)
    launches = dict(LAUNCHES)
    emit("path_launches", graph=name, launches=launches)
    if launches["wd_relax_lanes"] < 1 or launches["relax_lanes"] < 1:
        raise AssertionError(f"main path missed a kernel: {launches}")
    return launches, results, per_run


def find_offsets_entry_phase(g, dev) -> None:
    """``ops.wd_find_offsets`` (the find_offsets entry point, which the
    main path never calls: B1 does its own search) on the whole-graph
    degree prefix of ``g`` (every node active), against
    ``torch.searchsorted``."""
    import torch
    from repro_torch.core.worklist import bucket
    from repro_torch.kernels import ops
    prefix = torch.cumsum(g.degrees, 0, dtype=torch.int32)
    offsets = ops.wd_find_offsets(prefix, bucket(g.num_edges))
    want = torch.searchsorted(prefix, torch.arange(
        offsets.numel(), dtype=torch.int32, device=dev), right=True,
        out_int32=True)
    if not torch.equal(offsets, want):
        raise AssertionError("ops.wd_find_offsets failed")
    emit("find_offsets_entry", graph=f"rmat{g.num_nodes.bit_length() - 1}",
         f=g.num_nodes, cap_work=offsets.numel(), equal=True)


def device_activities(fn) -> list:
    """Names of the device activities (kernels, copies, fills) of one call
    of ``fn``, after a warm-up call, by ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


#: the most traces taken of one call: ``torch.profiler`` has dropped a
#: kernel's record on the H100 (7 of a batch's 8 fused launches traced)
TRACE_ATTEMPTS = 3


def traced_call(fn, kernel_sym: str, counted: str):
    """One call of ``fn`` under ``torch.profiler``, timed on the host
    between two syncs.  The call's launches are read from the wrappers'
    counts (``LAUNCHES``); the trace is whole when it holds one record of
    ``kernel_sym`` for each launch of ``counted``, and is taken again (at
    most ``TRACE_ATTEMPTS`` times, each a new call) while it holds fewer.
    More records than launches, or no whole trace, fail the run.  Returns
    ``(fn's result, the trace's device activities, its records of
    kernel_sym, wall seconds, the call's launches, the records each
    attempt held)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.relax import LAUNCHES
    seen = []
    for _ in range(TRACE_ATTEMPTS):
        torch.cuda.synchronize()
        before = dict(LAUNCHES)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                    if LAUNCHES[k] != before[k]}
        acts = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        ours = [e for e in acts if kernel_sym in e.name]
        seen.append(len(ours))
        if len(ours) > launched.get(counted, 0):
            raise AssertionError(f"the trace holds {len(ours)} {kernel_sym} "
                                 f"records for {launched} launches")
        if len(ours) == launched.get(counted, 0):
            return out, acts, ours, wall, launched, seen
    raise AssertionError(f"no whole trace of {counted}: {kernel_sym} "
                         f"records {seen} for {launched} launches")


#: (kernel, run) pairs of the path_lanes phase
PATH_LANES = (("wd_relax_lanes", ("sssp", "WD")),
              ("relax_lanes", ("sssp", "BS")),
              ("relax_lanes", ("sssp", "HP")),
              ("relax_lanes", ("sssp", "AD")),
              ("relax_lanes", ("sssp", "EP")),
              ("relax_lanes", ("sssp", "NS")))

#: the wrapper through which each kernel runs on the path
PATH_WRAPPER = {"wd_relax_lanes": "wd_apply_relax",
                "relax_lanes": "apply_relax"}


def _on_launches(g, dev, run, kernel, on_launch) -> int:
    """Run ``run`` (``(algo, strategy)``) on ``g`` with ``kernel``'s
    wrapper (``PATH_WRAPPER``) wrapped: ``on_launch(i, dist, call)`` sees
    the arguments of its ``i``-th call that launched the kernel (B2:
    ``src``, ``dst``, ``w``, ``valid``; B1: ``prefix``, ``exclusive``,
    ``start``, ``src_ids``, ``cap_work``).  Returns the launches."""
    from repro_torch.algos import bfs, sssp
    from repro_torch.kernels import relax

    wrapper = PATH_WRAPPER[kernel]
    real = getattr(relax, wrapper)
    seen = [0]

    def recording(dist, updated, *args, **kw):
        before = relax.LAUNCHES[kernel]
        out = real(dist, updated, *args, **kw)      # reads, never writes,
        if relax.LAUNCHES[kernel] == before:        # dist and the lanes
            return out
        if kernel == "relax_lanes":
            call = dict(zip(("src", "dst", "w", "valid"), args))
        else:
            call = dict(zip(("prefix", "exclusive", "start", "src_ids"),
                            args[:4]), cap_work=kw["cap_work"])
        on_launch(seen[0], dist, call)
        seen[0] += 1
        return out

    setattr(relax, wrapper, recording)
    try:
        fn = sssp if run[0] == "sssp" else bfs
        fn(g, int(g.degrees.argmax()), strategy=run[1], device=dev)
    finally:
        setattr(relax, wrapper, real)
    return seen[0]


def _lanes_and_valid(kernel: str, call: dict):
    """A launch's lanes (an int) and valid lanes (a device scalar)."""
    if kernel == "relax_lanes":
        return call["src"].numel(), call["valid"].sum()
    return call["cap_work"], call["prefix"][-1].clamp(max=call["cap_work"])


def path_calls(g, dev, run, kernel, calls):
    """The launches of ``kernel`` in ``run`` as the path makes them: its
    frontier, the column or tile cursor of that moment, and dist as it
    then stood.  The run is made twice.  The first time records each of
    its ``calls`` launches' lanes and valid lanes, and groups the launches
    into strata by the power of 2 each count falls in.  The second keeps
    the arguments of the middle launch of each stratum, weighted by the
    stratum's size, so that weighted means over the kept launches estimate
    means over all of the run's.  Returns ``(kept, valid)``: each kept
    launch as a dict of its arguments and ``weight`` (B2: ``dist``,
    ``src``, ``dst``, ``w``, ``valid``; B1: ``dist``, ``prefix``,
    ``exclusive``, ``start``, ``src_ids``, ``cap_work``, ``total``), and
    the valid lanes over all of the run's launches."""
    import torch

    counts = []
    seen = _on_launches(g, dev, run, kernel, lambda i, dist, call: counts
                        .append(_lanes_and_valid(kernel, call)))
    if seen != calls:
        raise AssertionError(f"{'-'.join(run)} launched {kernel} {seen} "
                             f"times again, not {calls}")
    valid = torch.stack([v for _, v in counts]).tolist() if counts else []
    strata: dict = {}
    for i, (lanes, _) in enumerate(counts):
        key = (int(lanes).bit_length(), int(valid[i]).bit_length())
        strata.setdefault(key, []).append(i)
    picks = {m[len(m) // 2]: len(m) for m in strata.values()}
    kept = []

    def keep(i, dist, call):
        if i in picks:
            call = {k: v.clone() if torch.is_tensor(v) else v
                    for k, v in call.items()}
            if kernel == "wd_relax_lanes":
                call["total"] = int(valid[i])
            kept.append(dict(dist=dist.clone(), weight=picks[i], **call))
    _on_launches(g, dev, run, kernel, keep)
    return kept, int(sum(valid))


def mean_timing(timed: list, weights: list) -> dict:
    """The weighted mean over kept launches of each time, bound and shape
    count of ``time_b1``/``time_b2`` results of one contract."""
    total = sum(weights)

    def mean(values):
        return sum(w * v for w, v in zip(weights, values)) / total
    out = dict(timed[0], launches_timed=len(timed))
    for key in ("ms", "ms_warm", "plain_ms", "bound_ms"):
        out[key] = mean([t[key] for t in timed])
    out["bound_by"] = statistics.mode(t["bound_by"] for t in timed)
    out["shape"] = dict(timed[0]["shape"])
    for key, v in timed[0]["shape"].items():
        if isinstance(v, int) and not isinstance(v, bool):
            out["shape"][key] = mean([t["shape"][key] for t in timed])
    return out


def path_lanes_phase(g, dev, rows, per_run, reps: int = 10) -> None:
    """B1 and B2 timed again on the launches the path makes, in both
    contracts, L2-cold and warm: each run of ``PATH_LANES`` is made again
    and one launch of each stratum of its launches is kept
    (``path_calls``) and timed; the entry holds the means over the run's
    launches (weighted by stratum) beside the run's launches, its valid
    lanes a launch and ``launches × (ms − bound)``.  Adds
    ``at_path_lanes`` to the kernel rows.  Then one ``apply_relax`` and
    one ``wd_apply_relax`` are traced: each is two device activities, the
    copy of dist and the launch."""
    import torch
    from repro_torch.core import operators
    from repro_torch.kernels import relax

    op = operators.shortest_path
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > L2
    by_name = {row["name"]: row for row in rows}
    traced = {}
    for name, run in PATH_LANES:
        launched = per_run[run]["launches"][name]
        kept, valid = path_calls(g, dev, run, name, launched)
        timed = {}
        for c in kept:
            dist = c.pop("dist")
            for contract in (name, PATH_WRAPPER[name]):
                t = (time_b1(g, c, dist, op, reps, flush, contract)
                     if name == "wd_relax_lanes" else
                     time_b2(c, dist, op, reps, flush, contract))
                timed.setdefault(contract, []).append(t)
            traced.setdefault(name, (dist, c))
        weights = [c["weight"] for c in kept]
        for t in (mean_timing(ts, weights) for ts in timed.values()):
            entry = dict(
                run="-".join(run), mean_lanes=per_run[run]["mean_lanes"][name],
                valid_lanes_per_launch=valid / launched,
                launches_in_run=launched,
                gap_ms=launched * (t["ms"] - t["bound_ms"]),
                gap_ms_warm=launched * (t["ms_warm"] - t["bound_ms"]), **t)
            by_name[name].setdefault("at_path_lanes", []).append(entry)
            emit("path_lanes_time", kernel=name, **entry)
        del kept

    mask = torch.zeros(g.num_nodes, dtype=torch.bool, device=dev)
    dist, b = traced["relax_lanes"]
    b2 = device_activities(lambda: relax.apply_relax(
        dist, mask, b["src"], b["dst"], b["w"], b["valid"], op=op))
    dist, a = traced["wd_relax_lanes"]
    b1 = device_activities(lambda: relax.wd_apply_relax(
        dist, mask, a["prefix"], a["exclusive"], a["start"], a["src_ids"],
        g.col, g.wt, cap_work=a["cap_work"], op=op))
    emit("apply_activities", apply_relax=b2, wd_apply_relax=b1)
    for acts, kernel in ((b2, "relax_lanes_kernel"),
                         (b1, "wd_relax_lanes_kernel")):
        ours = [x for x in acts if re.search(rf"(^|[^a-z_]){kernel}", x)]
        if len(acts) != 2 or len(ours) != 1:
            raise AssertionError(f"a fold into dist is not one copy and "
                                 f"one {kernel}: {acts}")


def cpu_compare_phase(g, dev, results, *, cpu_scale: int) -> None:
    """The card's sssp-WD run on ``g`` against the same run on the CPU,
    and all four strategies at rmat-``cpu_scale`` on both devices."""
    from repro_torch.algos import sssp
    from repro_torch.data import rmat_graph

    source = int(g.degrees.argmax())
    t0 = time.perf_counter()
    cpu = sssp(g, source, strategy="WD", device="cpu")
    name = f"rmat{g.num_nodes.bit_length() - 1}"
    if not same_run(cpu, results[("sssp", "WD")]):
        raise AssertionError(f"{name} sssp-WD: cuda != cpu")
    emit("path_cpu_compare", graph=name, strategy="WD", equal=True,
         cpu_seconds=time.perf_counter() - t0)

    small = rmat_graph(scale=cpu_scale, edge_factor=8, weighted=True,
                       seed=1, device=dev)
    s_src = int(small.degrees.argmax())
    for strategy in ("WD", "BS", "HP", "AD"):
        runs2 = [sssp(small, s_src, strategy=strategy, device=d)
                 for d in (dev, "cpu")]
        if not same_run(*runs2) or (kernel_counts(runs2[0])
                                    != kernel_counts(runs2[1])):
            raise AssertionError(f"rmat{cpu_scale} {strategy}: cuda != cpu")
        emit("path_cpu_compare", graph=f"rmat{cpu_scale}", strategy=strategy,
             equal=True, iterations=runs2[0].iterations,
             edges_relaxed=runs2[0].edges_relaxed)


def iteration_trace(r) -> list:
    return [(st.frontier_size, st.edges_processed, st.sub_iterations,
             st.kernel) for st in r.iter_stats]


def strategies_cpu_phase(dev, *, scale: int) -> None:
    """EP (chunked and unchunked pushes) and NS at rmat-``scale`` on the
    card and on the CPU: ``(dist, iterations, edges_relaxed)`` and every
    iteration's accounting equal, and dist equal to the Dijkstra
    oracle."""
    import numpy as np
    from repro_torch.algos import bfs, sssp
    from repro_torch.data import rmat_graph

    g = rmat_graph(scale=scale, edge_factor=8, weighted=True, seed=1,
                   device=dev)
    source = int(g.degrees.argmax())
    oracles = {"sssp": dijkstra_oracle(g, source, weighted=True),
               "bfs": dijkstra_oracle(g, source, weighted=False)}
    for algo, strategy, kw in (("sssp", "EP", {}),
                               ("sssp", "EP", {"chunked": False}),
                               ("sssp", "NS", {}), ("bfs", "EP", {}),
                               ("bfs", "NS", {})):
        fn = sssp if algo == "sssp" else bfs
        t0 = time.perf_counter()
        card, cpu = (fn(g, source, strategy=strategy, device=d, **kw)
                     for d in (dev, "cpu"))
        name = f"rmat{scale} {algo}-{strategy}{kw or ''}"
        if not same_run(card, cpu) or (iteration_trace(card)
                                       != iteration_trace(cpu)):
            raise AssertionError(f"{name}: cuda != cpu")
        if not np.array_equal(card.dist, oracles[algo]):
            raise AssertionError(f"{name} != Dijkstra")
        emit("strategies_cpu", graph=f"rmat{scale}", algo=algo,
             strategy=strategy, chunked=kw.get("chunked", strategy == "EP"),
             iterations=card.iterations, edges_relaxed=card.edges_relaxed,
             state_bytes=card.state_bytes, equal=True, equals_oracle=True,
             seconds=time.perf_counter() - t0)


def memory_wall_phase(g, dev, results) -> None:
    """EP's memory bill on ``g`` beside WD's and NS's (the path runs'
    ``state_bytes``), NS's split of ``g``, and EP with a budget of the
    CSR's bytes: ``MemoryError`` before anything is allocated on the
    card."""
    import torch
    from repro_torch.algos import sssp
    from repro_torch.core.graph import coo_bytes
    from repro_torch.core.strategies import make_strategy

    t0 = time.perf_counter()
    csr = g.device_bytes()
    ep, wd, ns = (results[("sssp", s)].state_bytes for s in ("EP", "WD",
                                                             "NS"))
    if ep != coo_bytes(g) or wd != csr:
        raise AssertionError(f"state bytes EP {ep}, WD {wd}; want "
                             f"{coo_bytes(g)}, {csr}")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    try:
        sssp(g, int(g.degrees.argmax()), strategy="EP",
             memory_budget_bytes=csr, device=dev)
    except MemoryError as e:
        message = str(e)
    else:
        raise AssertionError("EP ran with a budget of the CSR's bytes")
    allocated = torch.cuda.memory_allocated(dev) - before
    if allocated:
        raise AssertionError(f"EP allocated {allocated} bytes before its "
                             f"memory wall")
    split = make_strategy("NS").setup(g)
    emit("memory_wall", graph=f"rmat{g.num_nodes.bit_length() - 1}",
         csr_bytes=csr, ep_state_bytes=ep, ep_over_csr=ep / csr,
         wd_state_bytes=wd, ns_state_bytes=ns, budget=csr,
         memory_error=message, allocated_before_error=allocated,
         ns_mdt=split.mdt, ns_nodes_split=int((g.degrees > split.mdt).sum()),
         ns_children=split.num_children, ns_nodes=split.graph.num_nodes,
         ns_max_degree=split.graph.max_degree,
         seconds=time.perf_counter() - t0)


def symmetrized(g, dev):
    """The undirected copy of ``g``: every edge both ways, deduplicated,
    unweighted (as the reference's CC tests build it)."""
    import numpy as np
    from repro_torch.core.graph import CSRGraph
    src = np.repeat(np.arange(g.num_nodes), g.degrees.cpu().numpy())
    dst = g.col.cpu().numpy()
    return CSRGraph.from_edges(np.concatenate([src, dst]),
                               np.concatenate([dst, src]), None, g.num_nodes,
                               dedup=True, device=dev)


def component_minima(g):
    """scipy's connected components of the symmetric ``g``, each node
    labelled with its component's minimum id."""
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components
    n = g.num_nodes
    m = sp.csr_matrix((np.ones(g.num_edges), g.col.cpu().numpy(),
                       g.row_ptr.cpu().numpy()), shape=(n, n))
    _, comp = connected_components(m, directed=False)
    mins = np.full(comp.max() + 1, n)
    np.minimum.at(mins, comp, np.arange(n))
    return mins[comp].astype(np.int32)


def algos_phase(g, dev, *, small_scale: int) -> None:
    """Connected components and widest path.  CC on the symmetrized
    ``g`` with WD, HP and NS, each equal to scipy's components; with BS
    and AD at rmat-``small_scale``, on the card and the CPU, both equal to
    scipy's.  Widest path on ``g`` with all six strategies, all equal;
    at rmat-``small_scale`` each equal to ``reference_widest``."""
    import numpy as np
    from repro_torch.algos import (connected_components, reference_widest,
                                   widest_path)
    from repro_torch.data import rmat_graph

    name = f"rmat{g.num_nodes.bit_length() - 1}"
    small = rmat_graph(scale=small_scale, edge_factor=8, weighted=True,
                       seed=1, device=dev)
    small_name = f"rmat{small_scale}"
    for graph, gname, strategies, devices in (
            (g, name, ("WD", "HP", "NS"), (dev,)),
            (small, small_name, ("BS", "AD"), (dev, "cpu"))):
        t0 = time.perf_counter()
        sym = symmetrized(graph, dev)
        want = component_minima(sym)
        emit("algos_cc_graph", graph=f"{gname}-sym", nodes=sym.num_nodes,
             edges=sym.num_edges, max_degree=sym.max_degree,
             components=int(np.unique(want).size),
             seconds=time.perf_counter() - t0)
        for strategy in strategies:
            for d in devices:
                t0 = time.perf_counter()
                labels = connected_components(sym, strategy=strategy,
                                              device=d)
                if labels.shape != want.shape or not np.array_equal(labels,
                                                                    want):
                    raise AssertionError(f"CC-{strategy} on {gname}-sym "
                                         f"({d}) != scipy")
                emit("algos_cc", graph=f"{gname}-sym", strategy=strategy,
                     device=str(d), equals_scipy=True,
                     seconds=time.perf_counter() - t0)
    strategies = ("BS", "EP", "WD", "NS", "HP", "AD")
    for graph, gname in ((g, name), (small, small_name)):
        source = int(graph.degrees.argmax())
        oracle = (reference_widest(graph, source) if graph is small
                  else None)
        first = None
        for strategy in strategies:
            r = widest_path(graph, source, strategy=strategy, device=dev)
            if r.dist.shape != (graph.num_nodes,):
                raise AssertionError(f"widest-{strategy} on {gname}: shape "
                                     f"{r.dist.shape}")
            first = r.dist if first is None else first
            if not np.array_equal(r.dist, first):
                raise AssertionError(f"widest-{strategy} on {gname} != "
                                     f"widest-{strategies[0]}")
            if oracle is not None and not np.array_equal(r.dist, oracle):
                raise AssertionError(f"widest-{strategy} on {gname} != "
                                     f"reference_widest")
            emit("algos_widest", graph=gname, strategy=strategy,
                 source=source, iterations=r.iterations,
                 edges_relaxed=r.edges_relaxed,
                 traversal_seconds=r.traversal_seconds, mteps=r.mteps,
                 equals_first=True, equals_reference_widest=(
                     True if oracle is not None else None))


# ---------------------------------------------------------------------------
# phase 4b: the fused fixed point, one launch a traversal
# ---------------------------------------------------------------------------

CSRC_FUSED = "src/repro_torch/kernels/csrc/fused.cu"
#: the reference loop the fused kernel stands for (not a pallas_call)
FUSED_REPLACES = "src/repro/core/fused.py:389"
#: interleaved fused/stepped rounds on rmat20 (BS's stepped run is ~2 s)
FUSED_ROUNDS = 3


def engine_run(g, algo: str, strategy: str, source: int, dev, mode: str):
    """One ``sssp`` or ``bfs`` traversal through ``engine.run``; returns
    the result and the strategy (AD's ``kernel_counts``)."""
    from repro_torch.core import engine
    from repro_torch.core.strategies import make_strategy
    strat = make_strategy(strategy)
    graph = g if algo == "sssp" else g.unweighted()
    return engine.run(graph, source, strat, mode=mode, device=dev), strat


def fused_args(g, strategy: str, source: int, op, dev):
    """The fused kernel's arguments for ``strategy`` on ``g`` from
    ``source``: ``(kernel, graph, aux, dist, mask)`` and the keywords."""
    import torch
    from repro_torch.core import fused
    from repro_torch.core.strategies import make_strategy
    strat = make_strategy(strategy)
    plan = fused._plan(strat, strat.setup(g), g)
    n = plan.graph.num_nodes
    dist = torch.full((n,), op.identity, dtype=op.dtype, device=dev)
    dist[source] = op.seed(source)
    mask = torch.zeros(n, dtype=torch.bool, device=dev)
    mask[source] = True
    return ((plan.kernel, plan.graph, plan.aux, dist, mask),
            dict(op=op, sched=plan.sched, max_iterations=100000))


#: grid barriers of the barrier probe's long launch
BARRIER_PROBE_K = 20000


def barrier_us(dev) -> float:
    """Microseconds of one grid barrier of the fused kernel's grid:
    ``kernels.fused.barrier_probe`` at k = 0 and ``BARRIER_PROBE_K``
    barriers, each timed by CUDA events (median of 5)."""
    from repro_torch.kernels import fused as fused_kernel
    t = {k: time_ms(lambda k=k: fused_kernel.barrier_probe(k, dev), reps=5)
         for k in (0, BARRIER_PROBE_K)}
    return (t[BARRIER_PROBE_K] - t[0]) * 1e3 / BARRIER_PROBE_K


def run_bytes(graph, r, width: int = 4) -> int:
    """The least bytes of a traversal of ``graph`` whose stepped run is
    ``r`` (values ``width`` bytes wide): col, the weight (a weighted graph
    only) and the destination's value of each relaxed edge, row_ptr (2)
    and the value of each frontier node, the mask each iteration."""
    frontier_nodes = sum(st.frontier_size for st in r.iter_stats)
    per_edge = (4 if graph.wt is None else 8) + width
    return (per_edge * r.edges_relaxed + (8 + width) * frontier_nodes
            + graph.num_nodes * r.iterations)


def fused_run_chunks(g, dev, stepped, source, reps: int = 3) -> dict:
    """Each of ``PATH_RUNS`` as one launch of the fused kernel's wrapper:
    its grid-wide and one-block chunks and grid barriers, its device ms
    (``time_ms``) and its bytes bound (``run_bytes`` of its stepped run).
    The launches are outside the counted window."""
    from repro_torch.core import operators
    from repro_torch.kernels import fused as fused_kernel
    out = {}
    for algo, strategy in PATH_RUNS:
        graph = g if algo == "sssp" else g.unweighted()
        args, kw = fused_args(graph, strategy, source,
                              operators.shortest_path, dev)
        got = fused_kernel.fixed_point(*args, **kw)
        s = stepped[(algo, strategy)]
        if got[1:3] != (s.iterations, s.edges_relaxed):
            raise AssertionError(f"fused {algo}-{strategy}: {got[1:3]}")
        ms = time_ms(lambda: fused_kernel.fixed_point(*args, **kw),
                     reps=reps)
        bound_ms, bound_by = bound(run_bytes(graph, s), 0)
        chunks = got[4]
        out[f"{algo}-{strategy}"] = dict(
            ms=ms, bound_ms=bound_ms, bound_by=bound_by,
            grid_chunks=chunks.grid, block_chunks=chunks.block,
            barriers=chunks.barriers, tail_width=fused_kernel.TAIL_WIDTH)
        emit("fused_chunks", graph=f"rmat{g.num_nodes.bit_length() - 1}",
             run=f"{algo}-{strategy}", iterations=got[1],
             **out[f"{algo}-{strategy}"])
    return out


def fused_phase(g, dev, stepped, *, small_scale: int,
                rounds: int = FUSED_ROUNDS) -> dict:
    """``mode="fused"`` on the card.  On ``g`` (rmat20) from the path
    phase's source, the seven ``PATH_RUNS`` fused, each equal to the
    Dijkstra oracle and to the stepped card run of the path phase in
    ``(dist, iterations, edges_relaxed)`` and AD's kernel choices; the
    launch counts are set to 0 just before them and read just after (one
    fused launch each, no B1/B2 launch).  The kernel against its plain
    version on the same card tensors for all six strategies at
    rmat-``small_scale``, and for sssp-WD on ``g``, where both are timed
    for the kernel line.  Then fused and stepped runs interleaved
    (``rounds`` each, after the warm runs above): median traversal ms,
    MTEPS, spread and fused/stepped ratio per run; then one traced fused
    traversal per run: its device activities (exactly one fused kernel,
    no B1/B2) and the device's idle share.  Returns the kernel line's
    row."""
    import numpy as np
    import torch
    from repro_torch.core import fused, operators
    from repro_torch.data import rmat_graph
    from repro_torch.kernels import fused as fused_kernel
    from repro_torch.kernels.relax import LAUNCHES

    name = f"rmat{g.num_nodes.bit_length() - 1}"
    source = int(g.degrees.argmax())
    oracle = {"sssp": dijkstra_oracle(g, source, weighted=True),
              "bfs": dijkstra_oracle(g, source, weighted=False)}
    engine_run(g, "sssp", "WD", source, dev, "fused")      # warm-up
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    for algo, strategy in PATH_RUNS:
        r, strat = engine_run(g, algo, strategy, source, dev, "fused")
        s = stepped[(algo, strategy)]
        if not np.array_equal(r.dist, oracle[algo]):
            raise AssertionError(f"fused {algo}-{strategy} != Dijkstra")
        if not same_run(r, s):
            raise AssertionError(f"fused {algo}-{strategy} != stepped")
        if strategy == "AD" and strat.kernel_counts != kernel_counts(s):
            raise AssertionError(f"fused AD chose {strat.kernel_counts}, "
                                 f"stepped {kernel_counts(s)}")
        emit("fused_run", graph=name, algo=algo, strategy=strategy,
             source=source, iterations=r.iterations,
             edges_relaxed=r.edges_relaxed,
             traversal_seconds=r.traversal_seconds, mteps=r.mteps,
             kernel_counts=getattr(strat, "kernel_counts", None),
             equals_oracle=True, equals_stepped=True)
    launches = dict(LAUNCHES)
    emit("fused_launches", graph=name, launches=launches)
    if (launches["fused_fixed_point"] != len(PATH_RUNS)
            or launches["relax_lanes"] or launches["wd_relax_lanes"]):
        raise AssertionError(f"fused runs launched {launches}")

    # the kernel against its plain version on the same card tensors
    op = operators.shortest_path
    small = rmat_graph(scale=small_scale, edge_factor=8, weighted=True,
                       seed=1, device=dev)
    err = 0
    cases = [(small, s, int(small.degrees.argmax()))
             for s in ("BS", "WD", "HP", "EP", "NS", "AD")]
    for graph, strategy, src in cases + [(g, "WD", source)]:
        args, kw = fused_args(graph, strategy, src, op, dev)
        t0 = time.perf_counter()
        got = fused_kernel.fixed_point(*args, **kw)
        t1 = time.perf_counter()
        want = fused._fixed_point_plain(*args, **kw)
        t2 = time.perf_counter()
        gname = f"rmat{graph.num_nodes.bit_length() - 1}"
        if got[1:] != want[1:] or not torch.equal(got[0], want[0]):
            raise AssertionError(f"fused kernel != plain: {gname} "
                                 f"{strategy}: {got[1:]} vs {want[1:]}")
        err = max(err, max_abs_err([got[0]], [want[0]]))
        emit("fused_vs_plain", graph=gname, strategy=strategy,
             iterations=got[1], edges_relaxed=got[2], ad_chosen=got[3],
             grid_chunks=got[4].grid, block_chunks=got[4].block,
             barriers=got[4].barriers, equal=True,
             kernel_seconds=t1 - t0, plain_seconds=t2 - t1)
    ms = time_ms(lambda: fused_kernel.fixed_point(*args, **kw))
    plain_ms = time_ms(lambda: fused._fixed_point_plain(*args, **kw),
                       reps=3)
    # the least bytes of sssp-WD's traversal
    wd = stepped[("sssp", "WD")]
    frontier_nodes = sum(st.frontier_size for st in wd.iter_stats)
    bound_ms, bound_by = bound(run_bytes(g, wd), 0)
    row = dict(name="fused_fixed_point", route="cuda", source=CSRC_FUSED,
               replaces=FUSED_REPLACES,
               launches=launches["fused_fixed_point"], max_abs_err=err,
               ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=None,
               shape=dict(graph=name, run="sssp-WD",
                          iterations=wd.iterations,
                          edges_relaxed=wd.edges_relaxed,
                          frontier_nodes=frontier_nodes))
    emit("fused_kernel_time", **row)

    # the grid barrier alone, and each run's chunks and device time beside
    # its bytes bound
    row["barrier_us"] = barrier_us(dev)
    row["runs"] = fused_run_chunks(g, dev, stepped, source)
    emit("barrier_probe", us_a_barrier=row["barrier_us"],
         barriers=BARRIER_PROBE_K)

    # fused and stepped interleaved, each run warm
    times = {key: {"fused": [], "stepped": []} for key in PATH_RUNS}
    edges = {}
    for i in range(rounds):
        for key in PATH_RUNS:
            order = ("fused", "stepped") if i % 2 == 0 else ("stepped",
                                                             "fused")
            for mode in order:
                r, _ = engine_run(g, *key, source, dev, mode)
                times[key][mode].append(r.traversal_seconds)
                edges[key] = r.edges_relaxed
    for key in PATH_RUNS:
        med = {m: statistics.median(t) for m, t in times[key].items()}
        emit("fused_vs_stepped", graph=name, algo=key[0], strategy=key[1],
             rounds=rounds,
             fused_ms=[t * 1e3 for t in times[key]["fused"]],
             stepped_ms=[t * 1e3 for t in times[key]["stepped"]],
             fused_median_ms=med["fused"] * 1e3,
             stepped_median_ms=med["stepped"] * 1e3,
             fused_mteps=edges[key] / med["fused"] / 1e6,
             stepped_mteps=edges[key] / med["stepped"] / 1e6,
             fused_spread=(max(times[key]["fused"])
                           - min(times[key]["fused"])) / med["fused"],
             stepped_spread=(max(times[key]["stepped"])
                             - min(times[key]["stepped"])) / med["stepped"],
             fused_over_stepped=med["fused"] / med["stepped"])

    # one whole trace of a fused traversal per run: one fused launch, no
    # B1/B2
    for key in PATH_RUNS:
        (r, _), acts, ours, wall, launched, seen = traced_call(
            lambda: engine_run(g, *key, source, dev, "fused"),
            "fused_fixed_point_kernel", "fused_fixed_point")
        relax_acts = [e for e in acts if "relax_lanes_kernel" in e.name]
        busy = sum(e.device_time for e in acts) / 1e6
        kernel_s = sum(e.device_time for e in ours) / 1e6
        emit("fused_trace", graph=name, algo=key[0], strategy=key[1],
             activities=len(acts), fused_launches=len(ours),
             relax_launches=len(relax_acts),
             names=sorted({e.name[:50] for e in acts}),
             traced_wall_seconds=wall, device_seconds=busy,
             kernel_seconds=kernel_s, device_idle_share=1.0 - busy / wall,
             traversal_seconds=r.traversal_seconds,
             kernel_share_of_traversal=kernel_s / r.traversal_seconds,
             trace_attempts=len(seen), fused_records_by_attempt=seen)
        if launched != {"fused_fixed_point": 1} or relax_acts:
            raise AssertionError(f"traced fused {key}: launched {launched}, "
                                 f"{len(relax_acts)} B1/B2 records")
    return row


# ---------------------------------------------------------------------------
# phase 4c: batched queries (A8) and the graph-query server (A12)
# ---------------------------------------------------------------------------

#: the batches of the batch phase: fig12's K, and a wider one
BATCH_K = 8
BATCH_K_WIDE = 32
#: interleaved rounds of the batch timings
BATCH_ROUNDS = 3
B1_BATCH_REPLACES = "src/repro/kernels/relax.py:349"
#: the reference's batched relax: a jax.vmap of B1 (a grid axis of its
#: pallas_call)
B1_BATCH_VMAP = "src/repro/core/multi_source.py:111"


def batch_sources(g, k: int, skip: int = 0):
    """fig12's rule (benchmarks/fig12_adaptive.py ``_batch_sources``): the
    ``k`` nodes of highest out-degree, here after the first ``skip``."""
    import numpy as np
    order = np.argsort(g.degrees.cpu().numpy())[::-1]
    return np.asarray(order[skip:skip + k], np.int32)


def dijkstra_rows(g, sources, weighted: bool):
    """``dijkstra_oracle`` for each source: ``[K, N]``."""
    import numpy as np
    return np.stack([dijkstra_oracle(g, int(s), weighted) for s in sources])


def zero_counts() -> None:
    from repro_torch.kernels.relax import LANES, LAUNCHES
    for counts in (LAUNCHES, LANES):
        for key in counts:
            counts[key] = 0


def batch_calls(g, dev, sources, widest_only: bool = False,
                op="shortest_path") -> list:
    """The B1 batch launches of a stepped batch of ``op`` (sssp by
    default) on ``g``: each launch's node-major ``dist_t``/``front_t``
    and union slot tables as the batch gave them (cloned); with
    ``widest_only``, only the launch of the most union lanes."""
    import torch
    from repro_torch.core import engine
    from repro_torch.kernels import relax
    real = relax.wd_apply_relax_union
    kept = []

    def recording(dist_t, front_t, *args, **kw):
        if not widest_only or not kept or (kw["max_lanes"]
                                           > kept[0]["max_lanes"]):
            c = dict(dist_t=dist_t.clone(), front_t=front_t.clone(),
                     tables=[a.clone() for a in args[:4]], rows=len(sources),
                     cap_work=kw["cap_work"], max_lanes=kw["max_lanes"])
            kept[:] = [c] if widest_only else kept + [c]
        return real(dist_t, front_t, *args, **kw)

    relax.wd_apply_relax_union = recording
    try:
        engine.run_batch(g, sources, mode="stepped", op=op, device=dev)
    finally:
        relax.wd_apply_relax_union = real
    torch.cuda.synchronize()
    return kept


def relayout(x_t, k: int, fill):
    """The first ``k`` rows of node-major ``x_t``, node-major again
    (``Kp`` for ``k``)."""
    from repro_torch.core import multi_source
    return multi_source.to_node_major(
        multi_source.from_node_major(x_t, k), fill)


def union_check(g, dist_t, front_t, k: int, op, *, cap: int,
                cap_work: int, cut: bool, tables=None) -> int:
    """B1's batch contract on node-major ``dist_t``/``front_t`` (``k``
    rows), each row's frontier cut at ``cap`` nodes, with a row table
    when ``cut``: the kernel against its plain version on the same card
    tensors, and against the row-by-row oracle
    ``wd_apply_relax_batch_plain`` transposed back to ``[K, N]``.
    ``tables``: the union's slot tables as a stepped batch gave them
    (else built here).  Returns the largest difference."""
    import torch
    from repro_torch.core import multi_source as ms
    from repro_torch.kernels import relax
    mask_b = ms.from_node_major(front_t, k)
    ft = front_t & (torch.cumsum(front_t, 0, dtype=torch.int32) <= cap)
    if tables is None:
        live = ft.any(1)
        tables = ms.union_tables(g, live, max(int(live.sum()), 1))
    row_excl = ms.row_exclusive(ft, *tables[:2], tables[3]) if cut else None
    args = (dist_t, ft, *tables, g.col, g.wt)
    kw = dict(cap_work=cap_work, row_excl=row_excl, op=op)
    got = relax.wd_apply_relax_union(*args, max_lanes=int(tables[0][-1]),
                                     **kw)
    want = relax.wd_apply_relax_union_plain(*args, **kw)
    rows = relax.wd_apply_relax_batch_plain(
        ms.from_node_major(dist_t, k), torch.zeros_like(mask_b),
        *ms.row_tables(g, mask_b, cap), g.col, g.wt, cap_work=cap_work,
        op=op)
    return max(max_abs_err(got, want),
               max_abs_err([ms.from_node_major(t, k) for t in got], rows))


def b1_batch_check(g, dev, kept, wide) -> tuple:
    """B1's batch contract (``union_check``) on the card: every launch
    ``kept`` from the K = 8 stepped sssp batch with its own tables, dist
    and frontier; the widest of them with row 0's frontier emptied, with
    a row table and a ``cap_work`` one past the largest row total (off the
    1,024-item tile), with a ``cap`` and a ``cap_work`` that cut rows,
    with each of the four ``OP_NAMES`` operators on random values, and
    cut to its first 1 and 5 rows; ``wide``, the widest launch of the
    K = 32 stepped batch.  Returns ``(cases, max_abs_err)``; raises on a
    difference."""
    import numpy as np
    import torch
    from repro_torch.core import multi_source as ms
    from repro_torch.core import operators
    rng = np.random.default_rng(11)
    cases, err, bad = 0, 0, []
    sssp = operators.shortest_path

    def check(case, c, op=sssp, dist_t=None, front_t=None, k=None, cap=None,
              cap_work=None, cut=False, tables=None):
        nonlocal cases, err
        front_t = c["front_t"] if front_t is None else front_t
        k = c["rows"] if k is None else k
        widest = int(front_t.sum(0).max())
        e = union_check(
            g, c["dist_t"] if dist_t is None else dist_t, front_t, k, op,
            cap=max(widest, 1) if cap is None else cap,
            cap_work=c["cap_work"] if cap_work is None else cap_work,
            cut=cut, tables=tables)
        cases += 1
        err = max(err, e)
        if e:
            bad.append((case, op.name, k, e))

    for i, c in enumerate(kept):
        check(f"launch {i}", c, tables=c["tables"])
    c = max(kept, key=lambda c: c["max_lanes"])
    k, n = c["rows"], c["dist_t"].shape[0]
    empty = c["front_t"].clone()
    empty[:, 0] = False
    check("empty row", c, front_t=empty)
    totals = torch.where(ms.from_node_major(c["front_t"], k),
                         g.degrees, 0).sum(1)
    odd = int(totals.max()) + 1
    odd += odd % 1024 == 0
    check("cap_work not a tile multiple", c, cap_work=odd, cut=True)
    widest = int(c["front_t"].sum(0).max())
    check("cap and cap_work cut rows", c, cap=widest // 2,
          cap_work=int(totals.max()) // 2 + 1, cut=True)
    for name in OP_NAMES:
        op = operators.OPERATORS[name]
        dist_b = random_dist(rng, op, k * n, dev).reshape(k, n)
        check(f"random {name}", c, op=op,
              dist_t=ms.to_node_major(dist_b, op.identity))
    for rows in (1, 5):
        check(f"K = {rows}", c, k=rows,
              dist_t=relayout(c["dist_t"], rows, sssp.identity),
              front_t=relayout(c["front_t"], rows, False))
    check("K = 32, widest launch", wide, tables=wide["tables"])
    emit("b1_batch_check", graph=f"rmat{n.bit_length() - 1}", rows=k,
         cases=cases, launches_kept=len(kept), mismatches=bad)
    if bad:
        raise AssertionError(f"B1 batch != plain: {bad}")
    return cases, err


def b1_batch_time(g, c, reps: int = 10, op=None) -> dict:
    """B1's batch contract as a stepped iteration runs it (the copy of
    dist_t, a zeroed frontier, the launch), timed L2-cold and warm on the
    kept launch ``c`` beside its plain version, with two bounds.
    ``bound_ms``, the union's: dist_t read once and its next copy written
    once (8 B a node and row quad's row), each union slot's tables (16 B,
    ``b1_work``) and frontier bytes (``Kp``), ``col``/``wt`` once a union
    edge (8 B), and a byte a row where it improves.  ``row_bound_ms``, a
    row at a time (the row contract's bound): B1's apply bound
    (``time_b1``) on each row's own tables, summed."""
    import torch
    from repro_torch.core import multi_source as ms
    from repro_torch.core import operators
    from repro_torch.kernels import relax
    op = operators.shortest_path if op is None else op
    dist_t, front_t, k = c["dist_t"], c["front_t"], c["rows"]
    n, kp = dist_t.shape
    cap_work, tables = c["cap_work"], c["tables"]
    args = (dist_t, front_t, *tables, g.col, g.wt)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dist_t.device)

    def fn():
        return relax.wd_apply_relax_union(*args, cap_work=cap_work,
                                          max_lanes=c["max_lanes"], op=op)

    def plain():
        return relax.wd_apply_relax_union_plain(*args, cap_work=cap_work,
                                                op=op)
    union_lanes = int(tables[0][-1])
    improved = int(plain()[1].sum())
    slot_bytes, ops = b1_work(tables[0], tables[0][-1])
    slots = slot_bytes // 16
    width = dist_t.element_size()
    t_b, by = bound(2 * width * n * kp + slot_bytes + kp * slots
                    + 8 * union_lanes + improved, ops * (kp // 4))
    mask_b = ms.from_node_major(front_t, k)
    rows = ms.row_tables(g, mask_b, max(int(mask_b.sum(1).max()), 1))
    totals = rows[0][:, -1].clamp(max=cap_work)
    row_improving = (ms.from_node_major(plain()[0], k)
                     != ms.from_node_major(dist_t, k)).sum(1).tolist()
    row_slot_bytes, row_ops = b1_work(rows[0], totals)
    row_b, row_by = bound(sum(fold_bytes(n, "wd_apply_relax", imp, width)
                              for imp in row_improving)
                          + row_slot_bytes + 8 * int(totals.sum()), row_ops)
    return dict(contract="wd_apply_relax_union",
                **time_pair(fn, plain, reps, flush), bound_ms=t_b,
                bound_by=by, row_bound_ms=row_b, row_bound_by=row_by,
                shape=dict(n=n, rows=k, kp=kp, slots=tables[0].numel(),
                           union_lanes=union_lanes,
                           row_lanes=int(totals.sum()), cap_work=cap_work,
                           improved=improved, weighted=True, op=op.name))


def single_runs(g, sources, dev, mode: str) -> list:
    """One WD traversal a source through ``engine.run``."""
    from repro_torch.core import engine
    from repro_torch.core.strategies import make_strategy
    return [engine.run(g, int(s), make_strategy("WD"), mode=mode, device=dev)
            for s in sources]


def batch_phase(g, dev, fused_row, *, small_scale: int,
                rounds: int = BATCH_ROUNDS) -> dict:
    """``run_batch`` on the card: K = 8 sources by fig12's rule on ``g``
    (rmat20).  The launch counts are set to 0 just before the four K = 8
    batches (sssp and bfs, stepped and fused) and read just after: one B1
    batch launch a stepped iteration and no single-row B1, one fused
    launch a row of a fused batch.  Every row equals Dijkstra; stepped equals
    fused; the batch's iterations and edges are the maximum and the sum
    of the eight single-source fused WD runs; ``pad_to=16`` keeps the
    first eight rows.  A K = 32 fused sssp batch (the next 32 nodes)
    equals its stepped batch (one B1 batch launch an iteration), and four
    of its rows Dijkstra.  B1's batch contract against its plain version
    and the row-by-row oracle on launches kept from the K = 8 stepped run
    and the widest of the K = 32 run (``b1_batch_check``) and timed on
    the widest K = 8 launch; the fused batch against
    ``_batch_fixed_point_plain`` at rmat-``small_scale`` (four operators)
    and on ``g`` (sssp).  Then, interleaved over ``rounds``: the K = 8
    fused and stepped batches against eight sequential single runs, and
    the K = 32 fused and stepped batches; one traced fused batch (a fused
    kernel a row).  Returns the
    kernel line's B1-batch row and adds ``at_batch`` to ``fused_row``."""
    import numpy as np
    import torch
    from repro_torch.core import engine, fused, multi_source, operators
    from repro_torch.core.schedule import DEFAULT_SCHEDULE
    from repro_torch.data import rmat_graph
    from repro_torch.kernels import fused as fused_kernel
    from repro_torch.kernels.relax import LAUNCHES

    name = f"rmat{g.num_nodes.bit_length() - 1}"
    src8 = batch_sources(g, BATCH_K)
    graphs = {"sssp": g, "bfs": g.unweighted()}
    oracle = {algo: dijkstra_rows(g, src8, algo == "sssp")
              for algo in graphs}
    for mode in ("stepped", "fused"):                     # warm-up
        engine.run_batch(g, src8, mode=mode, device=dev)

    zero_counts()
    runs = {}
    for algo, gg in graphs.items():
        for mode in ("stepped", "fused"):
            before = dict(LAUNCHES)
            r = engine.run_batch(gg, src8, mode=mode, device=dev)
            launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
            runs[(algo, mode)] = r
            if not np.array_equal(r.dist, oracle[algo]):
                raise AssertionError(f"{mode} {algo} batch != Dijkstra")
            want = ({"wd_relax_lanes_batch": r.iterations}
                    if mode == "stepped"
                    else {"fused_fixed_point": len(src8)})
            if {k: v for k, v in launched.items() if v} != want:
                raise AssertionError(f"{mode} {algo} batch launched "
                                     f"{launched}, not {want}")
            emit("batch_run", graph=name, algo=algo, mode=mode,
                 sources=src8.tolist(), iterations=r.iterations,
                 edges_relaxed=r.edges_relaxed,
                 total_seconds=r.total_seconds, mteps=r.mteps,
                 queries_per_second=r.queries_per_second,
                 launches=launched, equals_oracle=True)
    launches = dict(LAUNCHES)
    emit("batch_launches", graph=name, launches=launches)

    for algo, gg in graphs.items():
        s, f = runs[(algo, "stepped")], runs[(algo, "fused")]
        if not same_run(s, f):
            raise AssertionError(f"{algo} batch: stepped != fused")
        single = single_runs(gg, src8, dev, "fused")
        its = max(r.iterations for r in single)
        edges = sum(r.edges_relaxed for r in single)
        if (f.iterations, f.edges_relaxed) != (its, edges):
            raise AssertionError(f"{algo} batch ({f.iterations}, "
                                 f"{f.edges_relaxed}) != single runs "
                                 f"(max {its}, sum {edges})")
        emit("batch_vs_single", graph=name, algo=algo, iterations=its,
             edges_relaxed=edges,
             single_iterations=[r.iterations for r in single],
             equal=True)
    padded = engine.run_batch(g, src8, mode="fused", pad_to=16, device=dev)
    if (padded.pad_lanes != 8 or not np.array_equal(
            padded.dist[:8], runs[("sssp", "fused")].dist)):
        raise AssertionError("pad_to=16 changed the batch's rows")

    src32 = batch_sources(g, BATCH_K_WIDE, skip=BATCH_K)
    before = LAUNCHES["fused_fixed_point"]
    wide = engine.run_batch(g, src32, mode="fused", device=dev)
    if LAUNCHES["fused_fixed_point"] != before + BATCH_K_WIDE:
        raise AssertionError("the K = 32 batch was not a fused launch a "
                             "row")
    before = dict(LAUNCHES)
    wide_stepped = engine.run_batch(g, src32, mode="stepped", device=dev)
    launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    if {k: v for k, v in launched.items() if v} != {
            "wd_relax_lanes_batch": wide_stepped.iterations}:
        raise AssertionError(f"K = 32 stepped batch launched {launched}")
    if not same_run(wide, wide_stepped):
        raise AssertionError("K = 32 batch: fused != stepped")
    picks = [0, 7, 19, 31]
    if not np.array_equal(wide.dist[picks],
                          dijkstra_rows(g, src32[picks], True)):
        raise AssertionError("K = 32 batch != Dijkstra")
    emit("batch_wide", graph=name, rows=BATCH_K_WIDE,
         iterations=wide.iterations, edges_relaxed=wide.edges_relaxed,
         stepped_launches=launched["wd_relax_lanes_batch"],
         equals_stepped=True, rows_equal_to_dijkstra=picks)

    # B1's batch contract against its plain version and the row-by-row
    # oracle, and timed
    kept = batch_calls(g, dev, src8)
    if len(kept) != runs[("sssp", "stepped")].iterations:
        raise AssertionError(f"kept {len(kept)} B1 batch launches")
    cases, err = b1_batch_check(g, dev, kept,
                                batch_calls(g, dev, src32, True)[0])
    widest = max(kept, key=lambda c: c["max_lanes"])
    row = dict(name="wd_relax_lanes_batch", route="cuda", source=CSRC,
               replaces=B1_BATCH_REPLACES, vmap_of=B1_BATCH_VMAP,
               launches=launches["wd_relax_lanes_batch"], max_abs_err=err,
               library_ms=None, cases=cases, **b1_batch_time(g, widest))
    emit("b1_batch_time", **row)
    del kept, widest

    # the fused batch against its plain loop on the same card tensors
    small = rmat_graph(scale=small_scale, edge_factor=8, weighted=True,
                       seed=1, device=dev)
    cases = [(small, name_, batch_sources(small, BATCH_K))
             for name_ in OP_NAMES] + [(g, "shortest_path", src8)]
    ferr = 0
    for graph, opname, sources in cases:
        op = operators.OPERATORS[opname]
        dist, mask = multi_source.init_batch(
            graph.num_nodes, torch.from_numpy(sources).to(dev), op=op)
        kw = dict(op=op, max_iterations=6 if opname == "reach_count"
                  else 100000)
        t0 = time.perf_counter()
        got = fused_kernel.batch_fixed_point(graph, dist, mask,
                                             sched=DEFAULT_SCHEDULE, **kw)
        t1 = time.perf_counter()
        want = fused._batch_fixed_point_plain(graph, dist, mask, **kw)
        t2 = time.perf_counter()
        gname = f"rmat{graph.num_nodes.bit_length() - 1}"
        if got[1:] != want[1:] or not torch.equal(got[0], want[0]):
            raise AssertionError(f"fused batch != plain: {gname} {opname}: "
                                 f"{got[1:]} vs {want[1:]}")
        ferr = max(ferr, max_abs_err([got[0]], [want[0]]))
        emit("fused_batch_vs_plain", graph=gname, op=opname,
             rows=len(sources), iterations=got[1], edges_relaxed=got[2],
             equal=True, kernel_seconds=t1 - t0, plain_seconds=t2 - t1)
    f8 = runs[("sssp", "fused")]
    # the least bytes of the batch: each row's sssp-WD traversal
    # (``fused_phase``'s count), from the stepped batch's per-iteration
    # frontier widths (an upper bound of the rows' summed frontiers is not
    # taken: each row's own run is)
    single = single_runs(g, src8, dev, "stepped")
    bound_ms, bound_by = bound(sum(run_bytes(g, r) for r in single), 0)
    fused_row["at_batch"] = dict(
        graph=name, rows=BATCH_K, run="sssp-WD batch",
        launches=launches["fused_fixed_point"], max_abs_err=ferr,
        ms=time_ms(lambda: fused_kernel.batch_fixed_point(
            g, dist, mask, sched=DEFAULT_SCHEDULE, **kw)),
        plain_ms=time_ms(lambda: fused._batch_fixed_point_plain(
            g, dist, mask, **kw), reps=3),
        bound_ms=bound_ms, bound_by=bound_by, iterations=f8.iterations,
        edges_relaxed=f8.edges_relaxed)
    fused_row["batch_launches"] = launches["fused_fixed_point"]
    emit("fused_batch_time", **fused_row["at_batch"])

    # interleaved timings: wall seconds of each whole call, host included
    def batch(mode, sources):
        return lambda: engine.run_batch(g, sources, mode=mode, device=dev)

    def singles(mode):
        return lambda: single_runs(g, src8, dev, mode)
    timed = {"fused_batch8": (batch("fused", src8), BATCH_K,
                              f8.edges_relaxed),
             "fused_single8": (singles("fused"), BATCH_K, f8.edges_relaxed),
             "stepped_batch8": (batch("stepped", src8), BATCH_K,
                                f8.edges_relaxed),
             "stepped_single8": (singles("stepped"), BATCH_K,
                                 f8.edges_relaxed),
             "fused_batch32": (batch("fused", src32), BATCH_K_WIDE,
                               wide.edges_relaxed),
             "stepped_batch32": (batch("stepped", src32), BATCH_K_WIDE,
                                 wide.edges_relaxed)}
    times = {key: [] for key in timed}
    for key, (fn, _, _) in timed.items():                 # warm-up
        fn()
    for i in range(rounds):
        keys = list(timed) if i % 2 == 0 else list(timed)[::-1]
        for key in keys:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            timed[key][0]()
            torch.cuda.synchronize()
            times[key].append(time.perf_counter() - t0)
    med = {key: statistics.median(t) for key, t in times.items()}
    for key, (_, k, edges) in timed.items():
        emit("batch_timing", graph=name, run=key, rounds=rounds,
             ms=[t * 1e3 for t in times[key]], median_ms=med[key] * 1e3,
             spread=(max(times[key]) - min(times[key])) / med[key],
             queries=k, edges_relaxed=edges,
             mteps=edges / med[key] / 1e6,
             queries_per_second=k / med[key])
    emit("batch_speedup", graph=name,
         fused_batch8_over_single8=med["fused_batch8"] / med["fused_single8"],
         stepped_batch8_over_single8=(med["stepped_batch8"]
                                      / med["stepped_single8"]))

    # one whole trace of a fused batch: a fused launch a row, the same rows
    traced, acts, ours, wall, launched, seen = traced_call(
        lambda: engine.run_batch(g, src8, mode="fused", device=dev),
        "fused_fixed_point_kernel", "fused_fixed_point")
    if launched != {"fused_fixed_point": BATCH_K}:
        raise AssertionError(f"traced fused batch launched {launched}, not "
                             f"{BATCH_K} fused kernels")
    if not same_run(traced, runs[("sssp", "fused")]):
        raise AssertionError("traced fused batch != the untraced one")
    busy = sum(e.device_time for e in acts) / 1e6
    by_name: dict = {}
    for e in acts:
        by_name[e.name[:50]] = by_name.get(e.name[:50], 0) + e.device_time
    emit("fused_batch_trace", graph=name, rows=BATCH_K,
         activities=len(acts), fused_launches=len(ours),
         device_ms_by_name={k: v / 1e3 for k, v in by_name.items()},
         traced_wall_seconds=wall, device_seconds=busy,
         kernel_seconds=sum(e.device_time for e in ours) / 1e6,
         device_idle_share=1.0 - busy / wall, trace_attempts=len(seen),
         fused_records_by_attempt=seen)
    return row


#: the example's traffic (examples/serve_graph_queries.py) at fig12's K
SERVE_QUERIES = 64
SERVE_MAX_BATCH = 8


def graph_serve_phase(g, dev) -> None:
    """``GraphServer(mode="fused", max_batch=8)`` with ``g`` (rmat20)
    resident, driven through ``repro_torch.launch.serve_graph.serve``
    with the example's traffic: 64 sssp queries drawn with seed 0 from
    the 10% highest-degree nodes, bursts of 4, a 30 s deadline, 2 warmed
    landmarks, the system clock.  The server steps after every burst, so
    the served batches are at most 4 wide.  The launch counts are set to
    0 just before and read just after: one fused launch a dispatched lane
    (``stats()["lanes_dispatched"]``: the rows of the batches, padding
    included) and no B1/B2.  Every ``ok`` row equals its source's
    single-source fused run, and four equal Dijkstra.  Prints ``stats()``
    and the queries a second over the submit-to-drain window."""
    import numpy as np
    from repro_torch.kernels.relax import LAUNCHES
    from repro_torch.launch import serve_graph

    zero_counts()
    t0 = time.perf_counter()
    srv, done = serve_graph.serve(
        g, "rmat20", queries=SERVE_QUERIES, max_batch=SERVE_MAX_BATCH,
        burst=4, deadline=30.0, landmarks=2, seed=0, device=dev)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    stats = srv.stats()
    if ({k: v for k, v in launches.items() if v}
            != {"fused_fixed_point": stats["lanes_dispatched"]}):
        raise AssertionError(f"served {stats['lanes_dispatched']} lanes "
                             f"with launches {launches}")
    ok = [r for r in done if r.ok]
    # the submit-to-drain window on the server's clock: the landmarks'
    # warm-up batch before the first submission is set-up
    window = (max(r.finish_time for r in done)
              - min(r.request.submit_time for r in done))
    if len(done) != SERVE_QUERIES or not ok:
        raise AssertionError(f"{len(done)} responses, {len(ok)} ok")
    by_source = {}
    for r in ok:
        by_source.setdefault(r.request.source, []).append(r.dist)
    single = dict(zip(by_source, single_runs(g, list(by_source), dev,
                                             "fused")))
    for s, rows in by_source.items():
        if not all(np.array_equal(d, single[s].dist) for d in rows):
            raise AssertionError(f"served row of {s} != its fused run")
    picks = list(by_source)[:4]
    if not np.array_equal(np.stack([by_source[s][0] for s in picks]),
                          dijkstra_rows(g, picks, True)):
        raise AssertionError("served rows != Dijkstra")
    emit("graph_serve", graph="rmat20", queries=SERVE_QUERIES,
         max_batch=SERVE_MAX_BATCH, ok=len(ok),
         rejected=len(done) - len(ok), distinct_sources=len(by_source),
         launches=launches, wall_seconds=wall, window_seconds=window,
         queries_per_second=len(ok) / window,
         latency_p50_ms=stats["latency_p50"] * 1e3,
         latency_p99_ms=stats["latency_p99"] * 1e3,
         batches=stats["batches"], batch_occupancy=stats["batch_occupancy"],
         result_cache_hits=stats.get("result_cache_hits", 0),
         exec_cache_hits=stats.get("exec_cache_hits", 0),
         deadline_misses=stats.get("deadline_misses", 0),
         rows_equal_single_runs=True, rows_equal_to_dijkstra=len(picks),
         stats=stats)


# ---------------------------------------------------------------------------
# phase 4d: AD's measured cost model (A9) and delta-stepping (A10)
# ---------------------------------------------------------------------------

#: interleaved rounds of the cost-model and delta timings
A9_A10_ROUNDS = 3
#: the road network of the delta phase: road_grid_graph(side=1024,
#: weighted=True, seed=4), rmat20's node count, weights 1..100
ROAD_SIDE = 1024
#: the explicit bucket width that makes about three quarters of the road's
#: edges heavy
ROAD_DELTA = 25
DELTA_STRATEGIES = ("BS", "WD", "NS", "HP", "AD")


def interleaved(runs: dict, rounds: int) -> dict:
    """Each of ``runs`` (name -> a call returning a ``RunResult``) once a
    round, in turns (the order reversed every other round); returns name
    -> (traversal seconds of each round, the last result)."""
    out = {name: ([], None) for name in runs}
    names = list(runs)
    for i in range(rounds):
        for name in (names if i % 2 == 0 else names[::-1]):
            r = runs[name]()
            out[name][0].append(r.traversal_seconds)
            out[name] = (out[name][0], r)
    return out


def emit_timings(phase: str, graph: str, timed: dict, **extra) -> None:
    for name, (secs, r) in timed.items():
        med = statistics.median(secs)
        emit(phase, graph=graph, run=name, rounds=len(secs),
             ms=[t * 1e3 for t in secs], median_ms=med * 1e3,
             spread=(max(secs) - min(secs)) / med,
             iterations=r.iterations, relax_rounds=r.relax_rounds,
             edges_relaxed=r.edges_relaxed, mteps=r.edges_relaxed / med / 1e6,
             **extra)


def costmodel_phase(g, dev, fused_row, rounds: int = A9_A10_ROUNDS) -> None:
    """AD's measured cost model on ``g`` (rmat20).  Calibrates on the card
    (one fused launch a timed step, CUDA events): a first call is a cache
    miss and a second a hit with the same coefficients; prints them, the
    calibration's rows and times, and the block feasibility of the port's
    block shapes (each must be feasible).  The launch counts are set to 0
    just before measured AD sssp runs stepped (``online=False``) and
    fused and read just after; both equal Dijkstra and each other, with
    equal ``kernel_counts``, equal to ``choose`` replayed from the stepped
    run's ``IterStats``.  Then fused measured AD, fixed-tree AD and WD
    interleaved (median of ``rounds``)."""
    import tempfile
    from collections import Counter

    import numpy as np
    from repro_torch.core import costmodel, engine
    from repro_torch.core.strategies import make_strategy
    from repro_torch.kernels import _build
    from repro_torch.kernels.relax import LAUNCHES

    source = int(g.degrees.argmax())
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as cache:
        t0 = time.perf_counter()
        model, hit = costmodel.calibrate(g, device=dev, cache_dir=cache)
        t1 = time.perf_counter()
        again, hit2 = costmodel.calibrate(g, device=dev, cache_dir=cache)
        t2 = time.perf_counter()
    if hit or not hit2 or not np.array_equal(model.coeffs, again.coeffs):
        raise AssertionError(f"calibration cache: {hit}, {hit2}")
    rows, times = costmodel.measure(g, device=dev)
    emit("costmodel_calibration", graph="rmat20",
         kernels=list(costmodel.KERNELS), coeffs=model.coeffs.tolist(),
         calibrate_seconds=t1 - t0, cache_hit_seconds=t2 - t1,
         rows=rows.tolist(), step_ms=(times * 1e3).tolist(),
         signature=model.calibrated_on)
    feas = costmodel.block_feasibility(dev)
    emit("block_feasibility", shapes=feas)
    if not all(row["feasible"] for row in feas.values()):
        raise AssertionError(f"infeasible block shape: {feas}")

    oracle = dijkstra_oracle(g, source, weighted=True)
    zero_counts()
    stepped_ad = make_strategy("AD", cost_model=model, online=False)
    rs = engine.run(g, source, stepped_ad, device=dev)
    stepped_launches = dict(LAUNCHES)
    zero_counts()
    fused_ad = make_strategy("AD", cost_model=model)
    rf = engine.run(g, source, fused_ad, mode="fused", device=dev)
    fused_launches = dict(LAUNCHES)
    replay = dict(Counter(model.choose(st.frontier_size, st.edges_processed)
                          for st in rs.iter_stats))
    if not (np.array_equal(rs.dist, oracle) and same_run(rs, rf)):
        raise AssertionError("measured AD != Dijkstra or stepped != fused")
    if not (stepped_ad.kernel_counts == fused_ad.kernel_counts == replay):
        raise AssertionError(f"measured AD chose {stepped_ad.kernel_counts} "
                             f"stepped, {fused_ad.kernel_counts} fused, "
                             f"replay {replay}")
    if ({k: v for k, v in fused_launches.items() if v}
            != {"fused_fixed_point": 1} or stepped_launches[
                "fused_fixed_point"]):
        raise AssertionError(f"measured AD launched {stepped_launches} "
                             f"stepped, {fused_launches} fused")
    fused_row["measured_ad_launches"] = fused_launches["fused_fixed_point"]
    emit("measured_ad", graph="rmat20", source=source,
         iterations=rs.iterations, edges_relaxed=rs.edges_relaxed,
         kernel_counts=stepped_ad.kernel_counts,
         stepped_launches=stepped_launches, fused_launches=fused_launches,
         equals_oracle=True, stepped_equals_fused=True,
         equals_choose_replay=True)

    def fused_run(strategy, **kw):
        return lambda: engine.run(g, source, make_strategy(strategy, **kw),
                                  mode="fused", device=dev)
    timed = interleaved({"AD-measured": fused_run("AD", cost_model=model),
                         "AD-tree": fused_run("AD"), "WD": fused_run("WD")},
                        rounds)
    emit_timings("measured_ad_time", "rmat20", timed)


def delta_phase(g, dev, fused_row, *, cpu_side: int = 256,
                rounds: int = A9_A10_ROUNDS) -> None:
    """Delta-stepping on the card.  road1024 (``ROAD_SIDE``) from its node
    of highest degree, at the auto Δ (every edge light) and at Δ =
    ``ROAD_DELTA``: sssp with each of BS, WD, NS, HP and AD, stepped (one
    launch of the fused kernel's delta mode an epoch) and fused (one a
    traversal), plus bfs and widest path with WD; each equal to scipy's
    Dijkstra or ``reference_widest``, stepped equal to fused (values,
    epochs, rounds, edges, and the rounds run on the grid and in one
    block), the stepped buckets strictly increasing; and rmat20 (``g``)
    sssp WD alike.  The launch counts are set to 0 just
    before these runs and read just after: only fused launches, one an
    epoch stepped and one a traversal fused (the kernel line's fused row
    gets them as ``delta_launches``).  Then a K = 8 fused delta batch on
    road1024 (fig12's rule) equal to its eight single runs; the delta
    kernel against its plain loop on the CPU at road side ``cpu_side``;
    a few delta requests through ``GraphServer``; the delta kernel timed
    on road1024 beside its plain loop on the card and its two bounds; and
    delta against BSP interleaved (epochs, rounds, ms)."""
    import numpy as np
    import torch
    from repro_torch.algos import reference_widest
    from repro_torch.core import engine, priority
    from repro_torch.core.graph import INF
    from repro_torch.core.strategies import make_strategy
    from repro_torch.data import road_grid_graph
    from repro_torch.kernels import fused as fused_kernel
    from repro_torch.kernels.relax import LAUNCHES
    from repro_torch.serve import GraphServer, Request

    road = road_grid_graph(side=ROAD_SIDE, weighted=True, seed=4, device=dev)
    src = int(road.degrees.argmax())
    heavy = int((road.wt > ROAD_DELTA).sum())
    emit("graph", name=f"road{ROAD_SIDE}", nodes=road.num_nodes,
         edges=road.num_edges, max_degree=road.max_degree, source=src,
         auto_delta=priority.auto_delta(road),
         heavy_edges_at_delta=heavy, delta=ROAD_DELTA)
    oracle = {"sssp": dijkstra_oracle(road, src, weighted=True),
              "bfs": dijkstra_oracle(road, src, weighted=False),
              "widest": reference_widest(road, src)}
    rmat_src = int(g.degrees.argmax())
    rmat_oracle = dijkstra_oracle(g, rmat_src, weighted=True)
    runs = [(road, src, "sssp", s, d) for d in (None, ROAD_DELTA)
            for s in DELTA_STRATEGIES]
    runs += [(road, src, "bfs", "WD", None), (road, src, "widest", "WD",
                                              None),
             (g, rmat_src, "sssp", "WD", None)]

    def run(graph, source, algo, strategy, delta, mode):
        op = "widest_path" if algo == "widest" else "shortest_path"
        gr = graph.unweighted() if algo == "bfs" else graph
        return engine.run(gr, source, make_strategy(strategy), op=op,
                          mode=mode, schedule="delta", delta=delta,
                          device=dev)

    zero_counts()
    expected, results = 0, {}
    paired = [(graph, source, algo, strategy, delta,
               run(graph, source, algo, strategy, delta, "stepped"),
               run(graph, source, algo, strategy, delta, "fused"))
              for graph, source, algo, strategy, delta in runs]
    for graph, source, algo, strategy, delta, st, fu in paired:
        expected += st.iterations + 1
        want = rmat_oracle if graph is g else oracle[algo]
        buckets = [s.bucket for s in st.iter_stats]
        gname = "rmat20" if graph is g else f"road{ROAD_SIDE}"
        if not np.array_equal(st.dist, want):
            raise AssertionError(f"delta {gname} {algo}-{strategy} "
                                 f"delta={delta} != oracle")
        if not (same_run(st, fu) and st.relax_rounds == fu.relax_rounds
                and st.delta == fu.delta):
            raise AssertionError(f"delta {gname} {algo}-{strategy}: "
                                 f"stepped != fused")
        if any(b <= a for a, b in zip(buckets, buckets[1:])):
            raise AssertionError(f"delta {gname} {algo}-{strategy}: "
                                 f"buckets {buckets[:20]}...")
        # a round runs in one block or on the grid by its own frontier,
        # whichever launch it falls in
        split = fu.round_split
        if (st.round_split != split
                or split.grid + split.narrow != fu.relax_rounds):
            raise AssertionError(f"delta {gname} {algo}-{strategy}: rounds "
                                 f"{split} fused, {st.round_split} "
                                 f"stepped")
        results[(gname, algo, strategy, delta)] = fu
        emit("delta_run", graph=gname, algo=algo, strategy=strategy,
             delta=st.delta, epochs=st.iterations,
             relax_rounds=st.relax_rounds, grid_rounds=split.grid,
             narrow_rounds=split.narrow, barriers=split.barriers,
             edges_relaxed=st.edges_relaxed,
             stepped_seconds=st.traversal_seconds,
             fused_seconds=fu.traversal_seconds, first_buckets=buckets[:4],
             last_bucket=buckets[-1], equals_oracle=True,
             stepped_equals_fused=True)
    launches = dict(LAUNCHES)
    emit("delta_launches", launches=launches, expected=expected)
    if {k: v for k, v in launches.items() if v} != {
            "fused_fixed_point": expected}:
        raise AssertionError(f"delta runs launched {launches}, expected "
                             f"{expected} fused launches")
    fused_row["delta_launches"] = launches["fused_fixed_point"]

    # K = 8 delta batch: one single-row launch a row, equal to single runs
    sources = batch_sources(road, BATCH_K)
    zero_counts()
    batch = engine.run_batch(road, sources, mode="fused", schedule="delta",
                             device=dev)
    batch_launches = LAUNCHES["fused_fixed_point"]
    singles = [engine.run(road, int(s), make_strategy("WD"), mode="fused",
                          schedule="delta", device=dev) for s in sources]
    if not (all(np.array_equal(row, r.dist)
                for row, r in zip(batch.dist, singles))
            and batch.iterations == max(r.iterations for r in singles)
            and batch.relax_rounds == max(r.relax_rounds for r in singles)
            and batch.edges_relaxed == sum(r.edges_relaxed
                                           for r in singles)
            and batch_launches == BATCH_K):
        raise AssertionError("delta batch != its single runs")
    emit("delta_batch", graph=f"road{ROAD_SIDE}", k=BATCH_K,
         sources=[int(s) for s in sources], epochs=batch.iterations,
         relax_rounds=batch.relax_rounds, edges_relaxed=batch.edges_relaxed,
         launches=batch_launches, seconds=batch.total_seconds,
         equals_single_runs=True)

    # the delta kernel against its plain loop on the CPU
    small = road_grid_graph(side=cpu_side, weighted=True, seed=4,
                            device="cpu")
    s0 = int(small.degrees.argmax())
    for strategy, delta in (("WD", None), ("WD", ROAD_DELTA),
                            ("NS", ROAD_DELTA)):
        strat = make_strategy(strategy)
        plan = priority.plan_delta(strat, strat.setup(small), small,
                                   delta=delta)
        n = plan.light.num_nodes
        dist = torch.full((n,), INF, dtype=torch.int32)
        dist[s0] = 0
        mask = torch.zeros(n, dtype=torch.bool)
        mask[s0] = True
        args = (plan.kernel, plan.light, plan.heavy_graph, plan.aux, dist,
                mask)
        kw = dict(op=_op("shortest_path"), sched=plan.sched,
                  delta=plan.delta, max_iterations=100000)
        t0 = time.perf_counter()
        got = fused_kernel.delta_fixed_point(
            *(a if a is None or isinstance(a, str) else a.to(dev)
              for a in args), **kw)
        t1 = time.perf_counter()
        want = priority._delta_fixed_point_plain(*args, **kw)
        t2 = time.perf_counter()
        if not (torch.equal(got[0].cpu(), want[0])
                and torch.equal(got[1].cpu(), want[1])
                and got[2:] == want[2:]):
            raise AssertionError(f"delta kernel != CPU plain loop: road"
                                 f"{cpu_side} {strategy} delta={delta}: "
                                 f"{got[2:]} vs {want[2:]}")
        emit("delta_vs_cpu", graph=f"road{cpu_side}", strategy=strategy,
             delta=plan.delta, epochs=got[2], relax_rounds=got[3],
             edges_relaxed=got[4], equal=True, kernel_seconds=t1 - t0,
             cpu_plain_seconds=t2 - t1)

    # delta requests through the graph server
    srv = GraphServer(mode="fused", max_batch=4, device=dev)
    srv.load_graph(f"road{ROAD_SIDE}", road)
    reqs = [(int(s), None) for s in sources[:5]] + [
        (int(s), ROAD_DELTA) for s in sources[5:]]
    zero_counts()
    for s, d in reqs:
        srv.submit(Request(source=s, graph=f"road{ROAD_SIDE}",
                           schedule="delta", delta=d))
    done = srv.drain()
    served_launches = LAUNCHES["fused_fixed_point"]
    stats = srv.stats()
    for r in done:            # the distances do not depend on the width
        want = singles[list(sources).index(r.request.source)].dist
        if not (r.ok and np.array_equal(r.dist, want)):
            raise AssertionError(f"served delta row of {r.request.source}")
    # one single-row launch a dispatched lane (padding lanes included)
    if len(done) != len(reqs) or served_launches != stats[
            "lanes_dispatched"]:
        raise AssertionError(f"served {len(done)} rows with "
                             f"{served_launches} launches: {stats}")
    emit("delta_serve", graph=f"road{ROAD_SIDE}", requests=len(reqs),
         ok=sum(r.ok for r in done), batches=stats["batches"],
         launches=served_launches, rows_equal_single_runs=True,
         latency_p50_ms=stats["latency_p50"] * 1e3)

    # the delta kernel on road1024 beside its plain loop on the card
    strat = make_strategy("WD")
    plan = priority.plan_delta(strat, strat.setup(road), road)
    dist = torch.full((road.num_nodes,), INF, dtype=torch.int32,
                      device=dev)
    dist[src] = 0
    mask = torch.zeros(road.num_nodes, dtype=torch.bool, device=dev)
    mask[src] = True
    args = (plan.kernel, plan.light, plan.heavy_graph, plan.aux, dist, mask)
    kw = dict(op=_op("shortest_path"), sched=plan.sched, delta=plan.delta,
              max_iterations=100000)
    got = fused_kernel.delta_fixed_point(*args, **kw)
    ms = time_ms(lambda: fused_kernel.delta_fixed_point(*args, **kw),
                 reps=3)
    t0 = time.perf_counter()
    want = priority._delta_fixed_point_plain(*args, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    # (dist, mask, epochs, rounds, edges, bucket, count) and the rounds
    # by kind
    if not (torch.equal(got[0], want[0]) and got[2:] == want[2:]):
        raise AssertionError("delta kernel != plain loop on road1024")
    # the least bytes: col, wt and dist[dst] of each relaxed edge and 12 B
    # a frontier node a round (its id, degree and first edge), a
    # worklist's least; and, so that the rows compare with the kernels
    # that passed over N each round, the edges and the frontier mask each
    # round (N bytes)
    edges, n_rounds, split = got[4], got[3], got[7]
    bound_ms, bound_by = bound(12 * edges + 12 * want[7].nodes, 0)
    dense_ms, _ = bound(12 * edges + road.num_nodes * n_rounds, 0)
    fused_row["at_delta"] = dict(
        graph=f"road{ROAD_SIDE}", run="sssp-WD delta", delta=plan.delta,
        epochs=got[2], relax_rounds=n_rounds, grid_rounds=split.grid,
        narrow_rounds=split.narrow, barriers=split.barriers,
        frontier_nodes=want[7].nodes, edges_relaxed=edges, ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        dense_bound_ms=dense_ms,
        max_abs_err=max_abs_err([got[0]], [want[0]]))
    emit("delta_kernel_time", **fused_row["at_delta"])

    # delta against BSP on road1024, interleaved
    def bsp(mode):
        return lambda: engine.run(road, src, make_strategy("WD"), mode=mode,
                                  device=dev)

    def delta_run(mode, delta):
        return lambda: engine.run(road, src, make_strategy("WD"), mode=mode,
                                  schedule="delta", delta=delta, device=dev)
    timed = interleaved({"bsp-fused": bsp("fused"),
                         "delta-fused": delta_run("fused", None),
                         f"delta{ROAD_DELTA}-fused": delta_run("fused",
                                                                ROAD_DELTA),
                         "bsp-stepped": bsp("stepped"),
                         "delta-stepped": delta_run("stepped", None)},
                        rounds)
    emit_timings("delta_vs_bsp", f"road{ROAD_SIDE}", timed, strategy="WD")


# ---------------------------------------------------------------------------
# phase 4f: sharding (A11): the node partition, lockstep and async shards,
# sharded batches and distributed_sssp, in one process and in two ranks
# ---------------------------------------------------------------------------

#: the rmat20 sharded runs: (strategy, shards, partition method)
SHARD_RUNS = (("WD", 2, "degree"), ("WD", 4, "degree"),
              ("WD", 4, "contiguous"), ("HP", 2, "degree"),
              ("HP", 4, "degree"), ("BS", 2, "degree"),
              ("NS", 2, "degree"))
#: the async runs: (strategy, shards)
SHARD_ASYNC = (("WD", 4), ("HP", 4))
#: interleaved rounds of the WD and HP timings (BS and NS run once: their
#: host-driven column loops take seconds)
SHARD_ROUNDS = 3
#: the kernel rows the sharded path launches
SHARD_KERNELS = ("wd_relax_lanes", "relax_lanes", "find_offsets")


@contextlib.contextmanager
def fold_recorder(trace: bool = False):
    """Wrap ``ShardGroup.fold`` for the runs inside: yields a list that
    gets, for each fold, its held proposals and the pair of CUDA events
    around it; with ``trace``, each fold also lies in a ``shard_fold``
    profiler range."""
    import torch
    from repro_torch.core import shard
    real = shard.ShardGroup.fold
    folds = []

    def fold(self, op, proposals):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with (torch.profiler.record_function("shard_fold") if trace
              else contextlib.nullcontext()):
            start.record()
            out = real(self, op, proposals)
            end.record()
        folds.append((len(proposals), start, end))
        return out

    shard.ShardGroup.fold = fold
    try:
        yield folds
    finally:
        shard.ShardGroup.fold = real


def fold_ms(folds) -> float:
    """The summed CUDA-event spans of ``fold_recorder``'s folds."""
    import torch
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for _, start, end in folds)


def shard_fold_trace(g, source: int, dev, shards: int = 2) -> dict:
    """One sharded sssp WD run under ``torch.profiler``: the device time
    of the kernels launched inside its folds (``shard_fold`` ranges),
    beside the same run's fold event spans, all device activity and the
    traversal."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.algos import sssp
    sssp(g, source, strategy="WD", mode="fused", shards=shards, device=dev)
    torch.cuda.synchronize()
    with fold_recorder(trace=True) as folds, profile(
            activities=[ProfilerActivity.CPU,
                        ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r = sssp(g, source, strategy="WD", mode="fused", shards=shards,
                 device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ranges = [e for e in events
              if e.name == "shard_fold" and e.device_type == cpu]
    acts = [e for e in events
            if e.device_type == cuda and e.name != "shard_fold"]
    fold_device_ms = sum(e.device_time_total for e in ranges) / 1e3
    busy_ms = sum(e.device_time for e in acts) / 1e3
    out = dict(strategy="WD", shards=shards, folds=len(folds),
               fold_ranges=len(ranges),
               fold_device_ms=fold_device_ms if fold_device_ms > 0 else None,
               fold_event_ms=fold_ms(folds), device_busy_ms=busy_ms,
               traversal_ms=r.traversal_seconds * 1e3,
               traced_wall_ms=wall * 1e3,
               fold_device_share_of_busy=(fold_device_ms / busy_ms
                                          if busy_ms else None),
               device_idle_share=1.0 - busy_ms / (wall * 1e3))
    if not fold_device_ms:
        out["note"] = ("the trace attributed no device time to the folds: "
                       "not measured")
    return out


def layered_dag(layers: int, width: int, degree: int, dev, seed: int = 5):
    """A DAG of ``layers`` layers of ``width`` nodes, each node with
    ``degree`` edges into the next layer: reach_count's convergence
    domain (it settles after ``layers`` iterations)."""
    import numpy as np
    from repro_torch.core.graph import CSRGraph
    rng = np.random.default_rng(seed)
    n = layers * width
    src = np.repeat(np.arange((layers - 1) * width), degree)
    dst = (src // width + 1) * width + rng.integers(0, width, src.size)
    return CSRGraph.from_edges(src, dst, None, n, device=dev)


def _shard_rank(rank: int, store: str, backend: str, scale: int,
                out: str) -> None:
    """One rank of the two-rank run: rmat-``scale`` sssp WD and BS with
    one shard a rank, from a graph on the host; writes ``(dist,
    iterations, edges)``, the bytes of the shard it holds on the card,
    the graph's and its peak allocation to ``out``."""
    import datetime
    import numpy as np
    import torch
    import torch.distributed as tdist
    sys.path.insert(0, str(SRC))
    from repro_torch.algos import sssp
    from repro_torch.core import shard
    from repro_torch.core.strategies import make_strategy
    from repro_torch.data import rmat_graph
    torch.cuda.set_device(rank if backend == "nccl" else 0)
    tdist.init_process_group(backend, init_method=f"file://{store}",
                             rank=rank, world_size=2,
                             timeout=datetime.timedelta(seconds=60))
    try:
        g = rmat_graph(scale=scale, edge_factor=8, weighted=True, seed=1,
                       device="cpu")
        src = int(g.degrees.argmax())
        res = {}
        for strategy in ("WD", "BS"):
            r = sssp(g, src, strategy=strategy, mode="fused", shards=2,
                     device="cuda")
            res[strategy] = r.dist
            res[strategy + "_counts"] = np.array([r.iterations,
                                                  r.edges_relaxed])
        wd = make_strategy("WD")
        splan = shard.plan_shards(wd, wd.setup(g), g, 2,
                                  group=shard.shard_group(2, "cuda"))
        res["bytes"] = np.array([
            sum(t.untyped_storage().nbytes() for sh in splan.local
                for t in (sh.row_ptr, sh.col, sh.wt) if t.is_cuda),
            sum(t.numel() * t.element_size()
                for t in (g.row_ptr, g.col, g.wt)),
            torch.cuda.max_memory_allocated()])
        np.savez(f"{out}/rank{rank}.npz", **res)
    finally:
        tdist.destroy_process_group()


def two_ranks(dev, *, scale: int) -> dict:
    """sssp WD and BS at rmat-``scale`` with two ranks, one shard each
    (NCCL on two cards, else gloo over CUDA tensors, both ranks on card
    0), each rank equal to the one-process run of two shards."""
    import tempfile
    import numpy as np
    import torch
    import torch.multiprocessing as mp
    from repro_torch.algos import sssp
    from repro_torch.data import rmat_graph
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    g = rmat_graph(scale=scale, edge_factor=8, weighted=True, seed=1,
                   device=dev)
    src = int(g.degrees.argmax())
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.spawn(_shard_rank, args=(f"{tmp}/store", backend, scale, tmp),
                 nprocs=2, join=True)
        seconds = time.perf_counter() - t0
        ranks = [dict(np.load(f"{tmp}/rank{r}.npz")) for r in range(2)]
    for strategy in ("WD", "BS"):
        one = sssp(g, src, strategy=strategy, mode="fused", shards=2,
                   device=dev)
        for r, got in enumerate(ranks):
            if (not np.array_equal(got[strategy], one.dist)
                    or got[strategy + "_counts"].tolist() != [
                        one.iterations, one.edges_relaxed]):
                raise AssertionError(f"rank {r} {strategy} != one process")
    held, graph_bytes, peak = zip(*(got["bytes"].tolist() for got in ranks))
    if not all(0 < h < b for h, b in zip(held, graph_bytes)):
        raise AssertionError(f"a rank holds more than its shard: held "
                             f"{held} B of a {graph_bytes} B graph")
    out = dict(backend=backend, ranks=2, graph=f"rmat{scale}",
               strategies=["WD", "BS"], seconds=seconds,
               equals_one_process=True, held_shard_bytes=list(held),
               graph_bytes=graph_bytes[0], peak_allocated_bytes=list(peak))
    emit("shard_ranks", **out)
    return out


def shard_cpu_compare(dev, *, scale: int) -> None:
    """Sharded runs on the card against the same on the CPU and the
    single-device card run: CC (min_label) on the symmetrized
    rmat-``scale``, widest path on rmat-``scale``, reach_count on a
    layered DAG of 2^``scale`` nodes."""
    import numpy as np
    from repro_torch.algos import connected_components, widest_path
    from repro_torch.core import engine
    from repro_torch.core.strategies import make_strategy
    from repro_torch.data import rmat_graph
    g = rmat_graph(scale=scale, edge_factor=8, weighted=True, seed=1,
                   device="cpu")
    src = int(g.degrees.argmax())
    sym = symmetrized(g, "cpu")
    cc_oracle = component_minima(sym)
    dag = layered_dag(16, (1 << scale) // 16, 8, "cpu")
    for shards, method in ((2, "degree"), (3, "contiguous")):
        kw = dict(mode="fused", shards=shards, partition=method)
        cc = [connected_components(sym, strategy="WD", device=d, **kw)
              for d in (dev, "cpu")]
        cc.append(connected_components(sym, strategy="WD", mode="fused",
                                       device=dev))
        wp = [widest_path(g, src, strategy="WD", device=d, **kw)
              for d in (dev, "cpu")]
        wp.append(widest_path(g, src, strategy="WD", mode="fused",
                              device=dev))
        rc = [engine.run(dag, 0, make_strategy(s), op="reach_count",
                         device=d, **kw)
              for s, d in (("BS", dev), ("BS", "cpu"), ("WD", dev))]
        rc.append(engine.run(dag, 0, make_strategy("BS"), op="reach_count",
                             mode="fused", device=dev))
        if not all(np.array_equal(c, cc_oracle) for c in cc):
            raise AssertionError(f"sharded CC at {shards} != scipy")
        for name, runs in (("widest", wp), ("reach_count", rc)):
            if not all(same_run(r, runs[-1]) for r in runs):
                raise AssertionError(f"sharded {name} at {shards}: card, "
                                     f"CPU and one device differ")
        emit("shard_cpu_compare", graph=f"rmat{scale}", shards=shards,
             partition=method, cc_equal_scipy=True,
             widest_iterations=wp[0].iterations,
             reach_count_dag_nodes=dag.num_nodes,
             reach_count_iterations=rc[0].iterations,
             card_equals_cpu_and_one_device=True)


def shard_phase(g, dev, stepped, *, small_scale: int) -> dict:
    """Sharding (ROADMAP A11) on the card, one process holding every
    shard.  The partition's balance and halo at 2, 4 and 8 shards; the
    ``SHARD_RUNS`` sssp traversals of ``g`` (rmat20) from the path
    phase's source, each equal to Dijkstra and to the single-device run
    (``stepped``, which the fused phase held equal to its fused run),
    with B1/B2 launched once a held shard a chunk (S x the run's folds,
    counted by ``fold_recorder``) and no fused launch; async WD and HP; a
    K = 8 sharded batch equal to the single-device batch row by row (a B1
    launch a live row and shard an iteration); ``distributed_sssp`` at 4
    shards equal to Dijkstra (B3 a shard an iteration).  These entry
    calls run once each, between setting the counts to 0 and reading
    them: returns the launches of B1, B2 and B3.  Then the timings, the
    fold trace, rmat-``small_scale`` card against CPU and two ranks.  One
    card shows exactness and what a fold costs; every shard runs on it in
    turn, so no timing here is a multi-GPU speed-up."""
    import numpy as np
    from repro_torch.algos import sssp
    from repro_torch.core import dist as shard_dist
    from repro_torch.core import engine, shard
    from repro_torch.kernels.relax import LAUNCHES

    name = f"rmat{g.num_nodes.bit_length() - 1}"
    source = int(g.degrees.argmax())
    oracle = dijkstra_oracle(g, source, weighted=True)
    smi = nvidia_smi()
    for shards in (2, 4, 8):
        for method in (("degree", "contiguous") if shards == 4
                       else ("degree",)):
            sharded, info = shard.partition(g, shards, method=method)
            emit("shard_info", graph=name, shards=shards, partition=method,
                 cut_share=info.cut_share, halo_bytes=info.halo_bytes,
                 halo_total=info.halo_total,
                 edge_imbalance=info.edge_imbalance,
                 nodes_per_shard=sharded.nodes_per_shard,
                 edges_per_shard=sharded.edges_per_shard,
                 partition_bytes=sharded.device_bytes())
            del sharded
    sources = batch_sources(g, BATCH_K)
    rows = single_runs(g, sources, dev, "fused")
    one = engine.run_batch(g, sources, mode="fused", device=dev)

    # the sharded path's entry calls, each once: the launch counts
    zero_counts()
    with fold_recorder() as folds:
        for strategy, shards, method in SHARD_RUNS:
            s = stepped[("sssp", strategy)]
            before, first = dict(LAUNCHES), len(folds)
            r = sssp(g, source, strategy=strategy, mode="fused",
                     shards=shards, partition=method, device=dev)
            launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
            mine = folds[first:]
            if not np.array_equal(r.dist, oracle) or not same_run(r, s):
                raise AssertionError(f"sharded {strategy} x{shards} "
                                     f"{method} != Dijkstra / one device")
            if r.relax_rounds != r.iterations or r.shards != shards:
                raise AssertionError(f"sharded {strategy}: rounds {r}")
            relaxes = launched["wd_relax_lanes"] + launched["relax_lanes"]
            if (not mine or relaxes != sum(p for p, _, _ in mine)
                    or {p for p, _, _ in mine} != {shards}
                    or launched["fused_fixed_point"]):
                raise AssertionError(f"sharded {strategy} x{shards} "
                                     f"launched {launched}, {len(mine)} "
                                     f"folds")
            traversal_ms = r.traversal_seconds * 1e3
            event_ms = fold_ms(mine)
            emit("shard_run", graph=name, strategy=strategy, shards=shards,
                 partition=method, iterations=r.iterations,
                 edges_relaxed=r.edges_relaxed, state_bytes=r.state_bytes,
                 setup_seconds=r.setup_seconds, traversal_ms=traversal_ms,
                 folds=len(mine),
                 launches={k: v for k, v in launched.items() if v},
                 launches_per_fold=relaxes / len(mine),
                 fold_event_ms=event_ms,
                 fold_event_share=event_ms / traversal_ms,
                 equals_oracle=True, equals_one_device=True)

        for strategy, shards in SHARD_ASYNC:
            first = len(folds)
            r = sssp(g, source, strategy=strategy, mode="fused",
                     shards=shards, async_shards=True, device=dev)
            if (not np.array_equal(r.dist, oracle) or not r.async_shards
                    or len(folds) - first != r.iterations):
                raise AssertionError(f"async {strategy} x{shards} != "
                                     f"Dijkstra")
            emit("shard_async", graph=name, strategy=strategy,
                 shards=shards, epochs=r.iterations,
                 relax_rounds=r.relax_rounds,
                 edges_relaxed=r.edges_relaxed,
                 traversal_ms=r.traversal_seconds * 1e3,
                 fold_event_ms=fold_ms(folds[first:]), equals_oracle=True,
                 lockstep_iterations=stepped[("sssp", strategy)].iterations,
                 lockstep_edges=stepped[("sssp", strategy)].edges_relaxed)

        before = LAUNCHES["wd_relax_lanes"]
        b = engine.run_batch(g, sources, mode="fused", shards=2, device=dev)
        b1 = LAUNCHES["wd_relax_lanes"] - before
        if (not np.array_equal(b.dist, one.dist)
                or (b.iterations, b.edges_relaxed) != (one.iterations,
                                                       one.edges_relaxed)
                or b1 != 2 * sum(r.iterations for r in rows)):
            raise AssertionError(f"sharded batch != one device ({b1} B1)")
        emit("shard_batch", graph=name, k=BATCH_K, shards=2,
             iterations=b.iterations, edges_relaxed=b.edges_relaxed,
             b1_launches=b1, ms=b.total_seconds * 1e3,
             one_device_fused_ms=one.total_seconds * 1e3,
             equals_one_device_rows=True)

        before = LAUNCHES["find_offsets"]
        t0 = time.perf_counter()
        got = shard_dist.distributed_sssp(g, source,
                                          shard.shard_group(4, dev))
        dist_ms = (time.perf_counter() - t0) * 1e3
        b3 = LAUNCHES["find_offsets"] - before
        if not np.array_equal(got, oracle) or b3 == 0 or b3 % 4:
            raise AssertionError(f"distributed_sssp != Dijkstra ({b3} B3)")
        emit("shard_distributed_sssp", graph=name, shards=4,
             b3_launches=b3, iterations=b3 // 4, ms=dist_ms,
             equals_oracle=True)
    launches = {k: LAUNCHES[k] for k in SHARD_KERNELS}
    emit("shard_launches", graph=name, launches=dict(LAUNCHES))
    if not all(launches.values()):
        raise AssertionError(f"the sharded path missed a kernel: {launches}")

    # timings: each sharded traversal beside the single-device fused and
    # stepped runs of the same strategy, interleaved; the folds' event
    # spans and the traversal come from the same run
    for strategy, shards, method in SHARD_RUNS:
        rounds = SHARD_ROUNDS if strategy in ("WD", "HP") else 1
        ms = {"sharded": [], "fused": [], "stepped": [], "fold": []}
        for _ in range(rounds):
            with fold_recorder() as folds:
                ms["sharded"].append(sssp(
                    g, source, strategy=strategy, mode="fused",
                    shards=shards, partition=method,
                    device=dev).traversal_seconds * 1e3)
            ms["fold"].append(fold_ms(folds))
            for mode in ("fused", "stepped"):
                ms[mode].append(sssp(g, source, strategy=strategy,
                                     mode=mode, device=dev)
                                .traversal_seconds * 1e3)
        med = {k: statistics.median(v) for k, v in ms.items()}
        shares = [f / t for f, t in zip(ms["fold"], ms["sharded"])]
        emit("shard_time", graph=name, strategy=strategy, shards=shards,
             partition=method, rounds=rounds, nvidia_smi=smi,
             sharded_ms=ms["sharded"], fold_event_ms=ms["fold"],
             one_device_fused_ms=ms["fused"],
             one_device_stepped_ms=ms["stepped"],
             sharded_median_ms=med["sharded"],
             fold_event_median_ms=med["fold"],
             fold_event_share=statistics.median(shares),
             sharded_over_fused=med["sharded"] / med["fused"],
             sharded_over_stepped=med["sharded"] / med["stepped"],
             note="one card holds every shard: exactness and the fold's "
                  "cost, not a multi-GPU speed-up; a fold's event span "
                  "holds the host's launch of its ops")
    emit("shard_fold_trace", graph=name, nvidia_smi=smi,
         **shard_fold_trace(g, source, dev))

    shard_cpu_compare(dev, scale=small_scale)
    two_ranks(dev, scale=small_scale)
    return launches


def _op(name: str):
    from repro_torch.core import operators
    return operators.OPERATORS[name]


# ---------------------------------------------------------------------------
# phase 4f: user-defined operators on the card (ROADMAP queue C)
# ---------------------------------------------------------------------------

#: the penalty's weight threshold, inside rmat20's weights [1, 100]
CUSTOM_T = 50
#: the strategies each operator runs through, stepped and fused
CUSTOM_STRATEGIES = ("BS", "EP", "WD", "NS", "HP", "AD")
#: interleaved rounds of the fused shortest_path / penalty timing
CUSTOM_TIMING_ROUNDS = 5
#: the kernels each custom library holds, with the TPU kernel each
#: replaces: (name, LAUNCHES key, source, replaces)
CUSTOM_KERNELS = (
    ("relax_lanes", "relax_lanes", CSRC, "src/repro/kernels/relax.py:243"),
    ("wd_relax_lanes", "wd_relax_lanes", CSRC,
     "src/repro/kernels/relax.py:349"),
    ("wd_relax_lanes_batch", "wd_relax_lanes_batch", CSRC,
     "src/repro/core/multi_source.py:111"),
    ("fused_fixed_point", "fused_fixed_point",
     "src/repro_torch/kernels/csrc/fused.cu", "src/repro/core/fused.py:389"))


def penalty_op(threshold: int):
    """SSSP whose edges above ``threshold`` cost double:
    ``where(w > T, v + 2w, v + w)``, weight-additive."""
    import torch
    from repro_torch.core.operators import INF, EdgeOp
    return EdgeOp(name=f"penalty{threshold}", combine="min", identity=INF,
                  source_value=0, weight_additive=True,
                  message=lambda v, w: torch.where(w > threshold, v + 2 * w,
                                                   v + w))


def custom_ops(budget: int, heaviest: int) -> dict:
    """The phase's operators: the reference's slack operator
    (``tests/test_kernels.py``: min, ``v + w``, update ``cand + 2 <
    cur``), the penalty at ``CUSTOM_T``, a budget ``budget`` spent along
    the path (max, identity 0, ``(v - w).clamp(min=0)``), and the penalty
    above the heaviest weight (``heaviest``), which computes SSSP."""
    from repro_torch.core.operators import INF, EdgeOp
    return {
        "slack": EdgeOp(name="slack", combine="min", identity=INF,
                        source_value=0, message=lambda v, w: v + w,
                        update=lambda cand, cur: cand + 2 < cur),
        "penalty": penalty_op(CUSTOM_T),
        "budget": EdgeOp(name="budget", combine="max", identity=0,
                         source_value=budget, value_min=0,
                         message=lambda v, w: (v - w).clamp(min=0)),
        "penalty_off": penalty_op(heaviest),
    }


def penalised(g, threshold: int):
    """``g``'s arrays with every weight above ``threshold`` doubled, for
    ``dijkstra_oracle``."""
    import types
    import torch
    return types.SimpleNamespace(
        row_ptr=g.row_ptr, col=g.col, num_nodes=g.num_nodes,
        num_edges=g.num_edges,
        wt=torch.where(g.wt > threshold, 2 * g.wt, g.wt))


def with_extremes(rng, t, share: float = 0.1):
    """``t`` with ``share`` of its entries set to int32 extremes (INT_MIN,
    INT_MAX, INF, 0, -1)."""
    import numpy as np
    import torch
    from repro_torch.core.graph import INF
    a = t.cpu().numpy().copy()
    at = rng.random(a.size) < share
    a[at] = rng.choice([-2 ** 31, 2 ** 31 - 1, INF, 0, -1], int(at.sum()))
    return torch.from_numpy(a).to(t.device)


def in_domain(op, t):
    """``t`` inside ``op``'s value domain, ``t`` folded with the identity
    (``EdgeOp.fold_values``): a min monoid's values lie at or below its
    identity, a max monoid's at or above (the identity is the unreached
    value; −0.0 lies below a float max's or add's +0.0).  The fold into a
    copy of dist equals the proposal folded by ``apply_proposal`` only
    there: above INF, ``min(dist, INF)`` lowers an untouched entry that
    the fold leaves alone."""
    import torch
    return op.fold_values(t, torch.full_like(t, op.identity))


#: digest of a lowered operator -> the future of its library's build,
#: started beside the base build (``start_prebuilds``)
PREBUILDS: dict = {}
#: builds of operator libraries at once beside the base build
PREBUILD_WORKERS = 4


def start_prebuilds(g):
    """Start the builds of every operator library the custom, float and
    sub-word phases load (``_build.custom_build``: nvcc subprocesses, no
    load), ``PREBUILD_WORKERS`` at a time, while the base library builds;
    each phase then waits for its own and loads them.  Returns the
    pool."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import _build, opgen
    pool = ThreadPoolExecutor(PREBUILD_WORKERS)
    for op in (*custom_ops(0, int(g.wt.max())).values(),
               *float_ops().values(), *subword_ops().values()):
        PREBUILDS[opgen.lower(op).digest] = pool.submit(
            _build.custom_build, op)
    return pool


def custom_builds(ops: dict, line: str = "custom_build") -> dict:
    """Build every operator's library, all at once (one thread an
    operator, each running nvcc on relax.cu and fused.cu); print each
    build's seconds, and each custom instantiation's registers and spill
    bytes (``-Xptxas -v``) and blocks a SM (the occupancy of the
    instantiation the launch uses).  Returns name -> that line."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import _build, opgen
    t0 = time.perf_counter()
    for op in ops.values():     # started beside the base build (main)
        started = PREBUILDS.get(opgen.lower(op).digest)
        if started is not None:
            started.result()
    with ThreadPoolExecutor(len(ops)) as pool:
        libs = dict(zip(ops, pool.map(_build.custom_lib, ops.values())))
    wall = time.perf_counter() - t0
    out = {}
    for name, op in ops.items():
        lowered = opgen.lower(op)
        built = _build.CUSTOM_BUILDS.get(lowered.digest)
        ptxas = ({k: v for k, v in ptxas_summary(built["log"]).items()
                  if f"<{op.kernel_codes()[0]}," in k} if built else {})
        attrs = {}
        for fn, which, kernel in (
                ("repro_relax_block_attrs", 0, "relax_lanes"),
                ("repro_relax_block_attrs", 1, "wd_relax_lanes"),
                ("repro_relax_block_attrs", 2, "wd_relax_union"),
                ("repro_fused_block_attrs", 0, "fused_fixed_point"),
                ("repro_fused_block_attrs", 1, "fused_delta"))[
                    :4 if op.combine == "add" else 5]:    # no add delta
            cells = (ctypes.c_int * _build.ATTR_CELLS)()
            _build.check(fn, getattr(libs[name], fn)(which, cells))
            attrs[kernel] = dict(registers=cells[2], local_bytes=cells[3],
                                 blocks_per_sm=cells[4])
            if cells[4] < 1:
                raise AssertionError(f"{name}: {kernel} cannot be resident "
                                     f"({attrs[kernel]})")
        out[name] = dict(op=op.name, digest=lowered.digest,
                         library=str(_build.custom_library_path(
                             lowered.header).name),
                         seconds=built["seconds"] if built else None,
                         ptxas=ptxas, attrs=attrs)
        emit(line, **out[name], wall_seconds=wall)
    return out


def custom_kernel_checks(g, dev, ops: dict, rng) -> dict:
    """B2, B1 (both contracts each) and B1's batch contract built for each
    operator, against their plain versions on the same card tensors, bit
    for bit: rmat20's node count, values and weights with int32 extremes
    among them (B2: 1,001 and N + 3 lanes; B1: frontiers of N/64 and N/8
    slots; the batch: K = 8 rows of ~N/100 nodes, whole and cut).  The
    proposal contract takes every extreme; the folds into dist take the
    values in the operator's domain (``in_domain``).  Returns (operator,
    kernel) -> max_abs_err; raises on a difference."""
    import torch
    from repro_torch.core import multi_source as ms
    from repro_torch.kernels import relax
    n = g.num_nodes
    err, bad, cases = {}, [], 0

    def check(key, case, got, want):
        nonlocal cases
        e = max_abs_err(got, want)
        err[key] = max(err.get(key, 0), e)
        cases += 1
        if e:
            bad.append((*key, case, e))

    wt = with_extremes(rng, g.wt)
    for name, op in ops.items():
        for lanes in (1001, n + 3):
            b = lane_inputs(rng, n, lanes, dev)
            dist = with_extremes(rng, random_dist(rng, op, n, dev))
            args = (dist, b["src"], b["dst"], with_extremes(rng, b["w"]),
                    b["valid"])
            check((name, "relax_lanes"), lanes, relax.relax_lanes(
                *args, op=op), relax.relax_lanes_plain(*args, op=op))
            mask = torch.from_numpy(rng.random(n) < 0.2).to(dev)
            dist = in_domain(op, dist)
            want = relax.apply_relax_plain(dist, mask.clone(), *args[1:],
                                           op=op)
            check((name, "relax_lanes"), (lanes, "apply"),
                  relax.apply_relax(dist, mask, *args[1:], op=op), want)
        for f_slots, cursor_max in ((n >> 6, 0), (n >> 3, 2)):
            a = wd_inputs(g, rng, f_slots, cursor_max, dev)
            dist = with_extremes(rng, random_dist(rng, op, n, dev))
            args = (a["prefix"], a["exclusive"], a["start"], a["src_ids"],
                    g.col, wt)
            kw = dict(cap_work=a["cap_work"], op=op)
            check((name, "wd_relax_lanes"), f_slots, relax.wd_relax_lanes(
                dist, *args, **kw), relax.wd_relax_lanes_plain(
                    dist, *args, **kw))
            mask = torch.from_numpy(rng.random(n) < 0.2).to(dev)
            dist = in_domain(op, dist)
            want = relax.wd_apply_relax_plain(dist, mask.clone(), *args,
                                              **kw)
            check((name, "wd_relax_lanes"), (f_slots, "apply"),
                  relax.wd_apply_relax(dist, mask, *args, **kw), want)
        k = BATCH_K
        mask_b = torch.from_numpy(rng.random((k, n)) < 0.01).to(dev)
        dist_b = in_domain(op, with_extremes(rng, random_dist(rng, op, k * n,
                                                            dev)))
        dist_t = ms.to_node_major(dist_b.reshape(k, n), op.identity)
        front_t = ms.to_node_major(mask_b, False)
        totals = torch.where(mask_b, g.degrees, 0).sum(1)
        widest = int(mask_b.sum(1).max())
        for cap, cap_work, cut in ((widest, int(totals.max()), False),
                                   (widest // 2, int(totals.max()) // 2 + 1,
                                    True)):
            e = union_check(g, dist_t, front_t, k, op, cap=cap,
                            cap_work=cap_work, cut=cut)
            err[(name, "wd_relax_lanes_batch")] = max(
                err.get((name, "wd_relax_lanes_batch"), 0), e)
            cases += 1
            if e:
                bad.append((name, "wd_relax_lanes_batch", cap, e))
    emit("custom_kernels_check", cases=cases, mismatches=bad,
         operators=list(ops))
    if bad:
        raise AssertionError(f"custom kernel != plain version: {bad}")
    return err


def custom_ops_phase(g, dev, *, small_scale: int = 16,
                     road_side: int = ROAD_SIDE,
                     small_road_side: int = 256) -> list:
    """User-defined operators on the card: their callables lowered to
    C++ and B1, B2, B1's batch contract and the fused kernel (both modes)
    built for each at first use (``custom_builds``), held bit for bit
    against their plain versions (``custom_kernel_checks``).  On ``g``
    (rmat20) from its highest-degree source, the penalty and the budget
    through the six strategies stepped and fused, each equal to its
    oracle (Dijkstra over the penalised weights; ``max(B - d, 0)``) and
    stepped equal to fused; slack likewise, stepped equal to fused and no
    smaller than the distances.  The three at rmat-``small_scale`` card
    against CPU,
    the six strategies and a K = 4 batch, stepped and fused; a K = 8
    penalty batch stepped and fused equal to the single runs;
    penalty delta-stepping on road1024 against Dijkstra; a two-shard
    lockstep penalty run against one device.  (Delta at Δ = ``ROAD_DELTA``:
    the penalty is weight-additive, so its heavy edges are deferred.)
    These entry calls run with
    the counts set to 0 before each operator's calls and read after them:
    the kernel line's rows of each operator's instantiations.  Then the
    fused kernel against its plain loop (rmat16, all six; rmat20 WD,
    timed; road256 delta), each kernel timed beside its plain version,
    and fused WD sssp with ``shortest_path`` against the penalty above
    the heaviest weight (the same distances), interleaved."""
    import numpy as np
    import torch
    from repro_torch.core import engine, fused, operators, priority
    from repro_torch.core.graph import INF
    from repro_torch.core.strategies import make_strategy
    from repro_torch.data import rmat_graph, road_grid_graph
    from repro_torch.kernels import fused as fused_kernel
    from repro_torch.kernels.relax import LAUNCHES

    rng = np.random.default_rng(28)
    gname = f"rmat{g.num_nodes.bit_length() - 1}"
    source = int(g.degrees.argmax())
    d = dijkstra_oracle(g, source, weighted=True)
    budget = int(np.median(d[d < INF]))
    ops = custom_ops(budget, int(g.wt.max()))
    builds = custom_builds(ops)
    err = custom_kernel_checks(g, dev, {k: ops[k] for k in
                                        ("slack", "penalty", "budget")}, rng)

    oracle = {"penalty": dijkstra_oracle(penalised(g, CUSTOM_T), source,
                                         weighted=True),
              "budget": np.maximum(budget - d.astype(np.int64),
                                   0).astype(np.int32)}
    launches, stepped = {}, {}

    def counted(name, calls):
        """Run ``calls`` with the counts from 0; add the launches to
        ``name``'s."""
        zero_counts()
        calls()
        for key, v in LAUNCHES.items():
            launches.setdefault(name, {}).setdefault(key, 0)
            launches[name][key] += v

    def rmat20_runs(name):
        op = ops[name]
        for strategy in CUSTOM_STRATEGIES:
            runs = {mode: engine.run(g, source, make_strategy(strategy),
                                     op=op, mode=mode, device=dev)
                    for mode in ("stepped", "fused")}
            if not same_run(runs["stepped"], runs["fused"]):
                raise AssertionError(f"{name} {strategy}: stepped != fused")
            r = runs["fused"]
            if name in oracle:
                if not np.array_equal(r.dist, oracle[name]):
                    raise AssertionError(f"{name} {strategy} != oracle")
            elif not (r.dist >= d).all():
                raise AssertionError(f"slack {strategy} below Dijkstra")
            stepped[(name, strategy)] = runs["stepped"]
            emit("custom_run", graph=gname, op=op.name, strategy=strategy,
                 iterations=r.iterations, edges_relaxed=r.edges_relaxed,
                 stepped_seconds=runs["stepped"].traversal_seconds,
                 fused_seconds=r.traversal_seconds,
                 equals_oracle=name in oracle, stepped_equals_fused=True)

    for name in ("penalty", "budget", "slack"):
        counted(name, lambda name=name: rmat20_runs(name))

    small = rmat_graph(scale=small_scale, edge_factor=8, weighted=True,
                       seed=1, device=dev)
    s_src = int(small.degrees.argmax())
    small_sources = batch_sources(small, 4)

    def cpu_runs(name):
        op = ops[name]
        for strategy in CUSTOM_STRATEGIES:
            for mode in ("stepped", "fused"):
                card, cpu = (engine.run(small, s_src, make_strategy(strategy),
                                        op=op, mode=mode, device=dv)
                             for dv in (dev, "cpu"))
                if not same_run(card, cpu):
                    raise AssertionError(f"rmat{small_scale} {name} "
                                         f"{strategy} {mode}: cuda != cpu")
        for mode in ("stepped", "fused"):
            card, cpu = (engine.run_batch(small, small_sources, op=op,
                                          mode=mode, device=dv)
                         for dv in (dev, "cpu"))
            if not (np.array_equal(card.dist, cpu.dist)
                    and (card.iterations, card.edges_relaxed)
                    == (cpu.iterations, cpu.edges_relaxed)):
                raise AssertionError(f"rmat{small_scale} {name} {mode} "
                                     f"batch: cuda != cpu")
        emit("custom_cpu_compare", graph=f"rmat{small_scale}", op=op.name,
             strategies=list(CUSTOM_STRATEGIES), modes=["stepped", "fused"],
             batch_k=len(small_sources), equal=True)

    for name in ("slack", "penalty", "budget"):
        counted(name, lambda name=name: cpu_runs(name))

    pen = ops["penalty"]
    sources = batch_sources(g, BATCH_K)
    road = road_grid_graph(side=road_side, weighted=True, seed=4,
                           device=dev)
    road_src = int(road.degrees.argmax())
    road_oracle = dijkstra_oracle(penalised(road, CUSTOM_T), road_src,
                                  weighted=True)

    def penalty_paths():
        singles = [engine.run(g, int(s), make_strategy("WD"), op=pen,
                              mode="fused", device=dev) for s in sources]
        batch = {mode: engine.run_batch(g, sources, op=pen, mode=mode,
                                        device=dev)
                 for mode in ("stepped", "fused")}
        for mode, b in batch.items():
            if not all(np.array_equal(row, r.dist)
                       for row, r in zip(b.dist, singles)):
                raise AssertionError(f"penalty K = {BATCH_K} {mode} batch "
                                     f"!= its single runs")
            if (b.iterations, b.edges_relaxed) != (
                    max(r.iterations for r in singles),
                    sum(r.edges_relaxed for r in singles)):
                raise AssertionError(f"penalty {mode} batch counts")
        delta = {mode: engine.run(road, road_src, make_strategy("WD"),
                                  op=pen, mode=mode, schedule="delta",
                                  delta=ROAD_DELTA, device=dev)
                 for mode in ("stepped", "fused")}
        if not (np.array_equal(delta["fused"].dist, road_oracle)
                and same_run(delta["stepped"], delta["fused"])):
            raise AssertionError("penalty delta on road != Dijkstra or "
                                 "stepped != fused")
        sharded = engine.run(g, source, make_strategy("WD"), op=pen,
                             mode="fused", shards=2, device=dev)
        if not same_run(sharded, stepped[("penalty", "WD")]):
            raise AssertionError("penalty at 2 shards != one device")
        emit("custom_paths", op=pen.name, batch_k=BATCH_K,
             batch_iterations=batch["fused"].iterations,
             batch_edges=batch["fused"].edges_relaxed,
             batch_equals_singles=True, delta_graph=f"road{road_side}",
             delta=ROAD_DELTA, delta_epochs=delta["fused"].iterations,
             delta_equals_oracle=True, shards=2, sharded_equal=True)

    counted("penalty", penalty_paths)
    for name in ("penalty", "budget", "slack"):
        emit("custom_launches", op=ops[name].name, launches=launches[name])
        for _, key, _, _ in CUSTOM_KERNELS:
            if launches[name][key] < 1:
                raise AssertionError(f"{name} never launched {key}: "
                                     f"{launches[name]}")

    # the fused kernel against its plain loop on the same card tensors
    fused_err = {}
    for name in ("slack", "penalty", "budget"):
        op = ops[name]
        for graph, strategy, src in (
                [(small, s, s_src) for s in CUSTOM_STRATEGIES]
                + [(g, "WD", source)]):
            args, kw = fused_args(graph, strategy, src, op, dev)
            got = fused_kernel.fixed_point(*args, **kw)
            want = fused._fixed_point_plain(*args, **kw)
            if got[1:] != want[1:] or not torch.equal(got[0], want[0]):
                raise AssertionError(f"fused {name} {strategy} != plain")
            fused_err[name] = max(fused_err.get(name, 0),
                                  max_abs_err([got[0]], [want[0]]))
    road_small = road_grid_graph(side=small_road_side, weighted=True, seed=4,
                                 device=dev)
    strat = make_strategy("WD")
    plan = priority.plan_delta(strat, strat.setup(road_small), road_small,
                               op=pen, delta=ROAD_DELTA)
    s0 = int(road_small.degrees.argmax())
    dist0 = torch.full((road_small.num_nodes,), INF, dtype=torch.int32,
                       device=dev)
    dist0[s0] = 0
    mask0 = torch.zeros(road_small.num_nodes, dtype=torch.bool, device=dev)
    mask0[s0] = True
    dargs = (plan.kernel, plan.light, plan.heavy_graph, plan.aux, dist0,
             mask0)
    dkw = dict(op=pen, sched=plan.sched, delta=plan.delta,
               max_iterations=100000)
    got = fused_kernel.delta_fixed_point(*dargs, **dkw)
    want = priority._delta_fixed_point_plain(*dargs, **dkw)
    if not (torch.equal(got[0], want[0]) and got[2:] == want[2:]):
        raise AssertionError("penalty delta kernel != plain loop")
    emit("custom_fused_vs_plain",
         graphs=[f"rmat{small_scale}", gname,
                 f"road{small_road_side} delta"],
         max_abs_err=fused_err, delta_heavy_edges=(
             0 if plan.heavy_graph is None else plan.heavy_graph.num_edges),
         equal=True)

    # the fused kernel's time with the built-in and with a lowered message
    # that computes the same distances
    off = ops["penalty_off"]
    pair = {op.name: fused_args(g, "WD", source, op, dev)
            for op in (operators.shortest_path, off)}
    outs = {k: fused_kernel.fixed_point(*a, **kw)
            for k, (a, kw) in pair.items()}
    if not torch.equal(outs[off.name][0],
                       outs["shortest_path"][0]) or outs[off.name][1:3] != \
            outs["shortest_path"][1:3]:
        raise AssertionError(f"{off.name} != shortest_path")
    times = {k: [] for k in pair}
    for i in range(CUSTOM_TIMING_ROUNDS):
        for k in (list(pair) if i % 2 == 0 else list(pair)[::-1]):
            a, kw = pair[k]
            times[k].append(time_ms(
                lambda a=a, kw=kw: fused_kernel.fixed_point(*a, **kw),
                reps=1))
    med = {k: statistics.median(v) for k, v in times.items()}
    emit("custom_fused_timing", graph=gname, strategy="WD",
         nvidia_smi=nvidia_smi(), rounds=CUSTOM_TIMING_ROUNDS, ms=times,
         median_ms=med, lowered=off.name,
         ratio=med[off.name] / med["shortest_path"])

    # the kernel line's rows, each custom instantiation timed
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)   # > L2
    kept = batch_calls(g, dev, sources, widest_only=True, op=pen)[0]
    rows = []
    for name in ("penalty", "budget", "slack"):
        op = ops[name]
        timed_rows = {
            "relax_lanes": time_b2(lane_inputs(rng, g.num_nodes,
                                               8 * g.num_nodes, dev),
                                   random_dist(rng, op, g.num_nodes, dev),
                                   op, 10, flush),
            "wd_relax_lanes": time_b1(g, wd_inputs(g, rng, g.num_nodes, 0,
                                                   dev),
                                      random_dist(rng, op, g.num_nodes, dev),
                                      op, 10, flush),
            "wd_relax_lanes_batch": b1_batch_time(g, kept, op=op)}
        args, kw = fused_args(g, "WD", source, op, dev)
        wd = stepped[(name, "WD")]
        bound_ms, bound_by = bound(run_bytes(g, wd), 0)
        timed_rows["fused_fixed_point"] = dict(
            ms=time_ms(lambda: fused_kernel.fixed_point(*args, **kw)),
            plain_ms=time_ms(lambda: fused._fixed_point_plain(*args, **kw),
                             reps=3),
            bound_ms=bound_ms, bound_by=bound_by,
            shape=dict(graph=gname, run="WD", iterations=wd.iterations,
                       edges_relaxed=wd.edges_relaxed))
        for kernel, key, src_file, replaces in CUSTOM_KERNELS:
            rows.append(dict(
                name=f"{kernel}<{op.name}>", route="cuda", source=src_file,
                replaces=replaces, launches=launches[name][key],
                max_abs_err=(fused_err[name] if kernel == "fused_fixed_point"
                             else err[(name, kernel)]),
                library_ms=None, op=op.name,
                registers=builds[name]["attrs"][
                    "wd_relax_union" if kernel == "wd_relax_lanes_batch"
                    else kernel]["registers"],
                **timed_rows[kernel]))
    emit("custom_kernels_time", rows=rows)
    return rows


# ---------------------------------------------------------------------------
# phase 4g: float32 operators on the card (ROADMAP queue C)
# ---------------------------------------------------------------------------

#: the float SSSP's scale: a distance in hundredths of a weight
FLOAT_SCALE = 0.01
#: the layered DAG of the damped path counts: layers, width, out-degree
FLOAT_DAG = (16, 1 << 16, 8)
FLOAT_SMALL_DAG = (16, 1 << 12, 8)
#: the float kernels' tolerance for add (the order of a float sum)
FLOAT_ADD_RTOL = 1e-4
#: float extremes planted among the values (add: the non-negative ones,
#: which no order of a sum overflows)
FLOAT_EXTREMES = (0.0, -0.0, 2.0 ** 30, float("nan"), float("inf"),
                  float("-inf"), 1e-45, -1e-40, 3.4e38, -3.4e38, -1.0)
FLOAT_ADD_EXTREMES = (0.0, -0.0, 2.0 ** 30, 1e-45, 1e-40, float("inf"))


def float_ops() -> dict:
    """The phase's float32 operators: SSSP in hundredths of a weight (a
    multiply-add nvcc would contract into an FMA), the most reliable path
    (max of products of w / (w + 1), a quotient) and damped path counts
    (add, v / 2 an edge)."""
    import torch
    from repro_torch.core.graph import INF
    from repro_torch.core.operators import EdgeOp
    return {
        "scaled_sssp": EdgeOp(
            name="scaled_sssp", combine="min", identity=float(INF),
            source_value=0.0, weight_additive=True, dtype=torch.float32,
            message=lambda v, w: v + w * FLOAT_SCALE),
        "reliable": EdgeOp(
            name="reliable", combine="max", identity=0.0, source_value=1.0,
            value_min=0, dtype=torch.float32,
            message=lambda v, w: v * (w / (w + 1.0))),
        "damped": EdgeOp(
            name="damped", combine="add", identity=0.0, source_value=1.0,
            dtype=torch.float32, message=lambda v, w: v * 0.5),
    }


def float32_dijkstra(g, source: int, scale: float):
    """Dijkstra over float32 values with ``v + float32(w) * float32(scale)``,
    each operation rounded once to float32, as the port computes it:
    exact for this message, which is monotone and never below ``v``."""
    import heapq
    import struct
    import numpy as np
    from repro_torch.core.graph import INF
    f32 = struct.Struct("f")

    def r32(x):
        return f32.unpack(f32.pack(x))[0]
    rp = g.row_ptr.cpu().numpy().tolist()
    col = g.col.cpu().numpy().tolist()
    step = (g.wt.cpu().numpy().astype(np.float32)
            * np.float32(scale)).astype(np.float32).tolist()
    inf = float(np.float32(INF))
    dist = [inf] * g.num_nodes
    dist[source] = 0.0
    done = bytearray(g.num_nodes)
    heap = [(0.0, source)]
    while heap:
        d, u = heapq.heappop(heap)
        if done[u]:
            continue
        done[u] = 1
        for e in range(rp[u], rp[u + 1]):
            nd = r32(d + step[e])
            v = col[e]
            if nd < dist[v]:
                dist[v] = nd
                heapq.heappush(heap, (nd, v))
    return np.asarray(dist, np.float32)


def float_values(rng, op, shape):
    """Random float32 values of ``op``'s domain, a tenth of them planted
    extremes."""
    import numpy as np
    if op.combine == "max":
        a = rng.random(shape).astype(np.float32)
    else:
        a = (rng.random(shape) * 60).astype(np.float32)
        if op.combine == "min":
            a[rng.random(shape) < 0.4] = op.identity
    at = rng.random(shape) < 0.1
    pool = FLOAT_ADD_EXTREMES if op.combine == "add" else FLOAT_EXTREMES
    a[at] = rng.choice(np.array(pool, np.float32), int(at.sum()))
    return a


def float_err(got, want, op, rtol: float = FLOAT_ADD_RTOL
              ) -> tuple[float, float]:
    """The card's outputs against the CPU's: bools and integers exactly;
    float values (float32, bfloat16, float16) of min and max bit for bit
    and NaN for NaN (a NaN's payload is the hardware's), of add within
    ``rtol``.  Returns the largest absolute and relative differences of
    the float values; raises on any other difference."""
    import torch
    abs_err = rel_err = 0.0
    for a, b in zip(got, want):
        a, b = a.cpu(), b.cpu()
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"output {tuple(a.shape)}/{a.dtype} vs "
                                 f"{tuple(b.shape)}/{b.dtype}")
        if not a.is_floating_point():
            if not torch.equal(a, b):
                raise AssertionError(f"{op.name}: a flag or value differs")
            continue
        if not torch.equal(a.isnan(), b.isnan()):
            raise AssertionError(f"{op.name}: NaN at other places")
        x, y = a[~a.isnan()], b[~b.isnan()]
        if op.combine != "add":
            bits = {2: torch.int16, 4: torch.int32}[x.element_size()]
            if not torch.equal(x.view(bits), y.view(bits)):
                raise AssertionError(f"{op.name}: float values differ in "
                                     f"their bits")
            continue
        x, y = x.double(), y.double()
        if not torch.equal(torch.isinf(x), torch.isinf(y)) or not \
                torch.equal(x[torch.isinf(x)], y[torch.isinf(y)]):
            raise AssertionError(f"{op.name}: infinities differ")
        fin = torch.isfinite(y)
        d = (x[fin] - y[fin]).abs()
        if d.numel():
            abs_err = max(abs_err, float(d.max()))
            rel = d / y[fin].abs().clamp(min=1e-300)
            rel_err = max(rel_err, float(rel[y[fin] != 0].max())
                          if bool((y[fin] != 0).any()) else 0.0)
    if rel_err > rtol:
        raise AssertionError(f"{op.name}: add beyond rtol {rtol}: "
                             f"{rel_err}")
    return abs_err, rel_err


def float_sass(library) -> dict:
    """FFMA, FMUL and FADD instructions of each kernel of ``library``
    (``cuobjdump -sass``): the float builds round every product and sum
    on its own (``__fmul_rn``, ``__fadd_rn``), so no kernel may hold an
    FFMA."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = kernel_name(m.group(1)) or m.group(1)
            out[cur] = {"FFMA": 0, "FMUL": 0, "FADD": 0}
            continue
        if cur:
            for k in out[cur]:
                if re.search(rf"\b{k}\b", line):
                    out[cur][k] += 1
    return out


def check_float_sass(sssp: dict, damped: dict) -> None:
    """The float SSSP's lowered multiply-add stays two instructions: B1,
    B2 and the union contract of its build hold an FMUL and an FADD and no
    FFMA, and its fused fixed point as many FFMA as the damped count's
    (whose message, a product alone, has nothing to contract): those
    come from the IEEE divisions of AD's selector, which SASS computes
    with FFMA steps.  Raises otherwise."""
    def pick(counts, kernel):
        found = [v for k, v in counts.items() if k.startswith(kernel)]
        if len(found) != 1:
            raise AssertionError(f"{kernel}: {len(found)} kernels in SASS")
        return found[0]
    relax = {k: pick(sssp, k) for k in ("relax_lanes_kernel",
                                         "wd_relax_lanes_kernel",
                                         "wd_relax_union_kernel")}
    fused = {name: pick(c, "fused_fixed_point_kernel")["FFMA"]
             for name, c in (("scaled_sssp", sssp), ("damped", damped))}
    emit("float_sass", op="scaled_sssp", relax_kernels=relax,
         fused_ffma=fused)
    if any(v["FFMA"] or not (v["FMUL"] and v["FADD"])
           for v in relax.values()) or fused["scaled_sssp"] != fused[
               "damped"]:
        raise AssertionError(f"the float SSSP's multiply-add was "
                             f"contracted: {relax} {fused}")


def float_kernel_checks(g, dev, ops: dict, rng, values=None,
                        rtol: float = FLOAT_ADD_RTOL,
                        line: str = "float_kernels_check") -> dict:
    """B2 and B1 (both contracts each) and B1's batch contract built for
    each operator of a float (or sub-word) value type, against their plain
    versions on CPU copies: ``g``'s node count, ``values(rng, op, shape)``
    on the card (default: float32 extremes among them, ``float_values``)
    and int32 extremes among the weights (B2: 1,001 and N + 3 lanes; B1:
    frontiers of N/64 and N/8 slots; the batch: K = 8 rows of ~N/100
    nodes).  The proposal contracts take every extreme, the folds into
    dist the values of the operator's domain (``in_domain``); add is held
    at ``rtol``.  Returns (operator, kernel) -> (max abs, max rel) error;
    raises on a difference."""
    import torch
    from repro_torch.core import multi_source as ms
    from repro_torch.kernels import relax
    if values is None:
        def values(rng, op, shape):
            return torch.from_numpy(float_values(rng, op, shape)).to(dev)
    n = g.num_nodes
    err, cases = {}, 0

    def cpu(args):
        return tuple(None if a is None else a.cpu() for a in args)

    def check(key, got, want, op):
        nonlocal cases
        e = float_err(got, want, op, rtol)
        old = err.get(key, (0.0, 0.0))
        err[key] = (max(old[0], e[0]), max(old[1], e[1]))
        cases += 1

    # the lanes, frontiers and masks do not depend on the operator: built
    # once, each operator's values on them
    wt = with_extremes(rng, g.wt)
    col_c, wt_c = g.col.cpu(), wt.cpu()
    b2 = []
    for lanes in (1001, n + 3):
        b = lane_inputs(rng, n, lanes, dev)
        args = (b["src"], b["dst"], with_extremes(rng, b["w"]), b["valid"])
        b2.append((args, cpu(args),
                   torch.from_numpy(rng.random(n) < 0.2).to(dev)))
    b1 = []
    for f_slots, cursor_max in ((n >> 6, 0), (n >> 3, 2)):
        a = wd_inputs(g, rng, f_slots, cursor_max, dev)
        args = (a["prefix"], a["exclusive"], a["start"], a["src_ids"],
                g.col, wt)
        b1.append((args, cpu(args[:4]) + (col_c, wt_c), a["cap_work"],
                   torch.from_numpy(rng.random(n) < 0.2).to(dev)))
    k = BATCH_K
    mask_b = torch.from_numpy(rng.random((k, n)) < 0.01).to(dev)
    front_t = ms.to_node_major(mask_b, False)
    tables = ms.union_tables(g, front_t.any(1), n)
    front_c, tables_c = front_t.cpu(), cpu(tables)
    for name, op in ops.items():
        for args, cargs, mask in b2:
            dist = values(rng, op, n)
            check((name, "relax_lanes"),
                  relax.relax_lanes(dist, *args, op=op),
                  relax.relax_lanes_plain(dist.cpu(), *cargs, op=op), op)
            dist = in_domain(op, dist)
            want = relax.apply_relax_plain(dist.cpu(), mask.cpu(), *cargs,
                                           op=op)
            check((name, "relax_lanes"),
                  relax.apply_relax(dist, mask, *args, op=op), want, op)
        for args, cargs, cap_work, mask in b1:
            dist = values(rng, op, n)
            kw = dict(cap_work=cap_work, op=op)
            check((name, "wd_relax_lanes"),
                  relax.wd_relax_lanes(dist, *args, **kw),
                  relax.wd_relax_lanes_plain(dist.cpu(), *cargs, **kw), op)
            dist = in_domain(op, dist)
            want = relax.wd_apply_relax_plain(dist.cpu(), mask.cpu(),
                                              *cargs, **kw)
            check((name, "wd_relax_lanes"),
                  relax.wd_apply_relax(dist, mask, *args, **kw), want, op)
        dist_b = in_domain(op, values(rng, op, (k, n)))
        dist_t = ms.to_node_major(dist_b, op.identity)
        uargs = (dist_t, front_t, *tables, g.col, wt)
        check((name, "wd_relax_lanes_batch"),
              relax.wd_apply_relax_union(*uargs, cap_work=g.num_edges,
                                         max_lanes=int(tables[0][-1]), op=op),
              relax.wd_apply_relax_union_plain(
                  dist_t.cpu(), front_c, *tables_c, col_c, wt_c,
                  cap_work=g.num_edges, op=op), op)
    emit(line, cases=cases, operators=list(ops),
         max_err={f"{a}/{b}": v for (a, b), v in err.items()},
         add_rtol=rtol)
    return err


def float_ops_phase(g, dev, *, small_scale: int = 16,
                    road_side: int = ROAD_SIDE,
                    small_road_side: int = 256) -> list:
    """float32 operators on the card (module docstring, ``float_ops``).
    The entry calls of each operator run with the counts set to 0 before
    them and read after them: the kernel line's ``<kernel><op>`` rows."""
    import numpy as np
    import torch
    from repro_torch.core import engine, fused, priority
    from repro_torch.core.strategies import make_strategy
    from repro_torch.data import rmat_graph, road_grid_graph
    from repro_torch.kernels import _build, opgen
    from repro_torch.kernels import fused as fused_kernel
    from repro_torch.kernels.relax import LAUNCHES

    rng = np.random.default_rng(29)
    steps, t_step = {}, [time.perf_counter()]

    def step(name):
        """The seconds since the last step, as ``name``'s."""
        now = time.perf_counter()
        steps[name] = now - t_step[0]
        t_step[0] = now

    gname = f"rmat{g.num_nodes.bit_length() - 1}"
    source = int(g.degrees.argmax())
    ops = float_ops()
    builds = custom_builds(ops, line="float_build")
    sass = {name: float_sass(_build.custom_library_path(
        opgen.lower(ops[name]).header)) for name in ("scaled_sssp", "damped")}
    check_float_sass(sass["scaled_sssp"], sass["damped"])
    step("builds")
    err = float_kernel_checks(g, dev, ops, rng)
    step("kernel_checks")

    launches, stepped, fused_err = {}, {}, {}

    def counted(name, calls):
        zero_counts()
        calls()
        for key, v in LAUNCHES.items():
            launches.setdefault(name, {}).setdefault(key, 0)
            launches[name][key] += v

    def agree(name, a, b, counts=True):
        """Two runs equal bit for bit (min, max) or within the add's
        tolerance; with ``counts``, in iterations and edges too."""
        float_err([torch.from_numpy(a.dist)], [torch.from_numpy(b.dist)],
                  ops[name])
        if counts and (a.iterations, a.edges_relaxed) != (b.iterations,
                                                          b.edges_relaxed):
            raise AssertionError(f"{name}: counts differ")

    dag = layered_dag(*FLOAT_DAG, dev)
    graphs = {"scaled_sssp": (g, source), "reliable": (g, source),
              "damped": (dag, 0)}

    def big_runs(name):
        op = ops[name]
        graph, src = graphs[name]
        runs = []
        for strategy in CUSTOM_STRATEGIES:
            for mode in ("stepped", "fused"):
                r = engine.run(graph, src, make_strategy(strategy), op=op,
                               mode=mode, device=dev)
                if r.dist.dtype != np.float32:
                    raise AssertionError(f"{name}: dist {r.dist.dtype}")
                runs.append(r)
                if strategy == "WD":
                    stepped.setdefault((name, mode), r)
            emit("float_run", graph=gname if graph is g else "dag",
                 op=op.name, strategy=strategy,
                 iterations=runs[-1].iterations,
                 edges_relaxed=runs[-1].edges_relaxed,
                 stepped_seconds=runs[-2].traversal_seconds,
                 fused_seconds=runs[-1].traversal_seconds)
        for i in range(0, len(runs), 2):      # stepped, fused a strategy
            agree(name, runs[i], runs[i + 1])
            agree(name, runs[i], runs[0], counts=False)

    for name in ops:
        counted(name, lambda name=name: big_runs(name))
    step("full_size_runs")

    small = rmat_graph(scale=small_scale, edge_factor=8, weighted=True,
                       seed=1, device=dev)
    s_src = int(small.degrees.argmax())
    small_dag = layered_dag(*FLOAT_SMALL_DAG, dev)
    small_graphs = {"scaled_sssp": (small, s_src), "reliable": (small, s_src),
                    "damped": (small_dag, 0)}

    def cpu_runs(name):
        """Each strategy stepped and fused on the card, equal to each
        other and to an oracle off the card: the float SSSP to the float32
        Dijkstra, the others to the CPU's stepped run (the CPU's fused
        loop costs more there and equals its stepped run in the CPU
        tests)."""
        op = ops[name]
        graph, src = small_graphs[name]
        for strategy in CUSTOM_STRATEGIES:
            card = [engine.run(graph, src, make_strategy(strategy), op=op,
                               mode=mode, device=dev)
                    for mode in ("stepped", "fused")]
            agree(name, card[0], card[1])
            if name == "scaled_sssp":
                if not np.array_equal(card[1].dist.view(np.int32),
                                      oracle.view(np.int32)):
                    raise AssertionError(f"scaled_sssp {strategy} != "
                                         f"float32 Dijkstra")
            else:
                agree(name, card[1], engine.run(
                    graph, src, make_strategy(strategy), op=op,
                    mode="stepped", device="cpu"))
        sources = [src, 0, 3, 3]
        for mode in ("stepped", "fused"):
            card, cpu = (engine.run_batch(graph, sources, op=op, mode=mode,
                                          device=dv) for dv in (dev, "cpu"))
            agree(name, card, cpu)
        emit("float_cpu_compare", graph=(f"rmat{small_scale}"
                                         if graph is small else "small_dag"),
             op=op.name, strategies=list(CUSTOM_STRATEGIES),
             card_modes=["stepped", "fused"],
             cpu_modes=[] if name == "scaled_sssp" else ["stepped"],
             batch_k=4, batch_modes=["stepped", "fused"], equal=True,
             dijkstra=name == "scaled_sssp")

    oracle = float32_dijkstra(small, s_src, FLOAT_SCALE)
    for name in ops:
        counted(name, lambda name=name: cpu_runs(name))
    step("cpu_compare")

    sssp_op = ops["scaled_sssp"]
    sources = batch_sources(g, BATCH_K)
    road = road_grid_graph(side=road_side, weighted=True, seed=4,
                           device=dev)
    road_src = int(road.degrees.argmax())
    road_small = road_grid_graph(side=small_road_side, weighted=True,
                                 seed=4, device=dev)

    def paths(name):
        op = ops[name]
        singles = [engine.run(g, int(s), make_strategy("WD"), op=op,
                              mode="fused", device=dev) for s in sources]
        for mode in ("stepped", "fused"):
            b = engine.run_batch(g, sources, op=op, mode=mode, device=dev)
            if not all(np.array_equal(row.view(np.int32),
                                      r.dist.view(np.int32))
                       for row, r in zip(b.dist, singles)):
                raise AssertionError(f"{name} K = {BATCH_K} {mode} batch "
                                     f"!= its single runs")
        rs = int(road_small.degrees.argmax())
        agree(name, *(engine.run(road_small, rs, make_strategy("WD"), op=op,
                                 mode=mode, schedule="delta", device=dev)
                      for mode in ("stepped", "fused")))
        sharded = engine.run(small, s_src, make_strategy("WD"), op=op,
                             mode="fused", shards=2, device=dev)
        one = engine.run(small, s_src, make_strategy("WD"), op=op,
                         mode="fused", device=dev)
        agree(name, sharded, one)
        out = dict(op=op.name, batch_k=BATCH_K, batch_equals_singles=True,
                   delta_graph=f"road{small_road_side}",
                   delta_stepped_equals_fused=True,
                   shard_graph=f"rmat{small_scale}", shards=2,
                   sharded_equal=True)
        if name == "scaled_sssp":
            t0 = time.perf_counter()
            r = engine.run(road, road_src, make_strategy("WD"), op=op,
                           mode="fused", schedule="delta", device=dev)
            run_s = time.perf_counter() - t0
            want = float32_dijkstra(road, road_src, FLOAT_SCALE)
            if not np.array_equal(r.dist.view(np.int32),
                                  want.view(np.int32)):
                raise AssertionError("float SSSP delta on road != "
                                     "float32 Dijkstra")
            out.update(road=f"road{road_side}", road_delta=r.delta,
                       road_epochs=r.iterations, road_run_seconds=run_s,
                       road_equals_dijkstra=True)
        emit("float_paths", **out)

    for name in ("scaled_sssp", "reliable"):
        counted(name, lambda name=name: paths(name))

    def damped_batch():
        for mode in ("stepped", "fused"):
            card, cpu = (engine.run_batch(small_dag, [0, 1, 5, 5], op=ops[
                "damped"], mode=mode, device=dv) for dv in (dev, "cpu"))
            agree("damped", card, cpu)

    counted("damped", damped_batch)
    step("paths")
    for name in ops:
        emit("float_launches", op=ops[name].name, launches=launches[name])
        for _, key, _, _ in CUSTOM_KERNELS:
            if launches[name][key] < 1:
                raise AssertionError(f"{name} never launched {key}: "
                                     f"{launches[name]}")

    # the fused kernel against its plain loop (AD's choices and the chunks
    # too) at full size, WD on rmat20 (the dag for add), on the same card
    # tensors: these messages divide by a tensor, if at all, which the
    # card's torch divides as IEEE does (its reciprocal is for a scalar
    # divisor); every strategy at rmat16 met the CPU's plain loop above
    for name, op in ops.items():
        graph, src = graphs[name]
        args, kw = fused_args(graph, "WD", src, op, dev)
        got = fused_kernel.fixed_point(*args, **kw)
        want = fused._fixed_point_plain(*args, **kw)
        if got[1:] != want[1:]:
            raise AssertionError(f"fused {name} WD counts")
        fused_err[name] = float_err([got[0]], [want[0]], op)
    strat = make_strategy("WD")
    for name in ("scaled_sssp", "reliable"):
        op = ops[name]
        plan = priority.plan_delta(strat, strat.setup(road_small),
                                   road_small, op=op, delta=ROAD_DELTA)
        s0 = int(road_small.degrees.argmax())
        dist0 = torch.full((road_small.num_nodes,), op.identity,
                           dtype=op.dtype, device=dev)
        dist0[s0] = op.seed(s0)
        mask0 = torch.zeros(road_small.num_nodes, dtype=torch.bool,
                            device=dev)
        mask0[s0] = True
        dkw = dict(op=op, sched=plan.sched, delta=plan.delta,
                   max_iterations=100000)
        got = fused_kernel.delta_fixed_point(
            plan.kernel, plan.light, plan.heavy_graph, plan.aux, dist0, mask0,
            **dkw)
        heavy = plan.heavy_graph
        want = priority._delta_fixed_point_plain(
            plan.kernel, plan.light.to("cpu"),
            None if heavy is None else heavy.to("cpu"),
            None if plan.aux is None else plan.aux.cpu(), dist0.cpu(),
            mask0.cpu(), **dkw)
        float_err(got[:2], want[:2], op)
        if got[2:] != want[2:]:
            raise AssertionError(f"{name} delta kernel != plain loop")
    emit("float_fused_vs_plain",
         graphs=[gname, "dag", f"road{small_road_side} delta (CPU copies)"],
         max_err=fused_err, equal=True)
    step("fused_vs_plain")

    # the kernel line's rows, each float instance timed
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)   # > L2
    kept = batch_calls(g, dev, sources, widest_only=True, op=sssp_op)[0]
    rows = []
    for name, op in ops.items():
        graph, src = graphs[name]
        fvals = torch.from_numpy(float_values(
            rng, op, g.num_nodes)).to(dev)
        fvals = torch.where(fvals.isnan() | fvals.isinf(),
                            torch.zeros_like(fvals), fvals)
        c = dict(kept, dist_t=kept["dist_t"].clone())
        if op.combine == "max":     # reliable's domain: [0, 1]
            c["dist_t"] = c["dist_t"].clamp(max=1.0)
        timed_rows = {
            "relax_lanes": time_b2(lane_inputs(rng, g.num_nodes,
                                               8 * g.num_nodes, dev),
                                   fvals, op, 10, flush),
            "wd_relax_lanes": time_b1(g, wd_inputs(g, rng, g.num_nodes, 0,
                                                   dev), fvals, op, 10, flush),
            "wd_relax_lanes_batch": b1_batch_time(g, c, op=op)}
        args, kw = fused_args(graph, "WD", src, op, dev)
        wd = stepped[(name, "stepped")]
        bound_ms, bound_by = bound(run_bytes(graph, wd), 0)
        timed_rows["fused_fixed_point"] = dict(
            ms=time_ms(lambda: fused_kernel.fixed_point(*args, **kw)),
            ms_warm=time_ms(lambda: fused_kernel.fixed_point(*args, **kw)),
            plain_ms=time_ms(lambda: fused._fixed_point_plain(*args, **kw),
                             reps=3),
            bound_ms=bound_ms, bound_by=bound_by,
            shape=dict(graph=gname if graph is g else "dag", run="WD",
                       iterations=wd.iterations,
                       edges_relaxed=wd.edges_relaxed))
        for kernel, key, src_file, replaces in CUSTOM_KERNELS:
            e = (fused_err[name] if kernel == "fused_fixed_point"
                 else err[(name, kernel)])
            rows.append(dict(
                name=f"{kernel}<{op.name}>", route="cuda", source=src_file,
                replaces=replaces, launches=launches[name][key],
                max_abs_err=e[0], max_rel_err=e[1], library_ms=None,
                op=op.name, dtype="float32",
                registers=builds[name]["attrs"][
                    "wd_relax_union" if kernel == "wd_relax_lanes_batch"
                    else kernel]["registers"],
                **timed_rows[kernel]))
    emit("float_kernels_time", rows=rows, nvidia_smi=nvidia_smi())
    step("timing")
    emit("float_phase_steps", seconds=steps)
    return rows


# ---------------------------------------------------------------------------
# phase 4h: sub-word operators on the card (ROADMAP queue C)
# ---------------------------------------------------------------------------

#: the sub-word add operators' layered DAG: layers, width, out-degree
SUBWORD_DAG = (8, 1 << 14, 4)
#: the bfloat16 add's tolerance against its plain version: a float sum
#: depends on the order of its terms, and bfloat16 keeps 8 bits
SUBWORD_ADD_RTOL = 4e-2
#: the road side of the sub-word delta runs (a Python Dijkstra in the
#: value type checks them; at 1024 it alone would take the phase's time)
SUBWORD_ROAD_SIDE = 256


def subword_ops() -> dict:
    """The phase's sub-word operators (ROADMAP queue C): SSSP in bfloat16
    (``v + w``: the weight rounds to bfloat16, the sum once), the most
    reliable path in float16 (a float32 message the fold narrows), SSSP
    in int16 (an int32 message the fold narrows), BFS levels in int8
    (``v + 1``), the widest path in uint8 (its weights clamped and
    narrowed), and path counts in uint8 (add, wrapping) and damped in
    bfloat16 (add, ``v * 0.5``)."""
    import torch
    from repro_torch.core.operators import EdgeOp
    bf16, f16 = torch.bfloat16, torch.float16
    return {
        "bf16_sssp": EdgeOp(name="bf16_sssp", combine="min",
                            identity=float("inf"), source_value=0.0,
                            weight_additive=True, dtype=bf16,
                            message=lambda v, w: v + w),
        "f16_reliable": EdgeOp(name="f16_reliable", combine="max",
                               identity=0.0, source_value=1.0, value_min=0,
                               dtype=f16,
                               message=lambda v, w: v * (w / (w + 1.0))),
        "i16_sssp": EdgeOp(name="i16_sssp", combine="min", identity=32767,
                           source_value=0, weight_additive=True,
                           dtype=torch.int16, message=lambda v, w: v + w),
        "i8_levels": EdgeOp(name="i8_levels", combine="min", identity=127,
                            source_value=0, dtype=torch.int8,
                            message=lambda v, w: v + 1),
        "u8_widest": EdgeOp(name="u8_widest", combine="max", identity=0,
                            source_value=255, value_min=0, dtype=torch.uint8,
                            message=lambda v, w: torch.minimum(
                                v, w.clamp(0, 255).to(torch.uint8))),
        "u8_count": EdgeOp(name="u8_count", combine="add", identity=0,
                           source_value=1, dtype=torch.uint8,
                           message=lambda v, w: v),
        "bf16_damped": EdgeOp(name="bf16_damped", combine="add",
                              identity=0.0, source_value=1.0, dtype=bf16,
                              message=lambda v, w: v * 0.5),
    }


def subword_values(rng, op, shape, dev):
    """Random values of ``op``'s type and domain on ``dev``, a tenth of
    them the type's extremes (a 16-bit float's ±0, NaN, ±inf, largest and
    least values; an integer type's least and largest, 0 and -1)."""
    import numpy as np
    import torch
    dtype = op.dtype
    if dtype.is_floating_point:
        fi = torch.finfo(dtype)
        a = (rng.random(shape) * (1.0 if op.combine == "max" else 60.0))
        pool = [0.0, -0.0, float("nan"), float("inf"), -float("inf"),
                fi.max, -fi.max, fi.tiny, fi.smallest_normal / 8, -1.0]
        if op.combine == "add":
            pool = [0.0, -0.0, fi.tiny, fi.smallest_normal / 8, 2.0 ** 10]
    else:
        ii = torch.iinfo(dtype)
        a = rng.integers(0, min(ii.max, 100), shape).astype(np.float64)
        pool = [ii.min, ii.max, 0, -1 if ii.min < 0 else 1]
    if op.combine == "min":
        a[rng.random(shape) < 0.4] = op.identity
    at = rng.random(shape) < 0.1
    a[at] = rng.choice(np.array(pool, np.float64), int(at.sum()))
    t = torch.from_numpy(a)
    return (t.to(dtype) if dtype.is_floating_point
            else t.to(torch.int64).to(dtype)).to(dev)


def bf16_dijkstra(g, source: int):
    """Dijkstra over bfloat16 values with ``v + w`` as torch computes it
    (the weight rounded to bfloat16, the float32 sum rounded to bfloat16
    once, to nearest even): exact for this message, which is monotone and
    never below ``v``.  Returns float32 values."""
    import heapq
    import numpy as np

    def bf16(x):
        u = np.array([x], np.float32).view(np.uint32)[0]
        u = (int(u) + 0x7fff + ((int(u) >> 16) & 1)) & 0xffff0000
        return float(np.array([u], np.uint32).view(np.float32)[0])
    rp = g.row_ptr.cpu().numpy().tolist()
    col = g.col.cpu().numpy().tolist()
    # every weight rounded as bf16() rounds one, at once
    u = g.wt.cpu().numpy().astype(np.float32).view(np.uint32).astype(
        np.int64)
    u = (u + 0x7fff + ((u >> 16) & 1)) & 0xffff0000
    wt = u.astype(np.uint32).view(np.float32).astype(np.float64).tolist()
    cache = {}
    dist = [float("inf")] * g.num_nodes
    dist[source] = 0.0
    done = bytearray(g.num_nodes)
    heap = [(0.0, source)]
    while heap:
        d, u = heapq.heappop(heap)
        if done[u]:
            continue
        done[u] = 1
        for e in range(rp[u], rp[u + 1]):
            s = d + wt[e]
            nd = cache.get(s)
            if nd is None:
                nd = cache[s] = bf16(s)
            v = col[e]
            if nd < dist[v]:
                dist[v] = nd
                heapq.heappush(heap, (nd, v))
    return np.asarray(dist, np.float32)


def subword_sass(builds: dict, ops: dict) -> dict:
    """FFMA of each 16-bit float build's kernels (``float_sass``): B1, B2
    and the union contract of the operators whose messages divide nothing
    hold none, and their fused fixed point as many as the int16 build's
    (those come from AD's IEEE divisions).  Raises otherwise."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import _build, opgen
    names = ("bf16_sssp", "bf16_damped", "i16_sssp")
    with ThreadPoolExecutor(len(names)) as pool:      # cuobjdump at once
        counts = dict(zip(names, pool.map(
            float_sass, (_build.custom_library_path(
                opgen.lower(ops[name]).header) for name in names))))

    def ffma(c, kernel):
        return sum(v["FFMA"] for k, v in c.items() if k.startswith(kernel))
    out = {name: {k: ffma(c, k) for k in (
        "relax_lanes_kernel", "wd_relax_lanes_kernel",
        "wd_relax_union_kernel", "fused_fixed_point_kernel")}
        for name, c in counts.items()}
    emit("subword_sass", ffma=out)
    for name in ("bf16_sssp", "bf16_damped"):
        c = out[name]
        if c["relax_lanes_kernel"] or c["wd_relax_lanes_kernel"] or \
                c["wd_relax_union_kernel"] or c["fused_fixed_point_kernel"] \
                != out["i16_sssp"]["fused_fixed_point_kernel"]:
            raise AssertionError(f"{name}: an FFMA in its SASS: {out}")
    return out


def subword_ops_phase(g, dev, *, small_scale: int = 16,
                      road_side: int = SUBWORD_ROAD_SIDE) -> list:
    """Sub-word operators on the card (module docstring, ``subword_ops``):
    bfloat16, float16, int16, int8 and uint8 values through B1, B2, B1's
    batch contract and the fused kernel (BSP, batch, delta).  The entry
    calls of each operator run with the counts set to 0 before them and
    read after them: the kernel line's ``<kernel><op>`` rows."""
    import numpy as np
    import torch
    from repro_torch.core import engine, fused, priority
    from repro_torch.core.graph import INF
    from repro_torch.core.strategies import make_strategy
    from repro_torch.data import rmat_graph, road_grid_graph
    from repro_torch.kernels import fused as fused_kernel
    from repro_torch.kernels.relax import LAUNCHES

    rng = np.random.default_rng(30)
    steps, t_step = {}, [time.perf_counter()]

    def step(name):
        """The seconds since the last step, as ``name``'s."""
        now = time.perf_counter()
        steps[name] = now - t_step[0]
        t_step[0] = now

    gname = f"rmat{g.num_nodes.bit_length() - 1}"
    source = int(g.degrees.argmax())
    ops = subword_ops()
    builds = custom_builds(ops, line="subword_build")
    subword_sass(builds, ops)
    step("builds")
    # each kernel against its plain version at the main path's N
    err = float_kernel_checks(
        g, dev, ops, rng,
        values=lambda rng, op, shape: subword_values(rng, op, shape, dev),
        rtol=SUBWORD_ADD_RTOL, line="subword_kernels_check")
    step("kernel_checks")
    small = rmat_graph(scale=small_scale, edge_factor=8, weighted=True,
                       seed=1, device=dev)
    s_src = int(small.degrees.argmax())

    launches, stepped, fused_err = {}, {}, {}

    def counted(name, calls):
        zero_counts()
        calls()
        for key, v in LAUNCHES.items():
            launches.setdefault(name, {}).setdefault(key, 0)
            launches[name][key] += v

    def agree(name, a, b, counts=True):
        """Two runs equal bit for bit (min, max, integer add) or within
        the bfloat16 add's tolerance; with ``counts``, in iterations and
        edges too."""
        float_err([torch.from_numpy(a.dist)], [torch.from_numpy(b.dist)],
                  ops[name], SUBWORD_ADD_RTOL)
        if counts and (a.iterations, a.edges_relaxed) != (b.iterations,
                                                          b.edges_relaxed):
            raise AssertionError(f"{name}: counts differ")

    dag = layered_dag(*SUBWORD_DAG, dev)
    adds = [name for name, op in ops.items() if op.combine == "add"]
    graphs = {name: (dag, 0) if name in adds else (g, source)
              for name in ops}

    def big_runs(name):
        """The six strategies fused on rmat20, WD stepped too (the DAG
        for add: all six stepped too), every strategy equal to the first
        and stepped equal to fused.  (rmat16 runs all six stepped,
        ``paths``: on rmat20 BS, NS and AD stepped cost seconds an
        operator.)"""
        op = ops[name]
        graph, src = graphs[name]
        fused_runs = []
        for strategy in CUSTOM_STRATEGIES:
            fused_runs.append(engine.run(graph, src, make_strategy(strategy),
                                         op=op, mode="fused", device=dev))
            if strategy == "WD" or graph is not g:
                r = engine.run(graph, src, make_strategy(strategy), op=op,
                               mode="stepped", device=dev)
                agree(name, r, fused_runs[-1])
                if strategy == "WD":
                    stepped[(name, "stepped")] = r
            agree(name, fused_runs[-1], fused_runs[0], counts=False)
        emit("subword_run", graph=gname if graph is g else "dag",
             op=op.name, dtype=str(op.dtype).removeprefix("torch."),
             strategies=list(CUSTOM_STRATEGIES),
             stepped=["WD"] if graph is g else list(CUSTOM_STRATEGIES),
             iterations=[r.iterations for r in fused_runs],
             edges_relaxed=[r.edges_relaxed for r in fused_runs],
             fused_seconds=[r.traversal_seconds for r in fused_runs])

    for name in ops:
        counted(name, lambda name=name: big_runs(name))
    step("full_size_runs")

    small_dag = layered_dag(SUBWORD_DAG[0], SUBWORD_DAG[1] >> 4,
                            SUBWORD_DAG[2], dev)
    small_graphs = {name: (small_dag, 0) if name in adds else (small, s_src)
                    for name in ops}
    road = road_grid_graph(side=road_side, weighted=True, seed=4, device=dev)
    road_src = int(road.degrees.argmax())
    sources = batch_sources(small, BATCH_K)

    path_steps = {}

    def path_step(what, t0):
        """Adds the seconds since ``t0`` to ``what``'s, over the
        operators; returns now."""
        now = time.perf_counter()
        path_steps[what] = path_steps.get(what, 0.0) + now - t0
        return now

    def paths(name):
        """rmat16: the six strategies on the card, stepped equal to fused,
        equal to each other and WD to the CPU's stepped run; a K = 8
        batch, stepped and fused, equal to its rows; two shards equal to
        one device; a min or max operator's delta runs, stepped equal to
        fused, and the two SSSPs' to a Dijkstra in their type."""
        op = ops[name]
        graph, src = small_graphs[name]
        card = []
        t0 = time.perf_counter()
        for s in CUSTOM_STRATEGIES:
            card.append(engine.run(graph, src, make_strategy(s), op=op,
                                   mode="fused", device=dev))
            agree(name, engine.run(graph, src, make_strategy(s), op=op,
                                   mode="stepped", device=dev), card[-1])
            agree(name, card[0], card[-1], counts=False)
        t0 = path_step("card_runs", t0)
        agree(name, card[CUSTOM_STRATEGIES.index("WD")], engine.run(
            graph, src, make_strategy("WD"), op=op, mode="stepped",
            device="cpu"))
        t0 = path_step("cpu_run", t0)
        batch_src = [0, 1, 5, 5] if name in adds else sources
        singles = [engine.run(graph, int(s), make_strategy("WD"), op=op,
                              mode="fused", device=dev) for s in batch_src]
        for mode in ("stepped", "fused"):
            b = engine.run_batch(graph, batch_src, op=op, mode=mode,
                                 device=dev)
            for row, r in zip(b.dist, singles):
                float_err([torch.from_numpy(row)],
                          [torch.from_numpy(r.dist)], op, SUBWORD_ADD_RTOL)
        t0 = path_step("batch", t0)
        agree(name, engine.run(graph, src, make_strategy("WD"), op=op,
                               mode="fused", shards=2, device=dev),
              card[CUSTOM_STRATEGIES.index("WD")])
        t0 = path_step("shards", t0)
        out = dict(op=op.name, graph=f"rmat{small_scale}"
                   if graph is small else "small_dag",
                   cpu_equal=True, batch_k=len(batch_src),
                   batch_equals_rows=True, shards=2, sharded_equal=True)
        if name not in adds:
            delta = [engine.run(road, road_src, make_strategy("WD"), op=op,
                                mode=mode, schedule="delta",
                                delta=ROAD_DELTA, device=dev)
                     for mode in ("stepped", "fused")]
            agree(name, *delta)
            t0 = path_step("delta", t0)
            out.update(road=f"road{road_side}", delta=ROAD_DELTA,
                       epochs=delta[1].iterations)
            if name in ("bf16_sssp", "i16_sssp"):
                if name == "bf16_sssp":
                    want = bf16_dijkstra(road, road_src)
                else:       # the distances fit int16; unreached: identity
                    d = dijkstra_oracle(road, road_src, True)
                    want = np.where(d >= INF, op.identity, d).astype(
                        np.int16)
                if not np.array_equal(delta[1].dist, want):
                    raise AssertionError(f"{name} delta != Dijkstra in "
                                         f"its type")
                out.update(equals_dijkstra=True)
                path_step("dijkstra", t0)
        emit("subword_paths", **out)

    for name in ops:
        counted(name, lambda name=name: paths(name))
    step("paths")
    emit("subword_path_steps", seconds=path_steps)
    for name in ops:
        emit("subword_launches", op=ops[name].name, launches=launches[name])
        for _, key, _, _ in CUSTOM_KERNELS:
            if launches[name][key] < 1:
                raise AssertionError(f"{name} never launched {key}: "
                                     f"{launches[name]}")

    # the fused kernel against its plain loop on the same card tensors:
    # WD on rmat20 (the DAG for add), and the delta kernel on road64
    # against its plain loop on CPU copies (the card tests take road128,
    # every strategy)
    strat = make_strategy("WD")
    road = road_grid_graph(side=road_side // 4, weighted=True, seed=4,
                           device=dev)
    road_src = int(road.degrees.argmax())
    for name, op in ops.items():
        graph, src = graphs[name]
        args, kw = fused_args(graph, "WD", src, op, dev)
        got = fused_kernel.fixed_point(*args, **kw)
        want = fused._fixed_point_plain(*args, **kw)
        if got[1:] != want[1:]:
            raise AssertionError(f"fused {name} WD counts")
        fused_err[name] = float_err([got[0]], [want[0]], op,
                                    SUBWORD_ADD_RTOL)
        if name in adds:
            continue
        plan = priority.plan_delta(strat, strat.setup(road), road, op=op,
                                   delta=ROAD_DELTA)
        dist0 = torch.full((road.num_nodes,), op.identity, dtype=op.dtype,
                           device=dev)
        dist0[road_src] = op.seed(road_src)
        mask0 = torch.zeros(road.num_nodes, dtype=torch.bool, device=dev)
        mask0[road_src] = True
        dkw = dict(op=op, sched=plan.sched, delta=plan.delta,
                   max_iterations=100000)
        got = fused_kernel.delta_fixed_point(
            plan.kernel, plan.light, plan.heavy_graph, plan.aux, dist0,
            mask0, **dkw)
        heavy = plan.heavy_graph
        want = priority._delta_fixed_point_plain(
            plan.kernel, plan.light.to("cpu"),
            None if heavy is None else heavy.to("cpu"),
            None if plan.aux is None else plan.aux.cpu(), dist0.cpu(),
            mask0.cpu(), **dkw)
        float_err(got[:2], want[:2], op, SUBWORD_ADD_RTOL)
        if got[2:] != want[2:]:
            raise AssertionError(f"{name} delta kernel != plain loop")
    emit("subword_fused_vs_plain",
         graphs=[gname, "dag", f"road{road_side // 4} delta (CPU copies)"],
         max_err=fused_err, equal=True)
    step("fused_vs_plain")

    # the kernel line's rows, each sub-word instance timed
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)   # > L2
    kept = batch_calls(g, dev, batch_sources(g, BATCH_K), widest_only=True)[0]
    # the lanes and the frontier of the B2 and B1 rows, one set for every
    # operator
    lanes = lane_inputs(rng, g.num_nodes, 8 * g.num_nodes, dev)
    front = wd_inputs(g, rng, g.num_nodes, 0, dev)
    rows = []
    for name, op in ops.items():
        graph, src = graphs[name]
        vals = subword_values(rng, op, g.num_nodes, dev)
        if vals.is_floating_point():
            vals = torch.where(vals.isnan() | vals.isinf(),
                               torch.zeros_like(vals), vals)
        c = dict(kept, dist_t=kept["dist_t"].clamp(
            max=30000 if op.dtype == torch.int16 else 100).to(op.dtype))
        timed_rows = {
            "relax_lanes": time_b2(lanes, vals, op, 5, flush),
            "wd_relax_lanes": time_b1(g, front, vals, op, 5, flush),
            "wd_relax_lanes_batch": b1_batch_time(g, c, reps=5, op=op)}
        args, kw = fused_args(graph, "WD", src, op, dev)
        wd = stepped[(name, "stepped")]
        bound_ms, bound_by = bound(run_bytes(graph, wd,
                                             args[3].element_size()), 0)
        timed_rows["fused_fixed_point"] = dict(
            ms=time_ms(lambda: fused_kernel.fixed_point(*args, **kw),
                       reps=5),
            plain_ms=time_ms(lambda: fused._fixed_point_plain(*args, **kw),
                             reps=1),
            bound_ms=bound_ms, bound_by=bound_by,
            shape=dict(graph=gname if graph is g else "dag", run="WD",
                       iterations=wd.iterations,
                       edges_relaxed=wd.edges_relaxed))
        for kernel, key, src_file, replaces in CUSTOM_KERNELS:
            e = (fused_err[name] if kernel == "fused_fixed_point"
                 else err[(name, kernel)])
            rows.append(dict(
                name=f"{kernel}<{op.name}>", route="cuda", source=src_file,
                replaces=replaces, launches=launches[name][key],
                max_abs_err=e[0], max_rel_err=e[1], library_ms=None,
                op=op.name, dtype=str(op.dtype).removeprefix("torch."),
                registers=builds[name]["attrs"][
                    "wd_relax_union" if kernel == "wd_relax_lanes_batch"
                    else kernel]["registers"],
                **timed_rows[kernel]))
    emit("subword_kernels_time", rows=rows, nvidia_smi=nvidia_smi())
    step("timing")
    emit("subword_phase_steps", seconds=steps)
    return rows


# ---------------------------------------------------------------------------
# phases 5-7: the LM serving slice (B4, B5)
# ---------------------------------------------------------------------------

ATTN_HEADS = (16, 8, 128)       # qwen3_0_6b: query heads, KV heads, hd
#: granite_moe_3b_a800m's B4 shape: a group of 3 query heads a KV head
GRANITE_HEADS = (24, 8, 64)
#: deepseek_v3_671b's MLA prefill: 128 query heads, each its own K/V head,
#: q/k head dim nope 128 + rope 64, v head dim 128
MLA_HEADS = (128, 128, 192, 128)
#: llama_3_2_vision_11b's cross-attention: 32 query heads over 8, hd 128,
#: over its 1601 image tokens (non-causal)
CROSS_HEADS = (32, 8, 128)
IMAGE_TOKENS = 1601
SSD_SHAPE = (8, 256, 48, 64, 128)   # mamba2_780m at S = 2048: BN c H P N
#: B4's cases: S, dtype name, causal
ATTN_TIMED = ((512, "bfloat16", True), (2048, "bfloat16", True),
              (512, "float32", True), (512, "bfloat16", False),
              (1000, "bfloat16", True))
#: B5's cases: c, dtype name (BN, H, P, N of ``SSD_SHAPE``)
SSD_TIMED = ((256, "bfloat16"), (256, "float32"), (200, "bfloat16"))
#: tolerances against the plain version.  bf16 B5 is held to 1e-4, ten
#: times its measured error: its f32 factors ``CB∘L`` and ``B∘decay``
#: enter the tensor cores as bf16 hi + lo terms (16 significant bits),
#: and a kernel that kept only the hi term would miss by far more
ATTN_TOL = {"bfloat16": 2e-2, "float32": 2e-6}
SSD_TOL = {"bfloat16": 1e-4, "float32": 1e-5}


def attention_inputs(S: int, dtype, g, dev, heads=ATTN_HEADS, Sk=None):
    """Seeded q, k, v of one B4 case at the path's heads (``heads`` is
    (Hq, Hkv, hd) or (Hq, Hkv, hd, hd_v)); ``Sk`` keys (default S)."""
    import torch
    hq, hkv, hd, *rest = heads
    hd_v, Sk = (rest[0] if rest else hd), Sk or S
    return tuple(torch.randn(1, h, n, d, generator=g).to(dev, dtype)
                 for h, n, d in ((hq, S, hd), (hkv, Sk, hd), (hkv, Sk, hd_v)))


def ssd_inputs(c: int, dtype, g, dev):
    """Seeded x̄, cum, B, C of one B5 case at the path's heads."""
    import torch
    BN, _, H, P, N = SSD_SHAPE
    xb = (torch.randn(BN, c, H, P, generator=g) * 0.1).to(dev, dtype)
    cum = torch.cumsum(-torch.randn(BN, c, H, generator=g).abs() * 0.05,
                       1).to(dev)
    Bm, Cm = ((torch.randn(BN, c, N, generator=g) * 0.3).to(dev, dtype)
              for _ in range(2))
    return xb, cum, Bm, Cm


def _allclose_err(got, want, tol: float) -> float:
    """max |got - want|; raises unless |got - want| <= tol + tol·|want|
    everywhere (``tests/test_kernels.py``'s check)."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"output {tuple(got.shape)}/{got.dtype} vs "
                             f"plain {tuple(want.shape)}/{want.dtype}")
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    if not bool(((g - w).abs() <= tol + tol * w.abs()).all()):
        raise AssertionError(f"kernel != plain version: max |err| {err} "
                             f"at tolerance {tol}")
    return err


def lm_kernel_phase(dev, reps: int = 10) -> list:
    """Hold B4 and B5 against their plain versions on the card; time each
    case beside its plain version (and B4 beside SDPA).  Returns the two
    kernel rows of the final line, timed at the path's largest shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.kernels.cost import attention_cost, ssd_cost

    g = torch.Generator().manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > L2
    rows = []
    b4_err, b4_row = 0.0, None
    # each config's own row: heads, S, dtype, causal, Sk
    config_cases = {
        "granite_moe_3b_a800m": (GRANITE_HEADS, 2048, "bfloat16", True,
                                 None),
        "deepseek_v3_671b": (MLA_HEADS, 2048, "bfloat16", True, None),
        "llama_3_2_vision_11b": (CROSS_HEADS, 2048, "bfloat16", False,
                                 IMAGE_TOKENS)}
    config_rows = {}
    cases = [(ATTN_HEADS, *case, None) for case in ATTN_TIMED] + list(
        config_cases.values())
    for heads, S, dtype_name, causal, Sk in cases:
        dtype = getattr(torch, dtype_name)
        q, k, v = attention_inputs(S, dtype, g, dev, heads, Sk)
        tol = ATTN_TOL[dtype_name]
        err = _allclose_err(fa.flash_attention(q, k, v, causal=causal),
                            fa.flash_attention_plain(q, k, v, causal=causal),
                            tol)
        nbytes, ops = attention_cost(S, dtype, causal, heads, Sk)
        t_b, by = bound(nbytes, ops, peak_rate(dtype))
        case = dict(
            Hq=heads[0], Hkv=heads[1], hd=heads[2], hd_v=v.shape[-1],
            S=S, Sk=k.shape[2], dtype=str(dtype).split(".")[-1],
            causal=causal,
            max_abs_err=err, tolerance=tol,
            ms=time_ms(lambda: fa.flash_attention(q, k, v, causal=causal),
                       reps=reps, flush=flush),
            plain_ms=time_ms(lambda: fa.flash_attention_plain(
                q, k, v, causal=causal), reps=reps, flush=flush),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), reps=reps,
                flush=flush),
            bound_ms=t_b, bound_by=by, bytes=nbytes, flop=ops)
        emit("lm_kernel_case", kernel="flash_attention", **case)
        config = next((c for c, cc in config_cases.items()
                       if cc == (heads, S, dtype_name, causal, Sk)), None)
        if config is not None:
            config_rows[config] = case
            continue
        b4_err = max(b4_err, err)
        if (S, dtype, causal) == (2048, torch.bfloat16, True):
            b4_row = case
    for config, row in [("qwen3_0_6b", dict(b4_row, max_abs_err=b4_err))] + [
            (c, config_rows[c]) for c in config_cases]:
        rows.append(dict(
            name="flash_attention", route="cuda", source=CSRC_FLASH,
            replaces="src/repro/kernels/flash_attention.py:69", launches=0,
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            config=config, shape={key: row[key] for key in (
                "Hq", "Hkv", "hd", "hd_v", "S", "Sk", "dtype", "causal")}))

    b5_err, b5_row = 0.0, None
    BN, c, H, P, N = SSD_SHAPE
    for c_len, dtype_name in SSD_TIMED:
        dtype = getattr(torch, dtype_name)
        xb, cum, Bm, Cm = ssd_inputs(c_len, dtype, g, dev)
        tol = SSD_TOL[dtype_name]
        got = sc.ssd_chunk_dual(xb, cum, Bm, Cm)
        want = sc.ssd_chunk_dual_plain(xb, cum, Bm, Cm)
        err = max(_allclose_err(a, b, tol) for a, b in zip(got, want))
        b5_err = max(b5_err, err)
        nbytes, ops = ssd_cost(BN, c_len, H, P, N, dtype)
        # the units that do the work: bf16 tensor cores for bf16 inputs,
        # the CUDA cores' f32 rate for f32 inputs
        t_b, by = bound(nbytes, ops, peak_rate(dtype))
        case = dict(
            BN=BN, c=c_len, H=H, P=P, N=N, dtype=str(dtype).split(".")[-1],
            max_abs_err=err, tolerance=tol,
            ms=time_ms(lambda: sc.ssd_chunk_dual(xb, cum, Bm, Cm), reps=reps,
                       flush=flush),
            plain_ms=time_ms(lambda: sc.ssd_chunk_dual_plain(xb, cum, Bm, Cm),
                             reps=reps, flush=flush),
            library_ms=None, bound_ms=t_b, bound_by=by, bytes=nbytes,
            flop=ops)
        emit("lm_kernel_case", kernel="ssd_chunk_dual", **case)
        if (c_len, dtype) == (c, torch.bfloat16):
            b5_row = case
    rows.append(dict(
        name="ssd_chunk_dual", route="cuda", source=CSRC_SSD,
        replaces="src/repro/kernels/ssd_chunk.py:53", launches=0,
        max_abs_err=b5_err, ms=b5_row["ms"], plain_ms=b5_row["plain_ms"],
        bound_ms=b5_row["bound_ms"], bound_by=b5_row["bound_by"],
        library_ms=None, config="mamba2_780m",
        shape=dict(BN=BN, c=c, H=H, P=P, N=N, dtype="bfloat16")))
    return rows


#: a routing disagreement between the card and the CPU fails when the
#: CPU's k-th and (k+1)-th router probabilities differ by more: float32
#: noise at probabilities near 1/40
ROUTE_GAP_TOL = 1e-6


def routing_compare(card: list, cpu: list, k: int) -> dict:
    """The routing ids of every MoE layer and call of two runs (each a
    list of ``(layer, router_logits, ids)``, from the ``aux`` that
    ``LanguageModel._block`` returns for an MoE layer), compared in order (the order of a
    token's k experts sets its assignments' queue positions, so what
    drops).  Each disagreement is listed with its layer, call, token, the
    first of the k places where the ids differ, and the gap between the
    CPU's router probabilities at that place and the next (the k-th and
    (k+1)-th for a different expert); it is a failure when that gap
    exceeds :data:`ROUTE_GAP_TOL`."""
    import torch
    if [e[0] for e in card] != [e[0] for e in cpu]:
        raise AssertionError("the runs recorded different MoE layers")
    flips = []
    calls: dict = {}
    for (layer, _, ids_g), (_, logits_c, ids_c) in zip(card, cpu):
        call = calls[layer] = calls.get(layer, -1) + 1
        differ = ids_g.cpu() != ids_c                      # [B,S,k]
        if not bool(differ.any()):
            continue
        probs = torch.softmax(logits_c.float(), -1).sort(
            -1, descending=True).values
        for b, t in differ.any(-1).nonzero().tolist():
            j = int(differ[b, t].to(torch.uint8).argmax())
            flips.append(dict(layer=layer, call=call, token=t, row=b,
                              place=j, gap=float(probs[b, t, j]
                                                 - probs[b, t, j + 1])))
    bad = [f for f in flips if f["gap"] > ROUTE_GAP_TOL]
    return dict(entries=len(card), flips=flips, failed=len(bad))


#: a cross layer's gate in the CPU comparisons: at init it is 0, and
#: tanh(0) = 0 would hide the whole cross path
CROSS_GATE = 0.5


def open_gates(model, value: float = CROSS_GATE) -> None:
    """Set every cross layer's ``gate`` of ``model`` to ``value``."""
    import torch
    with torch.no_grad():
        for blk in model.layers:
            if "cross" in blk.tree():
                blk["cross"]["gate"].fill_(value)


def model_inputs(cfg, batch: int, prompt_len: int, seed: int = 1):
    """Seeded prompts [batch, S] (audio [batch, S, K]) and, for a vision
    config, seeded stub image embeddings [batch, T, D] (float32, on the
    CPU)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    shape = (batch, prompt_len) + ((cfg.num_codebooks,)
                                   if cfg.num_codebooks else ())
    prompt = torch.as_tensor(rng.integers(2, cfg.vocab_size, shape))
    vision = (torch.from_numpy(rng.standard_normal(
        (batch, cfg.num_image_tokens, cfg.d_model)).astype(np.float32))
        if cfg.cross_attn_every else None)
    return prompt, vision


def lm_cpu_phase(dev, arch: str, prompt_len: int, rel_tol: float,
                 steps: int = 4, **overrides) -> None:
    """One token config at full width in float32 (``overrides`` cut its
    depth): the same seeded weights on the card and on the CPU, a prefill
    and ``steps`` greedy decode steps on each.  Every logit agrees within
    ``rel_tol`` of the largest, and the greedy tokens are equal.  For MLA
    also :func:`mla_decode_check` on the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import LanguageModel

    full = get_config(arch)
    cfg = dataclasses.replace(full, dtype="float32", **overrides)
    t0 = time.perf_counter()
    cpu_model = LanguageModel(cfg, seed=0, device="cpu")
    card_model = copy.deepcopy(cpu_model).to_device(dev)
    init_s = time.perf_counter() - t0
    prompt, _ = model_inputs(cfg, 1, prompt_len)
    runs = {}
    for name, model in (("cuda", card_model), ("cpu", cpu_model)):
        d = model.device
        t0 = time.perf_counter()
        cache = model.new_cache(1, prompt_len + steps + 1)
        logits, cache = model(prompt.to(d), cache=cache)
        full_l, outs, toks = logits.float().cpu(), [], []
        for t in range(steps):
            tok = torch.argmax(logits[:, -1], dim=-1)
            toks.append(tok.tolist())
            logits, cache = model.decode_step(cache, tok[:, None],
                                              prompt_len + t)
            outs.append(logits[:, -1].float().cpu())
        runs[name] = (full_l, outs, toks, time.perf_counter() - t0)
    (full_g, outs_g, toks_g, sec_g), (full_c, outs_c, toks_c, sec_c) = (
        runs["cuda"], runs["cpu"])
    scale = float(full_c.abs().max())
    diff = (full_g - full_c)[0]                         # [S, (K,) V]
    rms_rel = float(diff.pow(2).mean().sqrt() / full_c.pow(2).mean().sqrt())
    dec_errs = [float((a - b).abs().max()) for a, b in zip(outs_g, outs_c)]
    err = max(float(diff.abs().max()), *dec_errs)
    ok = (err <= rel_tol * scale and toks_g == toks_c
          and bool(torch.isfinite(full_g).all()))
    reduced = {k: [getattr(full, k), v] for k, v in overrides.items()}
    emit("lm_cpu_compare", arch=arch, dtype="float32", prompt=prompt_len,
         steps=steps, reduced=reduced, logits_shape=list(full_c.shape),
         logit_scale=scale, prefill_max_abs_err=float(diff.abs().max()),
         prefill_rms_rel_err=rms_rel, decode_max_abs_err=dec_errs,
         tolerance=rel_tol * scale, tokens_cuda=toks_g, tokens_cpu=toks_c,
         equal=ok, init_seconds=init_s, cuda_seconds=sec_g,
         cpu_seconds=sec_c, host_free_gb=host_free_gb())
    if not ok:
        raise AssertionError(f"{arch}: card != cpu")
    if cfg.attention == "mla":
        mla_decode_check(card_model, prompt.to(dev)[:, :260])


def host_free_gb() -> float:
    """The host's available memory in GB (``/proc/meminfo``)."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) / 1e6
    return float("nan")


#: teacher-forced, a layer's output on the card against the CPU's, as a
#: share of its largest magnitude: granite's attention logits reach
#: |q| ~ 40 (the reference's init scales wq by 1/sqrt(heads)) and its
#: attention output ~320, where float32 summation order moves a layer's
#: output by ~2e-5 of its scale (measured on an H100 80GB HBM3, 700 W)
FORCED_LAYER_TOL = 1e-4
#: the embeddings' relative perturbation of the CPU's own conditioning run
#: (a few float32 ulps)
SELF_PERTURBATION = 2.0 ** -22
#: free-running, the card's logit deviation from the CPU and its routing
#: flips may reach this multiple of the CPU's own perturbed run's, from
#: the same call (measured on an H100 80GB HBM3, 700 W: 1.6x the
#: deviation, 1.5x the flips)
FREE_RUN_FACTOR = 4


def moe_route(routes: list, i: int, aux) -> None:
    """Append layer ``i``'s routing to ``routes`` when ``aux`` (what
    ``LanguageModel._block`` returned) is an MoE layer's."""
    if aux is not None:
        routes.append((i, aux["router_logits"], aux["ids"]))


def lm_cpu_forced_phase(dev, arch: str, prompt_len: int, num_layers: int,
                        steps: int = 4, rel_tol: float = 1e-3) -> None:
    """A config without qk-norm (an MoE, vision or audio config) at full
    width in float32 (TF32 off), ``num_layers`` of its layers, the same
    seeded weights on the card and on the CPU (cross layers' gates at
    :data:`CROSS_GATE`, seeded image embeddings): a prefill of
    ``prompt_len`` tokens and ``steps`` greedy decode steps,
    teacher-forced: every layer on the card takes the CPU's input to that
    layer (and fills its own cache).  Each layer's output agrees within
    :data:`FORCED_LAYER_TOL` of its largest magnitude, an MoE layer's
    routing ids are compared (:func:`routing_compare`; a disagreement
    fails above :data:`ROUTE_GAP_TOL`), the logits within ``rel_tol`` of
    the largest, the greedy tokens (one a codebook for audio) are
    equal.

    Then both models run free, prefill only, beside the CPU run with its
    embeddings perturbed by :data:`SELF_PERTURBATION` (``lm_cpu_free``).
    A random-init model without qk-norm amplifies float32 noise through
    layers (routing flips, then attention), so free-running card-vs-CPU
    logits measure the model's conditioning, which the CPU's own
    perturbed run shows beside them: the card's logit deviation and its
    routing flips fail above :data:`FREE_RUN_FACTOR` times the perturbed
    run's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.model import LanguageModel

    full = get_config(arch)
    cfg = dataclasses.replace(full, dtype="float32", num_layers=num_layers)
    t0 = time.perf_counter()
    cpu_model = LanguageModel(cfg, seed=0, device="cpu")
    open_gates(cpu_model)
    card_model = copy.deepcopy(cpu_model).to_device(dev)
    init_s = time.perf_counter() - t0
    prompt, vision = model_inputs(cfg, 1, prompt_len)
    length = prompt_len + steps + 1
    caches = (cpu_model.new_cache(1, length), card_model.new_cache(1, length))
    layer_err = [0.0] * num_layers
    card_routes, cpu_routes = [], []
    logits_err, tokens_cpu, tokens_card, scale = [], [], [], 0.0

    def forced(tokens, mode, position):
        nonlocal scale
        positions = (torch.arange(tokens.shape[1], dtype=torch.int32)[None]
                     if mode == "prefill" else None)
        h = cpu_model.embed_tokens(tokens)
        for i in range(num_layers):
            want, aux_c = cpu_model._block(i, h, positions, caches[0], mode,
                                           position, vision)
            got, aux_g = card_model._block(
                i, h.to(dev), None if positions is None else
                positions.to(dev), caches[1], mode, position,
                None if vision is None else vision.to(dev))
            layer_err[i] = max(layer_err[i], float(
                (got.cpu() - want).abs().max() / want.abs().max()))
            moe_route(card_routes, i, aux_g)
            moe_route(cpu_routes, i, aux_c)
            h = want
        lc = cpu_model.unembed(rmsnorm(cpu_model.final_norm, h))[0, -1]
        lg = card_model.unembed(rmsnorm(card_model.final_norm,
                                        h.to(dev)))[0, -1].cpu()
        scale = max(scale, float(lc.abs().max()))
        logits_err.append(float((lg - lc).abs().max()))
        nxt = torch.argmax(lc, dim=-1)             # [] or, audio, [K]
        tokens_cpu.append(nxt.tolist())
        tokens_card.append(torch.argmax(lg, dim=-1).tolist())
        return nxt.reshape((1, 1) + tuple(nxt.shape))

    t0 = time.perf_counter()
    with torch.no_grad():
        nxt = forced(prompt, "prefill", None)
        for t in range(steps):
            nxt = forced(nxt, "decode", prompt_len + t)
    forced_s = time.perf_counter() - t0
    routing = routing_compare(card_routes, cpu_routes, cfg.experts_per_token)
    ok = (max(layer_err) <= FORCED_LAYER_TOL and not routing["failed"]
          and max(logits_err) <= rel_tol * scale
          and tokens_card == tokens_cpu)
    reduced = {"num_layers": [full.num_layers, num_layers]}
    if cfg.moe:
        emit("lm_cpu_routing", arch=arch, num_layers=num_layers,
             gap_tolerance=ROUTE_GAP_TOL, teacher_forced=True, **routing)
    emit("lm_cpu_compare", arch=arch, dtype="float32", prompt=prompt_len,
         steps=steps, teacher_forced=True, reduced=reduced,
         layer_rel_err=layer_err, layer_tolerance=FORCED_LAYER_TOL,
         logit_scale=scale, logits_max_abs_err=logits_err,
         tolerance=rel_tol * scale, tokens_cuda=tokens_card,
         tokens_cpu=tokens_cpu, equal=ok, init_seconds=init_s,
         forced_seconds=forced_s)

    # free-running, beside the CPU's own conditioning
    def free(model, emb_scale=None):
        """A cacheless prefill of the prompt, the layers run as
        ``forward`` runs them, and each MoE layer's routing."""
        routes = []
        with torch.no_grad():
            if emb_scale is not None:
                model.embed.mul_(emb_scale)
            h = model.embed_tokens(prompt.to(model.device))
            positions = torch.arange(prompt_len, dtype=torch.int32,
                                     device=model.device)[None]
            vis = None if vision is None else vision.to(model.device)
            for i in range(num_layers):
                h, aux = model._block(i, h, positions, None, "prefill",
                                      None, vis)
                moe_route(routes, i, aux)
            logits = model.unembed(rmsnorm(model.final_norm, h))
        return logits.float().cpu(), routes
    base, base_routes = free(cpu_model)
    card_l, card_r = free(card_model)
    noise = 1 + (torch.rand(cfg.vocab_size, 1, generator=torch.Generator()
                            .manual_seed(3)) - 0.5) * 2 * SELF_PERTURBATION
    pert_l, pert_r = free(copy.deepcopy(cpu_model), noise)

    def flips(a, b):
        return [int((x[2].cpu() != y[2]).any(-1).sum()) for x, y in zip(a, b)]
    free_scale = float(base.abs().max())
    card_free = dict(rel_err=float((card_l - base).abs().max()) / free_scale,
                     flips=flips(card_r, base_routes))
    pert_free = dict(perturbation=SELF_PERTURBATION,
                     rel_err=float((pert_l - base).abs().max()) / free_scale,
                     flips=flips(pert_r, base_routes))
    limits = dict(rel_err=FREE_RUN_FACTOR * pert_free["rel_err"],
                  flips=FREE_RUN_FACTOR * sum(pert_free["flips"]))
    finite = bool(torch.isfinite(card_l).all())
    free_ok = (finite and card_free["rel_err"] <= limits["rel_err"]
               and sum(card_free["flips"]) <= limits["flips"])
    emit("lm_cpu_free", arch=arch, num_layers=num_layers, prompt=prompt_len,
         logit_scale=free_scale, card_vs_cpu=card_free,
         cpu_perturbed_vs_cpu=pert_free, factor=FREE_RUN_FACTOR,
         limits=limits, finite=finite, equal=free_ok)
    if not ok:
        raise AssertionError(f"{arch}: card != cpu (teacher-forced)")
    if not free_ok:
        raise AssertionError(f"{arch}: card != cpu (free-running, past "
                             f"{FREE_RUN_FACTOR}x the CPU's own "
                             f"perturbed run)")


def prefill_kernel_ms(dev, cfg, kernel: str, lens) -> float:
    """The serving run's kernel time in its prefills, estimated: the
    kernel timed alone on random inputs of each prompt's shape, times the
    layers.  Run after the launch counts are read."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_chunk import ssd_chunk_dual
    g = torch.Generator().manual_seed(1)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g).to(dev, dtype)
    total = 0.0
    for S in (int(n) for n in lens):
        if kernel == "flash_attention":
            hd = cfg.resolved_head_dim
            mla = cfg.attention == "mla"
            hkv = cfg.num_heads if mla else cfg.num_kv_heads
            q = randn(1, cfg.num_heads, S, hd)
            k, v = randn(1, hkv, S, hd), randn(
                1, hkv, S, cfg.v_head_dim if mla else hd)
            ms = time_ms(lambda: flash_attention(q, k, v), reps=5)
        else:
            c = min(cfg.ssm_chunk, S)
            BN, H, P, N = -(-S // c), cfg.ssm_heads, cfg.ssm_head_dim, \
                cfg.ssm_state
            xb, Bm, Cm = randn(BN, c, H, P), randn(BN, c, N), randn(BN, c, N)
            cum = torch.cumsum(-randn(BN, c, H, dtype=torch.float32).abs()
                               * 0.05, 1)
            ms = time_ms(lambda: ssd_chunk_dual(xb, cum, Bm, Cm), reps=5)
        total += cfg.num_layers * ms
    return total


def traced_prefill(dev, model, kernel_sym: str, S: int = 2048,
                   untraced_reps: int = 5) -> dict:
    """One ``S``-token prefill of ``model`` under ``torch.profiler``, after
    an untraced warm-up: the device time of kernels named ``kernel_sym``
    over all device time, the number of device activities, and the device
    idle share.  The profiler adds host cost to every op, so the idle
    share divides the traced device time by the median wall time of
    ``untraced_reps`` untraced prefills of the same prompt (the traced
    wall time is printed beside it)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    prompt = torch.as_tensor(np.random.default_rng(3).integers(
        2, model.cfg.vocab_size, S)[None], device=dev)

    def prefill():
        logits, _ = model(prompt, cache=model.new_cache(1, S + 1))
        return logits
    prefill()
    torch.cuda.synchronize()
    walls = []
    for _ in range(untraced_reps):
        t0 = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_untraced = statistics.median(walls)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = prefill()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError("traced prefill gave non-finite logits")
    acts = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time for e in acts)
    kern_us = sum(e.device_time for e in acts if kernel_sym in e.name)
    if not acts or kern_us <= 0:
        raise AssertionError(f"the trace holds no device time of "
                             f"{kernel_sym}: {len(acts)} activities")
    return dict(prompt=S, traced_wall_ms=wall * 1e3,
                untraced_wall_ms=wall_untraced * 1e3,
                untraced_wall_ms_all=[w * 1e3 for w in walls],
                device_ms=busy_us / 1e3, kernel_ms=kern_us / 1e3,
                kernel_share_of_device=kern_us / busy_us,
                device_idle_share=1.0 - busy_us / 1e6 / wall_untraced,
                traced_idle_share=1.0 - busy_us / 1e6 / wall,
                device_activities=len(acts))


def lm_serve_phase(dev, arch: str, kernel: str, *, requests: int = 8,
                   slots: int = 4, max_new: int = 32,
                   max_len: int = 2112, model=None, group=None) -> dict:
    """One config at full width in bf16 through ``ServeLoop`` (``model``
    when given, else the config's, seeded), its MoE layers under
    ``use_group(group)`` when a group is given.  The launch counts are set
    to 0 just before the run and read just after it."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.models.model import LanguageModel
    from repro_torch.moe.sharded import use_group
    from repro_torch.runtime.serve import Request, ServeLoop

    if model is None:
        model = LanguageModel(get_config(arch), seed=0, device=dev)
    cfg = model.cfg
    rng = np.random.default_rng(0)
    lens = rng.integers(256, 2049, requests)
    if all(n % 64 == 0 for n in lens):
        raise AssertionError(f"no ragged prompt among {lens}")
    reqs = [Request(uid=i, prompt=rng.integers(2, cfg.vocab_size, int(n)),
                    max_new_tokens=max_new) for i, n in enumerate(lens)]
    loop = ServeLoop(model, num_slots=slots, max_len=max_len, eos_id=-1,
                     device=dev)
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    t0 = time.perf_counter()
    with use_group(group):
        done = loop.run(reqs)
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    tokens = sum(len(r.generated) for r in done)
    want = {k: 0 for k in LAUNCHES}
    want[kernel] = cfg.num_layers * requests
    ok = (sorted(r.uid for r in done) == list(range(requests))
          and all(len(r.generated) == max_new
                  and all(0 <= t < cfg.vocab_size for t in r.generated)
                  for r in done)
          and loop.nonfinite_logits == 0 and launches == want)
    kernel_ms = prefill_kernel_ms(dev, cfg, kernel, lens)
    with use_group(group):
        emit("lm_prefill_trace", arch=arch, kernel=kernel, **traced_prefill(
            dev, model, {"flash_attention": "flash_bf16_kernel",
                         "ssd_chunk_dual": "ssd_bf16_kernel"}[kernel]))
    emit("lm_serve", arch=arch, card=nvidia_smi(), dtype=cfg.dtype,
         num_layers=cfg.num_layers,
         shards=None if group is None else group.num_shards,
         requests=requests,
         slots=slots, prompt_lens=[int(n) for n in lens], max_new=max_new,
         tokens=tokens, seconds=seconds, tok_per_s=tokens / seconds,
         prefill_ms_median=statistics.median(loop.prefill_seconds) * 1e3,
         prefill_ms_max=max(loop.prefill_seconds) * 1e3,
         decode_ms_median=statistics.median(loop.decode_seconds) * 1e3,
         decode_ms_max=max(loop.decode_seconds) * 1e3,
         prefill_s_total=sum(loop.prefill_seconds),
         decode_s_total=sum(loop.decode_seconds),
         decode_steps=len(loop.decode_seconds),
         prefill_kernel_ms=kernel_ms,
         prefill_kernel_share=kernel_ms / (sum(loop.prefill_seconds) * 1e3),
         nonfinite_logits=loop.nonfinite_logits, launches=launches,
         launches_expected=want, ok=ok)
    if not ok:
        raise AssertionError(f"{arch} serving run failed the checks")
    return launches


# ---------------------------------------------------------------------------
# A15's serving side: deepseek's MLA and sharded MoE, vision, audio,
# pad_heads
# ---------------------------------------------------------------------------

#: deepseek_v3_671b served at full width: its 3 dense layers and 1 MoE
#: layer (of 61), no MTP block (serving never reads it; it would be a
#: second 22.5 GB MoE block), its MoE layers over 8 shards held on the
#: card (the config's moe_impl="shard_map")
DEEPSEEK_CUT = dict(num_layers=4, mtp_depth=0)
DEEPSEEK_SHARDS = 8
#: one full-width MoE layer's dispatch over held shards against the
#: single-device padded dispatch, bf16, as a share of the largest |y|:
#: the same bf16 products; a token's K = 8 expert outputs are summed in
#: bf16 a shard at a time and the shards' partial sums added in bf16 (as
#: the reference's psum of bf16 partials), where the single-device
#: dispatch sums all K at once: up to 8 roundings of 2^-9 of a running
#: sum, which may exceed |y| where the terms cancel (1.4e-2 measured at
#: smoke width on the CPU)
MOE_SHARD_TOL = 4e-2
#: granite's 40 experts padded for 16 shards
GRANITE_SHARDS = 16
#: the absorbed decode (scores over the compressed cache) against the
#: expanded prefill's last position over the same tokens, float32, as a
#: share of the largest logit: one function in two orders of sums
MLA_DECODE_TOL = 1e-3
#: the same in bf16, held to bf16's own effect on the answer: the RMS of
#: decode - prefill (both bf16) at most this multiple of the RMS of the
#: bf16 prefill's deviation from the float32 one.  A random-init MLA
#: model is so conditioned in bf16 that both forms move 25-55% RMS from
#: float32 (measured on the CPU at d 1024, 3 layers), so a bound on the
#: bf16 gap alone would be noise
MLA_DECODE_BF16_FACTOR = 3
#: pad_heads against the unpadded model on the same weights, float32, a
#: layer's output as a share of its largest magnitude
#: (tests/test_head_padding.py's 5e-4)
PAD_HEADS_TOL = 5e-4


def deepseek_model(dev):
    """deepseek_v3_671b at full width, bf16, cut by :data:`DEEPSEEK_CUT`,
    seeded, on the card; with the seconds its weights took and the host's
    free memory before them."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import LanguageModel, model_param_specs
    from repro_torch.models.params import param_count
    full = get_config("deepseek_v3_671b")
    cfg = dataclasses.replace(full, **DEEPSEEK_CUT)
    free = host_free_gb()
    t0 = time.perf_counter()
    model = LanguageModel(cfg, seed=0, device=dev)
    emit("deepseek_model", num_layers=cfg.num_layers,
         reduced={k: [getattr(full, k), v] for k, v in DEEPSEEK_CUT.items()},
         params=param_count(model_param_specs(cfg)),
         init_seconds=time.perf_counter() - t0, host_free_gb_before=free,
         device_gb=torch.cuda.memory_allocated(dev) / 1e9)
    return model


def moe_sharded_phase(dev, model, reps: int = 3) -> None:
    """One full-width deepseek MoE layer (``model``'s, bf16, 256 experts
    top 8, expert d_ff 2048) on 2048 seeded tokens at a capacity where
    nothing drops: ``sharded_moe_dispatch`` and ``ep_global_dispatch``
    over :data:`DEEPSEEK_SHARDS` held shards against the single-device
    ``padded`` dispatch; then granite's 40 experts padded to 48 over
    :data:`GRANITE_SHARDS` shards.  Each timed."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.shard import shard_group
    from repro_torch.models.moe import moe_specs
    from repro_torch.models.params import init_params
    from repro_torch.moe import balancing as mb
    from repro_torch.moe import sharded as sh

    def case(name, cfg, x, router, experts, shards, pad=False):
        """Route once (on the padded logits where ``pad``), then the
        single-device dispatch over the real experts against the
        sharded ones over the (padded) experts."""
        num_experts = cfg.num_experts
        logits = x.float() @ router
        wp, ep = experts, num_experts
        if pad:
            wp, logits, ep = sh.pad_experts(experts, logits, num_experts,
                                            shards)
        w, ids, _ = mb.topk_route(logits, cfg.experts_per_token)
        loads = torch.bincount(ids.reshape(-1), minlength=num_experts)
        cap = int(loads.max())
        want, stats = mb.moe_dispatch(x, ids, w, experts,
                                      num_experts=num_experts,
                                      capacity=cap, method="padded")
        group = shard_group(shards, dev)
        runs = {"single": lambda: mb.moe_dispatch(
            x, ids, w, experts, num_experts=num_experts, capacity=cap,
            method="padded")[0],
            "sharded": lambda: sh.sharded_moe_dispatch(
                x, ids, w, wp, group=group, num_experts=ep, capacity=cap)}
        if not pad:
            runs["ep_global"] = lambda: sh.ep_global_dispatch(
                x, ids, w, wp, group=group, num_experts=ep, capacity=cap)
        scale = float(want.float().abs().max())
        out = dict(case=name, tokens=x.shape[1], experts=num_experts,
                   padded_experts=ep, shards=shards, capacity=cap,
                   dropped_frac=float(stats["dropped_frac"]),
                   tolerance=MOE_SHARD_TOL, scale=scale)
        ok = float(stats["dropped_frac"]) == 0.0
        for key, fn in runs.items():
            got = fn()
            err = float((got.float() - want.float()).abs().max())
            rms = float((got.float() - want.float()).pow(2).mean().sqrt()
                        / want.float().pow(2).mean().sqrt())
            out[key] = dict(max_abs_err=err, rel_err=err / scale,
                            rms_rel=rms, ms=time_ms(fn, reps=reps))
            ok = ok and err <= MOE_SHARD_TOL * scale
        out["ok"] = ok
        emit("moe_sharded", **out)
        if not ok:
            raise AssertionError(f"{name}: sharded dispatch != single")

    g = torch.Generator().manual_seed(1)
    moe = model.layers[3]["moe"]
    x = torch.randn(1, 2048, model.cfg.d_model, generator=g).to(
        dev, torch.bfloat16)
    case("deepseek_v3_671b", model.cfg, x, moe["router"],
         dict(moe["experts"].items()), DEEPSEEK_SHARDS)
    gcfg = get_config("granite_moe_3b_a800m")
    params = init_params(moe_specs(gcfg), torch.Generator().manual_seed(0))
    x = torch.randn(1, 2048, gcfg.d_model, generator=g).to(
        dev, torch.bfloat16)
    case("granite_moe_3b_a800m", gcfg, x, params["router"].to(dev),
         {k: v.to(dev) for k, v in params["experts"].items()},
         GRANITE_SHARDS, pad=True)


def mla_decode_check(model, prompt, steps: int = 4) -> dict:
    """``model`` (float32, MLA, no MoE layer) and its bf16 copy: decode
    step t's logits (absorbed, over the compressed cache) against a
    prefill's last-position logits over the same t + 1 tokens (the
    latents expanded, B4), for ``steps`` steps after ``prompt`` [1, S].
    float32 within :data:`MLA_DECODE_TOL` of the largest logit; bf16
    within :data:`MLA_DECODE_BF16_FACTOR` times the bf16 prefill's RMS
    deviation from the float32 prefill."""
    import torch
    from repro_torch.models.model import model_param_specs
    from repro_torch.models.params import leaves
    m16 = copy.deepcopy(model)
    m16.cfg = dataclasses.replace(model.cfg, dtype="bfloat16")
    dtypes = {p: s.torch_dtype
              for p, s in leaves(model_param_specs(m16.cfg))}
    with torch.no_grad():
        for path, param in leaves(m16.param_tree()):
            param.data = param.data.to(dtypes[path])
    S = prompt.shape[1] - steps
    runs = {}
    for name, m in (("float32", model), ("bfloat16", m16)):
        cache = m.new_cache(1, prompt.shape[1])
        m(prompt[:, :S], cache=cache)
        dec, pre = [], []
        for t in range(S, S + steps):
            dec.append(m.decode_step(cache, prompt[:, t:t + 1], t)[0][0, 0]
                       .float())
            pre.append(m(prompt[:, :t + 1])[0][0, -1].float())
        runs[name] = (dec, pre)
    del m16

    def rms(a, b):
        return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())
    (d32, p32), (d16, p16) = runs["float32"], runs["bfloat16"]
    err32 = [float((a - b).abs().max() / b.abs().max())
             for a, b in zip(d32, p32)]
    gap16 = [rms(a, b) for a, b in zip(d16, p16)]
    floor16 = [rms(a, b) for a, b in zip(p16, p32)]
    ok = (max(err32) <= MLA_DECODE_TOL and all(
        g <= MLA_DECODE_BF16_FACTOR * f for g, f in zip(gap16, floor16)))
    out = dict(prompt=S, steps=steps, float32_rel_err=err32,
               float32_tolerance=MLA_DECODE_TOL, bf16_rms_gap=gap16,
               bf16_rms_vs_float32_prefill=floor16,
               bf16_factor=MLA_DECODE_BF16_FACTOR, argmax_equal_bf16=[
                   int(a.argmax()) == int(b.argmax())
                   for a, b in zip(d16, p16)], ok=ok)
    emit("mla_decode_vs_prefill", **out)
    if not ok:
        raise AssertionError("absorbed decode != expanded prefill")
    return out


def lockstep_phase(dev, arch: str, *, batch: int = 4, prompt_len: int = 1024,
                   steps: int = 16, **overrides) -> dict:
    """A config the ``ServeLoop`` refuses (vision, audio), at full width
    in bf16 (``overrides`` cut its depth), driven as the reference's
    ``build_prefill_step``/``build_serve_step`` drive it: one batch
    prefill of ``batch`` seeded prompts (and image embeddings), then
    ``steps`` lockstep greedy decode steps.  The launch counts are set to
    0 just before the run and read just after it: B4 once a layer and
    once a cross layer of the prefill, none in decode."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.models.model import LanguageModel

    full = get_config(arch)
    cfg = dataclasses.replace(full, **overrides)
    t0 = time.perf_counter()
    model = LanguageModel(cfg, seed=0, device=dev)
    open_gates(model)
    init_s = time.perf_counter() - t0
    prompt, vision = model_inputs(cfg, batch, prompt_len)
    prompt = prompt.to(dev)
    kw = {} if vision is None else {"vision_embeds": vision.to(dev)}
    cache = model.new_cache(batch, prompt_len + steps)
    torch.cuda.synchronize()
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    t0 = time.perf_counter()
    logits, cache = model(prompt, cache=cache, **kw)
    nxt = logits[:, -1:].argmax(-1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    decode_s, finite = [], bool(torch.isfinite(logits).all())
    for t in range(steps):
        t0 = time.perf_counter()
        logits, cache = model.decode_step(cache, nxt, prompt_len + t)
        nxt = logits[:, -1:].argmax(-1)
        finite = finite and bool(torch.isfinite(logits).all())
        decode_s.append(time.perf_counter() - t0)
    launches = dict(LAUNCHES)
    crosses = sum(cfg.layer_is_cross_attn(i) for i in range(cfg.num_layers))
    want = {k: 0 for k in LAUNCHES}
    want["flash_attention"] = cfg.num_layers + crosses
    ok = finite and launches == want and int(nxt.max()) < cfg.vocab_size
    emit("lm_lockstep", arch=arch, card=nvidia_smi(), dtype=cfg.dtype,
         reduced={k: [getattr(full, k), v] for k, v in overrides.items()},
         batch=batch, prompt=prompt_len, image_tokens=(
             cfg.num_image_tokens if cfg.cross_attn_every else 0),
         logits_shape=list(logits.shape), prefill_ms=prefill_s * 1e3,
         decode_ms_median=statistics.median(decode_s) * 1e3,
         decode_ms_all=[d * 1e3 for d in decode_s],
         tok_per_s=batch * steps / sum(decode_s), init_seconds=init_s,
         launches=launches, launches_expected=want, finite=finite, ok=ok)
    if not ok:
        raise AssertionError(f"{arch}: lockstep run failed the checks")
    return launches


def pad_heads_phase(dev, prompt_len: int = 512, num_layers: int = 4) -> None:
    """granite_moe_3b_a800m at full width (``num_layers`` of 32, float32)
    with ``pad_heads=True`` (B4 at 32 query slots over 16 KV heads, hd
    64) against the unpadded model on the same weights (the padded
    model's real query slots moved to the canonical order), on the card,
    teacher-forced as :func:`lm_cpu_forced_phase` holds granite: each
    layer of both takes the unpadded model's input to it, its output
    within :data:`PAD_HEADS_TOL` of its largest magnitude and its
    routing compared (a flip fails above :data:`ROUTE_GAP_TOL`).  The two
    differ in the order of the output projection's sums (24 heads, or 32
    slots with 8 zero pads, permuted); free-running, that float32 noise
    reaches near-tie routes and attention rows (the free-running logits'
    difference is printed)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn
    from repro_torch.models.model import LanguageModel
    from repro_torch.models.params import leaves

    full = get_config("granite_moe_3b_a800m")
    cfg0 = dataclasses.replace(full, dtype="float32", num_layers=num_layers)
    cfg1 = dataclasses.replace(cfg0, pad_heads=True)
    padded = LanguageModel(cfg1, seed=0, device=dev)
    plain = LanguageModel(cfg0, seed=0, device=dev)
    qmap = attn.q_head_map(cfg1)
    sel = [i for i, h in enumerate(qmap) if h >= 0]
    idx = torch.tensor(sel, device=dev)[
        torch.argsort(torch.tensor([qmap[i] for i in sel]))]
    canonical = dict(leaves(plain.param_tree()))
    with torch.no_grad():
        for path, param in leaves(padded.param_tree()):
            if path.endswith("mixer.wq"):
                param = param.index_select(1, idx)
            elif path.endswith("mixer.wo"):
                param = param.index_select(0, idx)
            canonical[path].copy_(param)
    prompt, _ = model_inputs(cfg0, 1, prompt_len, seed=5)
    prompt = prompt.to(dev)
    positions = torch.arange(prompt_len, dtype=torch.int32, device=dev)[None]
    layer_err, routes = [], ([], [])
    with torch.no_grad():
        h = plain.embed_tokens(prompt)
        for i in range(num_layers):
            want, aux0 = plain._block(i, h, positions, None, "prefill", None)
            got, aux1 = padded._block(i, h, positions, None, "prefill", None)
            layer_err.append(float((got - want).abs().max()
                                   / want.abs().max()))
            moe_route(routes[0], i, aux1)
            moe_route(routes[1], i, aux0)
            h = want
    routing = routing_compare(routes[0], [(i, lg.cpu(), ids.cpu()) for
                                          i, lg, ids in routes[1]],
                              cfg0.experts_per_token)
    free = float((padded(prompt)[0] - plain(prompt)[0]).abs().max())
    ok = max(layer_err) <= PAD_HEADS_TOL and not routing["failed"]
    emit("pad_heads", arch="granite_moe_3b_a800m", layout=list(
        attn.head_layout(cfg1)), num_layers=num_layers, prompt=prompt_len,
         teacher_forced=True, layer_rel_err=layer_err,
         tolerance=PAD_HEADS_TOL, routing_flips=routing["flips"],
         free_running_max_abs_err=free, ok=ok)
    if not ok:
        raise AssertionError("pad_heads != the unpadded model")


# ---------------------------------------------------------------------------
# the analysis passes and the kernels' footprint model (ROADMAP A13)
# ---------------------------------------------------------------------------

def analysis_phase(dev) -> None:
    """``python -m repro_torch.analysis src/repro_torch`` in-process: no
    finding.  Then every kernel's block as the ``smem`` pass models it,
    held equal to the card's report: threads, static shared bytes, the
    dynamic shared bytes its launcher requests; and at least the blocks a
    SM its launch bounds promise."""
    import io
    from repro_torch.analysis import smem
    from repro_torch.analysis.__main__ import main as analysis_main
    from repro_torch.core import costmodel

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = analysis_main([str(SRC / "repro_torch"), "--format=json"])
    report = json.loads(out.getvalue())
    emit("analysis", rc=rc, passes=report["passes"], total=report["total"],
         suppressed=report["suppressed"], counts=report["counts"])
    if rc != 0 or report["total"] or report["suppressed"]:
        raise AssertionError(f"analysis findings: {report['findings']}")

    card = costmodel.block_feasibility(dev)
    mismatched = []
    for name, row in card.items():
        fp = smem.row_footprint(row)
        model = dict(threads=fp.threads, static_smem_bytes=fp.static_smem,
                     dynamic_smem_bytes=fp.dynamic_smem)
        seen = {key: row[key] for key in model}
        equal = (seen == model and row["blocks_per_sm"] >= fp.min_blocks
                 and row["feasible"])
        emit("smem_model", row=name, model=model, card=seen,
             min_blocks=fp.min_blocks, blocks_per_sm=row["blocks_per_sm"],
             registers=row["registers"], local_bytes=row["local_bytes"],
             equal=equal)
        if not equal:
            mismatched.append(name)
    if mismatched:
        raise AssertionError(f"smem model != card: {mismatched}")


# ---------------------------------------------------------------------------
# one full-width MoE layer: the four dispatch policies, card against CPU
# ---------------------------------------------------------------------------

#: granite_moe_3b_a800m's MoE layer on a 2048-token prefill
MOE_TOKENS = 2048
#: bf16 dispatch on the card against float32 on the CPU, as a share of
#: the largest |y|: the inputs and weights round to bf16 (2^-9), the
#: products sum over d 1536 and f 512 in float32
MOE_TOL = 3e-2
#: the four bf16 policies on the card against each other: the same bf16
#: products, batched differently (another tiling of the sums)
MOE_POLICY_TOL = 1e-2
#: a capacity that drops: below the mean load of 409.6 a row
MOE_DROP_CAPACITY = 400


def moe_phase(dev, reps: int = 5) -> None:
    """One granite_moe_3b_a800m MoE layer at full width, its weights
    seeded (``init_params``), routed once on the CPU in float32; the four
    dispatch policies in bf16 on the card against float32 on the CPU."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.moe import moe_capacity, moe_specs
    from repro_torch.models.params import init_params
    from repro_torch.moe import balancing as mb

    cfg = dataclasses.replace(get_config("granite_moe_3b_a800m"),
                              dtype="float32")
    params = init_params(moe_specs(cfg), torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, MOE_TOKENS, cfg.d_model, generator=g)
    weights, ids, _ = mb.topk_route(x @ params["router"],
                                    cfg.experts_per_token)
    experts = params["experts"]
    card_experts = {k: v.to(dev, torch.bfloat16) for k, v in experts.items()}
    xc, idc, wc = x.to(dev, torch.bfloat16), ids.to(dev), weights.to(dev)
    loads = torch.bincount(ids.reshape(-1), minlength=cfg.num_experts)
    # the largest load, rounded up to a multiple of multi_round's rounds
    # and of replicate's slot groups: no policy drops an assignment
    step = math.lcm(mb.NUM_ROUNDS, mb.SPLIT_FACTOR)
    no_drop = -(-int(loads.max()) // step) * step

    def run(method, capacity, on_card):
        if on_card:
            return mb.moe_dispatch(xc, idc, wc, card_experts,
                                   num_experts=cfg.num_experts,
                                   capacity=capacity, method=method)
        return mb.moe_dispatch(x, ids, weights, experts,
                               num_experts=cfg.num_experts,
                               capacity=capacity, method=method)

    cases = {}
    card_y = {}
    for method in mb.DISPATCH_METHODS:
        for capacity in (no_drop, MOE_DROP_CAPACITY):
            want, want_stats = run(method, capacity, False)
            got, got_stats = run(method, capacity, True)
            scale = float(want.abs().max())
            err = float((got.float().cpu() - want).abs().max())
            rms = float((got.float().cpu() - want).pow(2).mean().sqrt()
                        / want.pow(2).mean().sqrt())
            stats = {k: (float(got_stats[k]), float(want_stats[k]))
                     for k in want_stats}
            case = dict(method=method, capacity=capacity,
                        max_abs_err=err, rel_err=err / scale, rms_rel=rms,
                        stats_card_cpu=stats,
                        ms=time_ms(lambda: run(method, capacity, True),
                                   reps=reps))
            ok = (err <= MOE_TOL * scale and all(
                a == b for a, b in stats.values()))
            if capacity == no_drop:
                card_y[method] = got.float()
                ok = ok and stats["dropped_frac"] == (0.0, 0.0)
            elif method != "sorted_block":
                ok = ok and stats["dropped_frac"][1] > 0
            case["ok"] = ok
            emit("moe_dispatch", **case)
            cases[(method, capacity)] = case
    ref = card_y["padded"]
    policy_err = {m: float((y - ref).abs().max()) for m, y in card_y.items()}
    # every assignment's queue position: the keep masks of any capacity
    ida = ids.reshape(1, -1)
    pos_cpu, _ = mb._positions(ida, cfg.num_experts)
    pos_card, _ = mb._positions(ida.to(dev), cfg.num_experts)
    same_pos = bool(torch.equal(pos_card.cpu(), pos_cpu))
    emit("moe", d_model=cfg.d_model, experts=cfg.num_experts,
         top_k=cfg.experts_per_token, d_ff=cfg.moe_d_ff, tokens=MOE_TOKENS,
         serving_capacity=moe_capacity(cfg, MOE_TOKENS),
         no_drop_capacity=no_drop, drop_capacity=MOE_DROP_CAPACITY, loads_min=int(loads.min()),
         loads_max=int(loads.max()), tolerance=MOE_TOL,
         policy_tolerance=MOE_POLICY_TOL, policy_max_abs_err=policy_err,
         positions_equal=same_pos)
    scale = float(ref.abs().max())
    if not (all(c["ok"] for c in cases.values()) and same_pos
            and max(policy_err.values()) <= MOE_POLICY_TOL * scale):
        raise AssertionError("moe dispatch: card != cpu")


# ---------------------------------------------------------------------------
# phase 9: training (ROADMAP A15 item 4): B4's and B5's backward kernels,
# one train step card against CPU, qwen3_0_6b and mamba2_780m training
# ---------------------------------------------------------------------------

#: B4's backward cases: name, (Hq, Hkv, hd, hd_v), B, S, Sk, causal,
#: dtypes.  qwen3_0_6b's training shape first: its bf16 row is the kernel
#: line's
BWD_ATTN_CASES = (
    ("qwen3_0_6b", (16, 8, 128, 128), 4, 2048, 2048, True,
     ("bfloat16", "float32")),
    ("granite_moe_3b_a800m", (24, 8, 64, 64), 1, 2048, 2048, True,
     ("bfloat16",)),
    ("deepseek_v3_671b", (128, 128, 192, 128), 1, 2048, 2048, True,
     ("bfloat16", "float32")),
    ("llama_3_2_vision_11b", (32, 8, 128, 128), 1, 2048, IMAGE_TOKENS,
     False, ("bfloat16",)))
#: B5's backward cases at mamba2_780m's training shape (batch 2 x 2048:
#: BN 16 chunks of 256, H 48, P 64, N 128): name, decay a step, dtype.
#: At 1.0 a step a chunk's cumulative log-decay spans > 88, where autograd
#: of the forward's where(mask, exp(seg), 0) would be NaN
BWD_SSD_SHAPE = (16, 256, 48, 64, 128)
BWD_SSD_CASES = (("mamba2_780m", 0.05, "bfloat16"),
                 ("mamba2_780m", 0.05, "float32"),
                 ("strong_decay", 1.0, "bfloat16"))
#: the backward kernels against their plain versions, as a share of each
#: output's largest magnitude: f32 sums in another order (f32), and P,
#: dS and the gradients rounded to bf16 (bf16)
BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
#: B4's forward lse output (float32 in both dtypes) against the plain
#: version's, as a share of its largest magnitude
LSE_TOL = 1e-5


def _scaled_err(got, want, tol: float) -> tuple:
    """(max |got - want|, that over max |want|); raises when the second
    exceeds ``tol`` or on a non-finite value."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"output {tuple(got.shape)}/{got.dtype} vs "
                             f"plain {tuple(want.shape)}/{want.dtype}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("a non-finite gradient")
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    rel = err / max(scale, 1e-30)
    if rel > tol:
        raise AssertionError(f"kernel != plain version: {rel} of the "
                             f"largest magnitude, tolerance {tol}")
    return err, rel


def bwd_attn_kernels(dtype_name: str, hd: int, hd_v: int) -> tuple:
    """The names (as ``ptxas_summary`` keys them) of B4's dK/dV and dQ
    kernels a backward call of ``dtype_name`` at (hd, hd_v) launches."""
    if dtype_name == "bfloat16":
        return tuple(f"flash_bwd_{part}_bf16_kernel<{hd},{hd_v}>"
                     for part in ("dkdv", "dq"))
    return tuple(f"flash_bwd_{part}_kernel<f32,{hd},{hd_v}>"
                 for part in ("dkdv", "dq"))


def train_kernel_phase(dev, reps: int = 5, ptxas=None) -> list:
    """B4's and B5's backward kernels against their plain backward
    versions on the same card tensors, each timed beside the plain
    version and its bound (B4 also beside SDPA's backward); B4's second
    call must give the same bits, and each case's line carries its dK/dV
    and dQ kernels' registers and spill bytes from ``ptxas`` (the build
    line's summary).  Returns the kernel line's two rows (launches filled
    in by the training phases)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.kernels.cost import attention_bwd_cost, ssd_bwd_cost

    g = torch.Generator().manual_seed(3)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows, b4_err, b5_err = {}, 0.0, 0.0
    for name, heads, B, S, Sk, causal, dtypes in BWD_ATTN_CASES:
        hq, hkv, hd, hd_v = heads
        for dtype_name in dtypes:
            dtype = getattr(torch, dtype_name)
            q, k, v, do = (torch.randn(B, h, n, d, generator=g).to(dev, dtype)
                           for h, n, d in ((hq, S, hd), (hkv, Sk, hd),
                                           (hkv, Sk, hd_v), (hq, S, hd_v)))
            o, lse = fa._flash_attention_cuda(q, k, v, causal, None,
                                              with_lse=True)
            # the forward's training launch (o and its lse output) against
            # the plain version
            o_want, lse_want = fa.flash_attention_plain(
                q, k, v, causal=causal, return_lse=True)
            fwd_err, fwd_rel = _scaled_err(o, o_want, BWD_TOL[dtype_name])
            lse_err, lse_rel = _scaled_err(lse, lse_want, LSE_TOL)
            del o_want, lse_want
            got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
            again = fa.flash_attention_bwd(q, k, v, o, lse, do,
                                           causal=causal)
            same_bits = all(torch.equal(a, b) for a, b in zip(got, again))
            if not same_bits:
                raise AssertionError(f"B4 backward, {name} {dtype_name}: a "
                                     f"second call gave other bits")
            want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                causal=causal)
            err, rel = map(max, zip(*(_scaled_err(a, b, BWD_TOL[dtype_name])
                                      for a, b in zip(got, want))))
            del got, again, want
            nbytes, ops = attention_bwd_cost(heads, B, S, Sk, causal, dtype)
            t_b, by = bound(nbytes, ops, peak_rate(dtype))
            qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
            try:
                sdpa = F.scaled_dot_product_attention(
                    qs, ks, vs, is_causal=causal, enable_gqa=True)
                library_ms = time_ms(lambda: torch.autograd.grad(
                    sdpa, (qs, ks, vs), do, retain_graph=True), reps=reps,
                    flush=flush)
            except RuntimeError as exc:       # no SDPA backend takes it
                library_ms, sdpa = None, str(exc).splitlines()[0]
            case = dict(
                config=name, B=B, Hq=hq, Hkv=hkv, hd=hd, hd_v=hd_v, S=S,
                Sk=Sk, causal=causal, dtype=dtype_name, max_abs_err=err,
                rel_err=rel, tolerance=BWD_TOL[dtype_name],
                lse_tolerance=LSE_TOL,
                fwd_max_abs_err=fwd_err, fwd_rel_err=fwd_rel,
                lse_max_abs_err=lse_err, lse_rel_err=lse_rel,
                ms=time_ms(lambda: fa.flash_attention_bwd(
                    q, k, v, o, lse, do, causal=causal), reps=reps,
                    flush=flush),
                plain_ms=time_ms(lambda: fa.flash_attention_bwd_plain(
                    q, k, v, o, lse, do, causal=causal), reps=2,
                    flush=flush),
                library_ms=library_ms, bound_ms=t_b, bound_by=by,
                bytes=nbytes, flop=ops, same_bits=same_bits,
                kernels={kname: (ptxas or {}).get(kname) for kname in
                         bwd_attn_kernels(dtype_name, hd, hd_v)})
            if library_ms is None:
                case["library_error"] = sdpa
            emit("train_kernel_case", kernel="flash_attention_bwd", **case)
            b4_err = max(b4_err, err, fwd_err, lse_err)
            if (name, dtype_name) == ("qwen3_0_6b", "bfloat16"):
                rows["b4"] = case
            del q, k, v, do, o, lse, qs, ks, vs, sdpa
            torch.cuda.empty_cache()
    BN, c, H, P, N = BWD_SSD_SHAPE
    for name, decay, dtype_name in BWD_SSD_CASES:
        dtype = getattr(torch, dtype_name)
        xb = (torch.randn(BN, c, H, P, generator=g) * 0.1).to(dev, dtype)
        cum = torch.cumsum(-torch.randn(BN, c, H, generator=g).abs()
                           * decay, 1).to(dev)
        Bm, Cm = ((torch.randn(BN, c, N, generator=g) * 0.3).to(dev, dtype)
                  for _ in range(2))
        dy = torch.randn(BN, c, H, P, generator=g).to(dev)
        ds = torch.randn(BN, H, N, P, generator=g).to(dev)
        span = float(-cum[:, -1].min())
        got = sc.ssd_chunk_dual_bwd(xb, cum, Bm, Cm, dy, ds)
        want = sc.ssd_chunk_dual_bwd_plain(xb, cum, Bm, Cm, dy, ds)
        err, rel = map(max, zip(*(_scaled_err(a, b, BWD_TOL[dtype_name])
                                  for a, b in zip(got, want))))
        nbytes, ops = ssd_bwd_cost(BN, c, H, P, N, dtype)
        t_b, by = bound(nbytes, ops, peak_rate(dtype))
        case = dict(
            config=name, BN=BN, c=c, H=H, P=P, N=N, dtype=dtype_name,
            decay_span=span, max_abs_err=err, rel_err=rel,
            tolerance=BWD_TOL[dtype_name],
            ms=time_ms(lambda: sc.ssd_chunk_dual_bwd(xb, cum, Bm, Cm, dy,
                                                     ds), reps=reps,
                       flush=flush),
            plain_ms=time_ms(lambda: sc.ssd_chunk_dual_bwd_plain(
                xb, cum, Bm, Cm, dy, ds), reps=2, flush=flush),
            library_ms=None, bound_ms=t_b, bound_by=by, bytes=nbytes,
            flop=ops)
        emit("train_kernel_case", kernel="ssd_chunk_dual_bwd", **case)
        if (name == "strong_decay") != (span > 88):
            raise AssertionError(f"decay span {span} of case {name}")
        b5_err = max(b5_err, err)
        if (name, dtype_name) == ("mamba2_780m", "bfloat16"):
            rows["b5"] = case
    b4, b5 = rows["b4"], rows["b5"]
    return [dict(
        name="flash_attention_bwd", route="cuda", source=CSRC_FLASH,
        replaces="none: jax.grad of blocked_attention, "
                 "src/repro/models/layers.py:80", launches=0,
        max_abs_err=b4_err, ms=b4["ms"], plain_ms=b4["plain_ms"],
        bound_ms=b4["bound_ms"], bound_by=b4["bound_by"],
        library_ms=b4["library_ms"], config="qwen3_0_6b",
        shape={key: b4[key] for key in ("B", "Hq", "Hkv", "hd", "hd_v", "S",
                                        "Sk", "causal", "dtype")}), dict(
        name="ssd_chunk_dual_bwd", route="cuda", source=CSRC_SSD,
        replaces="none: jax.grad of ssd_chunked's einsums, "
                 "src/repro/models/mamba.py:70", launches=0,
        max_abs_err=b5_err, ms=b5["ms"], plain_ms=b5["plain_ms"],
        bound_ms=b5["bound_ms"], bound_by=b5["bound_by"], library_ms=None,
        config="mamba2_780m",
        shape={key: b5[key] for key in ("BN", "c", "H", "P", "N",
                                        "dtype")})]


#: train_cpu: qwen3_0_6b at full width in float32, cut to 2 of 28 layers
#: (the CPU's share of the phase), one step on a 2 x 256 batch
TRAIN_CPU_LAYERS = 2
TRAIN_CPU_BATCH = (2, 256)
#: card against CPU, float32 (TF32 off): the loss relative, each gradient
#: leaf as a share of its largest |g|, the parameters after AdamW relative
#: to each leaf's largest magnitude
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, TRAIN_PARAM_TOL = 1e-4, 1e-3, 1e-3
#: the training runs: batch, sequence, steps; qwen3 checkpoints at step
#: TRAIN_CKPT and a fresh Trainer replays the steps after it
TRAIN_RUNS = {"qwen3_0_6b": (4, 2048, 8), "mamba2_780m": (2, 2048, 4)}
TRAIN_CKPT = 4
#: the replayed steps' losses against the uninterrupted run's, relative
TRAIN_REPLAY_TOL = 1e-5


def train_cpu_phase(dev) -> None:
    """One train step of qwen3_0_6b (full width, ``TRAIN_CPU_LAYERS``
    layers, float32) through ``build_train_step`` on the card and on the
    CPU from the same seeded weights and batch: the loss, every gradient
    leaf and the parameters after the AdamW update."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.launch.steps import build_train_step

    full = get_config("qwen3_0_6b")
    cfg = dataclasses.replace(full, dtype="float32",
                              num_layers=TRAIN_CPU_LAYERS)
    B, S = TRAIN_CPU_BATCH
    shape = ShapeSpec("train_cpu", S, B, "train")
    raw = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=S,
                        global_batch=B, seed=0).batch_at(0)
    out = {}
    for name, device in (("cuda", dev), ("cpu", "cpu")):
        t0 = time.perf_counter()
        step = build_train_step(cfg, shape, device=device)
        state = step.init_state()
        batch = {k: torch.as_tensor(raw[k], device=device).long()
                 for k in ("tokens", "labels")}
        grads, metrics = step._grads(state["params"], batch)
        grads = {k: g.float().cpu() for k, g in grads.items()}
        opt_metrics = step.opt.update(
            {k: g.to(device) for k, g in grads.items()}, state["opt"],
            state["params"])
        out[name] = (float(metrics["loss"]), grads,
                     {k: p.detach().float().cpu()
                      for k, p in state["params"].items()},
                     float(opt_metrics["grad_norm"]),
                     time.perf_counter() - t0)
        del step, state
    loss_g, grads_g, params_g, norm_g, sec_g = out["cuda"]
    loss_c, grads_c, params_c, norm_c, sec_c = out["cpu"]
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    grad_err = max((float((grads_g[k] - g).abs().max())
                    / max(float(g.abs().max()), 1e-30), k)
                   for k, g in grads_c.items())
    param_err = max((float((params_g[k] - p).abs().max())
                     / max(float(p.abs().max()), 1e-30), k)
                    for k, p in params_c.items())
    ok = (loss_rel <= TRAIN_LOSS_TOL and grad_err[0] <= TRAIN_GRAD_TOL
          and param_err[0] <= TRAIN_PARAM_TOL and math.isfinite(norm_g))
    emit("train_cpu_compare", arch="qwen3_0_6b", dtype="float32",
         reduced={"num_layers": [full.num_layers, TRAIN_CPU_LAYERS]},
         batch=[B, S], loss_cuda=loss_g, loss_cpu=loss_c,
         loss_rel_err=loss_rel, grad_rel_err=grad_err[0],
         worst_grad=grad_err[1], param_rel_err=param_err[0],
         grad_norm_cuda=norm_g, grad_norm_cpu=norm_c,
         tolerances=[TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, TRAIN_PARAM_TOL],
         cuda_seconds=sec_g, cpu_seconds=sec_c, equal=ok)
    if not ok:
        raise AssertionError("train step: card != cpu")


def _train_trainer(step, state, pipeline, total: int, ckpt_dir=None,
                   every: int = 1000):
    from repro_torch.runtime.trainer import TrainConfig, Trainer
    return Trainer(step, state, pipeline,
                   TrainConfig(total_steps=total, checkpoint_every=every,
                               checkpoint_dir=ckpt_dir, log_every=1000,
                               max_retries=0))


def train_phase(dev, arch: str) -> dict:
    """``arch`` at full width in bf16 through ``build_train_step`` and the
    ``Trainer``: AdamW under a warm-up cosine schedule (peak 1e-3, 2
    warm-up steps, so the run's few steps move the bf16 weights), batches
    of ``TokenPipeline``.  Losses and grad norms must be finite.
    qwen3_0_6b checkpoints at step ``TRAIN_CKPT``; a fresh Trainer
    restores it and replays the later steps, whose losses must equal the
    first run's.  The launch counts are set to 0 just before the run and
    read just after it."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import AdamW, warmup_cosine

    cfg = get_config(arch)
    B, S, steps = TRAIN_RUNS[arch]
    t0 = time.perf_counter()
    step = build_train_step(
        cfg, ShapeSpec("smoke", S, B, "train"), device=dev,
        optimizer=AdamW(learning_rate=warmup_cosine(1e-3, 2, steps),
                        state_dtype=cfg.opt_state_dtype))
    state = step.init_state()
    init_s = time.perf_counter() - t0
    pipeline = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=S,
                             global_batch=B, seed=0)

    def train_step(state, batch):
        return step(state, {k: batch[k].long()
                            for k in ("tokens", "labels")})

    replay = arch == "qwen3_0_6b"
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_") if replay else None
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts()
        trainer = _train_trainer(train_step, state, pipeline, steps,
                                 ckpt_dir, TRAIN_CKPT)
        hist = trainer.run()
        replayed = []
        if replay:
            shutil.rmtree(f"{ckpt_dir}/step_{steps:09d}")
            again = _train_trainer(train_step, state, pipeline, steps,
                                   ckpt_dir)
            if not again.maybe_restore() or again.step != TRAIN_CKPT:
                raise AssertionError("no checkpoint to restore")
            replayed = again.run()
        launches = {k: LAUNCHES[k] for k in (
            "flash_attention", "flash_attention_bwd", "ssd_chunk_dual",
            "ssd_chunk_dual_bwd")}
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    finally:
        if ckpt_dir:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    losses = [r.metrics["loss"] for r in hist]
    norms = [r.metrics["grad_norm"] for r in hist]
    step_ms = [r.seconds * 1e3 for r in hist]
    steady = statistics.median(step_ms[1:])
    replay_err = max((abs(r.metrics["loss"] - hist[r.step].metrics["loss"])
                      / abs(hist[r.step].metrics["loss"])
                      for r in replayed), default=0.0)
    ok = (all(math.isfinite(x) for x in losses + norms)
          and [r.step for r in hist] == list(range(steps))
          and replay_err <= TRAIN_REPLAY_TOL
          and [r.step for r in replayed] == list(range(TRAIN_CKPT, steps))
          * replay)
    kernels = (("flash_attention", "flash_attention_bwd")
               if cfg.family != "ssm" else ("ssd_chunk_dual",
                                            "ssd_chunk_dual_bwd"))
    ok = ok and all(launches[k] > 0 for k in kernels)
    emit("train", arch=arch, dtype=cfg.dtype, layers=cfg.num_layers,
         batch=[B, S], steps=steps, params=sum(
             p.numel() for p in state["params"].values()),
         losses=losses, grad_norms=norms, step_ms=step_ms,
         steady_step_ms=steady, tokens_per_s=B * S / steady * 1e3,
         peak_memory_gb=peak_gb, init_seconds=init_s,
         replayed_steps=[r.step for r in replayed],
         replayed_losses=[r.metrics["loss"] for r in replayed],
         replay_rel_err=replay_err, launches=launches,
         nvidia_smi=nvidia_smi(), ok=ok)
    if not ok:
        raise AssertionError(f"{arch}: training run failed its checks")
    del step, state
    torch.cuda.empty_cache()
    return {"launches": launches, "steps": len(hist) + len(replayed),
            "steady_step_ms": steady}


def step_kernel_costs(cfg, B: int, S: int) -> dict:
    """``name -> (bytes, FLOPs)`` of one call of each B4/B5 kernel a
    training step of ``cfg`` at B x S launches: the closed forms that give
    the kernels' bounds (``lm_kernel_phase``, ``train_kernel_phase``)."""
    import torch
    from repro_torch.kernels.cost import (attention_bwd_cost, attention_cost,
                                          ssd_bwd_cost, ssd_cost)
    dtype = getattr(torch, cfg.dtype)
    if cfg.family == "ssm":
        c = cfg.ssm_chunk
        shape = (B * S // c, c, cfg.ssm_heads, cfg.ssm_head_dim,
                 cfg.ssm_state)
        return {"ssd_chunk_dual": ssd_cost(*shape, dtype),
                "ssd_chunk_dual_bwd": ssd_bwd_cost(*shape, dtype)}
    hd = cfg.resolved_head_dim
    heads = (cfg.num_heads, cfg.num_kv_heads, hd, hd)
    nbytes, flops = attention_cost(S, dtype, True, heads)
    return {"flash_attention": (B * nbytes, B * flops),
            "flash_attention_bwd": attention_bwd_cost(heads, B, S, S, True,
                                                      dtype)}


def dryrun_phase(trained: dict) -> None:
    """ROADMAP A15 item 5 on the host: ``count_cell``'s count of one
    training step of each ``TRAIN_RUNS`` config at its run's batch on a
    1 x 1 mesh, over meta tensors.  The dry run's B4/B5 calls must equal
    the train phase's launches a step (its ``LAUNCHES`` reading over the
    steps it covers, qwen3's replayed steps included), and each meta
    call's FLOPs the closed form of its kernel's bound.  Prints the
    counted FLOPs, ``model_flops_for``, the roofline's compute and memory
    terms beside the measured step, and the measured share
    ``model_flops / (step_s x 989e12)``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import count_cell
    from repro_torch.launch.mesh import ProductionMesh
    from repro_torch.launch.shapes import ShapeSpec

    mesh = ProductionMesh((1, 1), ("data", "model"))
    peak = hardware()["peak_flops"]
    smi = nvidia_smi()
    for arch, (B, S, _) in TRAIN_RUNS.items():
        run = trained[arch]
        cfg = get_config(arch)
        t0 = time.perf_counter()
        rec = count_cell(cfg, ShapeSpec("train_run", S, B, "train"), mesh)
        seconds = time.perf_counter() - t0
        calls = {k: v["calls"] for k, v in rec["kernels"].items()}
        per_step = {k: n / run["steps"]
                    for k, n in run["launches"].items() if n}
        closed = step_kernel_costs(cfg, B, S)
        flops_ok = {k: v["flops"] == v["calls"] * closed[k][1]
                    for k, v in rec["kernels"].items()}
        step_s = run["steady_step_ms"] / 1e3
        rf = rec["roofline"]
        ok = (calls == per_step and set(calls) == set(closed)
              and all(flops_ok.values()))
        emit("dryrun", arch=arch, batch=[B, S], mesh=mesh.name,
             trace_s=rec["trace_s"], seconds=seconds,
             counted_flops=rec["per_device_flops"],
             model_flops=rec["model_flops"],
             kernel_calls_per_step=calls,
             card_launches_per_step=per_step,
             steps_read=run["steps"], kernel_flops=rec["kernels"],
             closed_form_flops_equal=flops_ok,
             compute_ms=rf["compute_s"] * 1e3,
             memory_ms=rf["memory_s"] * 1e3, dominant=rf["dominant"],
             step_ms=run["steady_step_ms"],
             share=rec["model_flops"] / (step_s * peak),
             bytes_per_device=rec["bytes_per_device"],
             nvidia_smi=smi, ok=ok)
        if not ok:
            raise AssertionError(f"{arch}: the dry run's kernel calls "
                                 f"{calls} != the card's {per_step} a "
                                 f"step, or a closed form differs")


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: src/repro_torch not found next to this "
              "script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.data import rmat_graph
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import HEAD_DIMS

    dev = torch.device("cuda")
    # float32 comparisons run in full float32: no TF32 in matmuls or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        raise AssertionError("TF32 could not be switched off")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(smi, flush=True)
    emit("device", name=kind, nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.perf_counter()
    g = rmat_graph(scale=20, edge_factor=8, weighted=True, seed=1,
                   device=dev)
    graph_s = time.perf_counter() - t0
    prebuild = start_prebuilds(g)
    t0 = time.perf_counter()
    _build.lib()
    sass = sass_mma_counts(_build.library_path())
    ptxas = ptxas_summary(_build.BUILD_LOG)
    emit("build", seconds=time.perf_counter() - t0,
         library=str(_build.library_path().relative_to(ROOT)),
         ptxas=ptxas, sass_mma=sass)
    # the bf16 kernels run on the tensor cores: B4's forward and its two
    # backward kernels at every head-dim pair, and B5's forward
    bf16 = {k: v for k, v in sass.items() if "bf16_kernel" in k}
    required = {"ssd_bf16_kernel"} | {f"{name}<{hd},{hd_v}>"
                                      for name in TC_FLASH_KERNELS
                                      for hd, hd_v in HEAD_DIMS}
    if not required <= set(bf16) or not all(v["HMMA"] + v["HGMMA"]
                                            for v in bf16.values()):
        raise AssertionError(f"bf16 kernels without tensor-core "
                             f"instructions: {bf16}")

    emit("graph", name="rmat20", nodes=g.num_nodes, edges=g.num_edges,
         max_degree=g.max_degree, seconds=graph_s)

    seconds = {}

    def timed(name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        seconds[name] = time.perf_counter() - t0
        emit("phase_seconds", name=name, seconds=seconds[name])
        return out

    timed("analysis", analysis_phase, dev)

    # lane counts of B2 that are not multiples of its 512-lane block tile
    # or of the 2 lanes a thread takes: 1001, 2^20 + 3
    rows = timed("kernels", kernel_phase, g, dev,
                 frontiers=(1 << 10, 1 << 14, 1 << 17, 1 << 20),
                 lanes_list=(1001, 1 << 10, 1 << 16, (1 << 20) + 3, 1 << 23))
    launches, results, per_run = timed("path", path_phase, g, dev)
    for row in rows:      # each row's launches: the main path's runs only
        row["launches"] = launches[row["name"]]
    timed("path_lanes", path_lanes_phase, g, dev, rows, per_run)
    timed("find_offsets_entry", find_offsets_entry_phase, g, dev)
    timed("cpu_compare", cpu_compare_phase, g, dev, results, cpu_scale=16)
    timed("strategies_cpu", strategies_cpu_phase, dev, scale=16)
    timed("memory_wall", memory_wall_phase, g, dev, results)
    fused_row = timed("fused", fused_phase, g, dev, results, small_scale=16)
    rows.append(fused_row)
    rows.append(timed("batch", batch_phase, g, dev, fused_row,
                      small_scale=16))
    timed("graph_serve", graph_serve_phase, g, dev)
    timed("costmodel", costmodel_phase, g, dev, fused_row)
    timed("delta", delta_phase, g, dev, fused_row)
    sharded = timed("shard", shard_phase, g, dev, results, small_scale=16)
    for row in rows:      # the sharded path's entry calls' launches too
        row["shard_launches"] = sharded.get(row["name"], 0)
        row["launches"] += row["shard_launches"]
    del results
    timed("algos", algos_phase, g, dev, small_scale=16)
    rows += timed("custom_ops", custom_ops_phase, g, dev)
    rows += timed("float_ops", float_ops_phase, g, dev)
    rows += timed("subword_ops", subword_ops_phase, g, dev)
    prebuild.shutdown()
    del g

    lm_rows = timed("lm_kernels", lm_kernel_phase, dev)
    timed("moe", moe_phase, dev)
    # float32 on both devices (TF32 off), which differ in summation order
    # and libm ulps.  Mamba-2's SSD decay exp(cum_i - cum_j) subtracts
    # float32 cumsums of |cum| ~ 250 within a chunk, where one ulp is
    # 1.5e-5: a last-bit difference in dt moves a decay 100x more than it
    # moves a matmul, and 48 random-init layers amplify it
    timed("lm_cpu qwen3_0_6b", lm_cpu_phase, dev, "qwen3_0_6b", 512,
          rel_tol=1e-3)
    timed("lm_cpu mamba2_780m", lm_cpu_phase, dev, "mamba2_780m", 600,
          rel_tol=5e-3)
    # the whole model in float32 is 13.5 GB on the host: 4 of 32 layers
    timed("lm_cpu granite_moe_3b_a800m", lm_cpu_forced_phase, dev,
          "granite_moe_3b_a800m", 512, num_layers=4)
    served = {config: timed(f"lm_serve {config}", lm_serve_phase, dev,
                            config, kernel)
              for config, kernel in (
                  ("qwen3_0_6b", "flash_attention"),
                  ("mamba2_780m", "ssd_chunk_dual"),
                  ("granite_moe_3b_a800m", "flash_attention"))}
    # A15's serving side: one deepseek model for the sharded MoE layer,
    # the serving run and the absorbed decode's check
    from repro_torch.core.shard import shard_group
    deepseek = timed("deepseek_model", deepseek_model, dev)
    timed("moe_sharded", moe_sharded_phase, dev, deepseek)
    group = shard_group(DEEPSEEK_SHARDS, dev)
    served["deepseek_v3_671b"] = timed(
        "lm_serve deepseek_v3_671b", lm_serve_phase, dev, "deepseek_v3_671b",
        "flash_attention", model=deepseek, group=group)
    del deepseek
    torch.cuda.empty_cache()
    # float32, card against CPU: one dense MLA layer (deepseek), one
    # period with its cross layer (vision), 4 layers (audio)
    timed("lm_cpu deepseek_v3_671b", lm_cpu_phase, dev, "deepseek_v3_671b",
          512, rel_tol=1e-3, num_layers=1, mtp_depth=0)
    # no qk-norm: held teacher-forced, and free-running beside the CPU's
    # own conditioning, as granite is
    for arch, layers in (("llama_3_2_vision_11b", 5), ("musicgen_large", 4)):
        timed(f"lm_cpu {arch}", lm_cpu_forced_phase, dev, arch, 512,
              num_layers=layers)
    served["llama_3_2_vision_11b"] = timed(
        "lm_lockstep llama_3_2_vision_11b", lockstep_phase, dev,
        "llama_3_2_vision_11b", num_layers=10)
    timed("lm_lockstep musicgen_large", lockstep_phase, dev, "musicgen_large")
    timed("pad_heads granite_moe_3b_a800m", pad_heads_phase, dev)
    for row in lm_rows:   # each row's launches: its own config's serving run
        row["launches"] = served[row["config"]][row["name"]]
    rows += lm_rows
    # phase 9: training
    train_rows = timed("train_kernels", train_kernel_phase, dev,
                       ptxas=ptxas)
    timed("train_cpu qwen3_0_6b", train_cpu_phase, dev)
    trained = {arch: timed(f"train {arch}", train_phase, dev, arch)
               for arch in TRAIN_RUNS}
    for row in train_rows:  # each row's launches: its config's training run
        row["launches"] = trained[row["config"]]["launches"][row["name"]]
    rows += train_rows
    timed("dryrun", dryrun_phase, trained)
    emit("seconds", phases=seconds, total=sum(seconds.values()))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
