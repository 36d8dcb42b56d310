#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``alphazero_tpu_torch``).

Drives the port's self-play paths — the steady-state Connect-Four actor on
the hybrid engine with an AZResNet-64x5, on the fused kernel with the
uniform model, and on the fused kernel with an MLPNet (256, 256) evaluated
inside it; then Othello, Gomoku and Hex on the hybrid engine, the hybrid
engine's K=4 leaf-parallel rounds, and the fused engine's K>1 rounds for
the uniform model and the MLP; then the fused int8 ResNet tower of the
experiment ``int8_fused_tower``; then what the fused engine declines
(an MLPNet wider than its evaluator, ``Gomoku(4, 4)``) through the ladder
on the hybrid engine, and Gomoku 19 — on one CUDA
card, in phases:

1. card:   the card's name and power limit (``nvidia-smi``);
2. build:  the hand-written kernels (``csrc/hybrid.cu``, ``csrc/fused.cu``,
           ``csrc/int8_tower.cu``)
           compiled with nvcc for sm_90a, one process per source, and linked
           into one library, with the build seconds and ptxas's register
           report, and the registers, stack and static shared bytes of the
           three MLP kernels, of the two uniform fused kernels, of the two
           A <= 8 merges, of the eight hybrid descends and of the eight
           instances of the seed (these twenty must have no stack frame and
           no spill);
3. kernels vs plain: each kernel against its plain PyTorch version at the
           main path's shapes (B=4096, C=101, A=7), on tree planes taken
           from a few simulations of the plain search on random positions
           (the merge, which refreshes only the columns it writes, on best
           planes that are the refresh of those planes, as in a search; the
           refresh, a fresh search's seed, on that search's fresh planes);
           outputs must be bit-equal; both timed with CUDA events;
4. goldens: the uniform model through the CUDA path reproduces
           ``tests/golden_counts.json`` for Connect-Four exactly;
5. slice:  AZResNet-64x5 (seeded random weights through the flax->torch
           converter) in bf16 with the ``full`` preset's search (B=4096,
           100 sims, Dirichlet 1.0): actor steps with the launch counters
           reset just before and read just after, visit counts summing to
           the simulation budget, pi rows summing to 1, one profiled step
           (device busy time and the kernels that take it), and one search
           through the plain versions giving identical counts;
6. fused:  the fused kernel against its plain version on random roots
           (B=4096, 100 sims, uval 0.5: bit-equal counts and root W, both
           timed), the goldens through the fused engine in one launch, then
           the uniform actor at the headline bench's size (B=65536, 100 sims,
           max_depth 48): one fused launch per step and no hybrid launch,
           ms/step, env-steps/s, peak memory and one profiled step (device
           busy time and the kernels that take it); the kernel against its plain
           version again on the actor's own roots at that size (bit-equal,
           both timed, and its device time per launch: the numbers of the
           kernels line); the batch sweep (``fused_sweep``: the device time
           of ``az_fused`` and of ``az_fused_rounds`` at K=4 on the first B
           of the actor's roots, B = 8192 to 65536, a line each); a few
           steps of the same actor through the hybrid route and one search
           through both routes with identical counts;
7. mlp:    MLPNet (256, 256), the ``mlp`` preset's model, with seeded
           random weights through the flax->torch converter and with
           order-free ones (``order_free_mlp_variables``: dyadic, so that
           the tensor cores' order of the adds gives the plain k loop's
           bits): (a) the kernel's evaluator alone against its plain
           version on B=4096 boards: order-free logits bit-equal, prior and
           value within 1e-6; random ones within MLP_LOGIT_ATOL and
           MLP_PRIOR_ATOL, with the share of bit-equal entries and the
           largest differences; (b) the fused MLP kernel against its plain
           version on random roots (B=4096, 100 sims, sims conserved):
           order-free counts and root W bit-equal; random ones with >= 75%
           of games identical and max |dpi| <= 0.25, both timed (the
           numbers of the kernels line), and, not gated, the share of games
           identical to a plain search whose leaves ``kernels.mlp_eval``
           evaluates; (b') MLPNet (256, 256, 256, 256), too large to stay
           in shared memory, runs staged once, order-free, bit-equal to
           plain; (c) the MLP actor
           at the engine bench's size (B=4096, 100 sims, max_depth 48, no
           Dirichlet): one fused_mlp launch per step and no other, ms/step,
           env-steps/s and peak memory, then a few steps at the preset's
           own B=512, 50 sims; (d) one search of the actor's roots through
           the fused route and through the hybrid route (the library
           forward): >= 75% of games identical and max |dpi| <= 0.25, the
           JAX package's bound between its Mosaic and XLA engines; (e) the
           library forward of the MLP on B=4096 features, timed per call;
8. othello: Othello on the hybrid engine, the ``full`` preset's search
           (B=1024, 100 sims, max_depth 80, Dirichlet 0.3, temp_threshold
           12): (a) the Othello descend, the dense merge and the dense
           refresh against their plain versions at B=1024, C=101, A=65, on
           planes taken from a few simulations of the plain search on
           random positions (the refresh, a fresh search's seed, on that
           search's fresh planes; bit-equal, both timed); (b) the uniform model
           reproduces ``tests/golden_counts.json`` for Othello with 50
           Othello descends and 50 dense merges; (c) one ResNet search at
           max_depth 4, where depth cutoffs back up the disc-differential
           heuristic, identical through the kernels and the plain
           versions; (d) the ``full`` preset's actor, AZResNet-128x5 in
           bf16 (seeded random weights through the converter): exactly 100
           Othello descends, 100 dense merges and 1 dense refresh per step,
           pi rows summing to 1, ms/step, env-steps/s, peak memory, one
           profiled step (device busy time and the kernels that take it),
           then one search through the kernels and the plain versions with
           identical counts that sum to 100 on live games; (e) the uniform
           model's actor at B=4096, 100 sims, max_depth 80; (f) the ``mlp``
           preset's actor, MLPNet (512, 512) at B=256, 50 sims, max_depth
           64, Dirichlet 0.3, through the hybrid route;
9. gomoku: Gomoku on the hybrid engine, the ``full`` preset's search on
           the 9x9 board (B=1024, 100 sims, max_depth 48, Dirichlet 0.15,
           temp_threshold 8): (a) the Gomoku descend at Gomoku 9 and 15, the
           dense merge and refresh at A=81 and A=225, against their plain
           versions at B=1024, C=101 on planes from a few plain simulations
           (the refresh on their fresh planes; bit-equal, both timed); (b)
           ``tests/tpu_goldens.json``'s
           ``hybrid_gomoku_uniform_counts_head`` (initial position, B=256,
           16 sims, max_depth 32) and ``hybrid_gomoku15_uniform_counts_head``
           (positions of tests/test_fused.py's generator, rebuilt with
           numpy; max_depth 64), 16 Gomoku descends each; (c) the ``full``
           preset's actor, AZResNet-64x5 in bf16: exactly 100 Gomoku
           descends, 100 dense merges and 1 dense refresh per step, pi rows
           summing to 1, ms/step, env-steps/s, peak memory, then one search
           through the kernels and the plain versions with identical counts;
           (d) the uniform actor of the engine bench's
           ``gomoku15_uniform_B4096_100sims`` (max_depth 64); (e) one Gomoku
           7 search (49 cells, as Hex's) through the kernels and the plain
           versions, identical counts;
10. hex:   Hex on the hybrid engine, the ``full`` preset's search (B=1024,
           100 sims, max_depth 56, Dirichlet 0.2, temp_threshold 8): (a) the
           Hex descend, the dense merge and refresh at A=49 against their
           plain versions (the refresh on fresh planes; bit-equal, both
           timed); (b)
           ``hybrid_hex_uniform_counts_head`` (16 sims, max_depth 56); (c)
           the ``full`` preset's actor, AZResNet-64x5 in bf16, with the
           checks of 9(c) and one profiled step; (d) the ``mlp`` preset's
           actor, MLPNet (256, 256) at B=256, 50 sims, max_depth 56;
11. rounds: ``parallel_sims=4`` leaf-parallel rounds on the hybrid engine:
           (a) each game's round descend, the round merge and the top-2
           refresh against their plain versions (bit-equal, timed in
           turns) at Connect-Four B=4096 A=7, Othello B=1024 A=65, Gomoku 15
           B=1024 A=225 and Hex B=1024 A=49, C=101, on planes from 6 plain
           rounds (the top-2 refresh, the seed, on that search's fresh
           planes);
           (b) ``tests/torch_round_goldens.json`` reproduced through
           the kernels; (c) the Othello ``full`` preset's actor at K=4
           (phase 8d runs it at K=1): exactly 25 Othello round descends, 25
           dense round merges and 1 dense top-2 refresh per step, pi rows
           summing to 1, ms/step, env-steps/s, peak memory, one profiled
           step, and one search through the kernels and the plain versions
           with identical counts that sum to 100 on live games; (d) the
           engine bench's ``oth_uniform_B4096_100sims_K4``; (e) one
           Connect-Four AZResNet-64x5 search (B=4096; timed three times
           after a warm-up) and (f) one Gomoku 15 and one Hex search
           (B=1024) at K=4 through the kernels and the plain versions,
           identical counts;
12. fused rounds: the fused engine's ``parallel_sims=K`` rounds (K2):
           (a) ``fused_rounds`` against ``fused_rounds_search`` on random
           roots (B=4096, 100 sims; 99 at K=9) at K = 2, 4, 9 and uniform
           values 0 and 0.3, and on the K=4 uniform actor's own roots at
           B=65536 (timed in turns: the numbers of the kernels line): counts
           and root W bit-equal; (b) ``fused_mlp_rounds`` against
           ``fused_mlp_rounds_search``, MLPNet (256, 256), B=4096, K=4, 100
           sims: order-free weights bit-equal; random ones within 7(b)'s
           bound, timed, with the not-gated share against a plain search
           evaluated by ``kernels.mlp_eval``, and the library forward of a
           round's K*B leaves once per round; (c) the Connect-Four entry of
           ``tests/torch_round_goldens.json`` through ``fused_rounds`` in one
           launch; (d) the K=4 fused and hybrid routes on the actors' roots:
           uniform counts equal, MLP counts within the bound of 7(d); (e) the
           headline bench's uniform actor (B=65536, 100 sims, max_depth 48,
           temp_threshold 15) and the MLP actor (B=4096) at K=4, exactly one
           fused launch per step, ms/step beside phases 6's and 7's K=1
           actors, env-steps/s, peak memory and one profiled step each; (f)
           ``bench_k.head_to_head`` at ``bench_k.py``'s defaults (1024 games,
           100 sims, 2 seeds, temp_moves 8) for K=2 and K=4 against K=1: every
           game ends and is counted once; W/L/D and the Elo difference with
           its 95% interval are printed, not gated;
13. int8 tower: the experiment's main (``python -m
           alphazero_tpu_torch.experiments.int8_fused_tower``: the reference
           main's inputs at B=4096, seed 0, one tower, a warm-up and the best
           of 3 runs of 30 towers, and its two yardsticks) with the launch
           counters reset just before and read just after; (a) the kernel
           against ``tower_plain`` on the main's inputs and at a ragged
           B=4093 with full-range weights (clip and half ties reached),
           bit-equal, timed in turns; (b) the library's int8 tower (the
           ``torch._int_mm`` chain) bit-equal to the kernel; (c) the bf16
           cuDNN conv tower of ``FoldedAZResNet._conv`` on the same input,
           finite; both yardsticks timed by the main; (d) TOPS of each, and
           the kernel's share of its bound;
14. fall-through: MLPNet (512, 512) on Connect-Four (wider than the
           in-kernel evaluator; seeded random weights) and the uniform
           ``Gomoku(4, 4)`` (a step the fused kernels lack): the fused
           engine declines both, and actor steps (B=512, 50 sims, 3 timed)
           through the ladder launch exactly the hybrid kernels and no
           fused one;
15. gomoku19: Gomoku 19 (361 cells) on the hybrid engine, uniform model,
           B=1024, 100 sims, max_depth 64: (a) ``descend_gomoku`` (6 of its
           8 board words) and the dense merge and refresh at A=361 against
           their plain versions on planes from a plain search (the refresh
           on its fresh planes; bit-equal, timed in turns); (b)
           ``descend_round_gomoku``, the dense round merge and the top-2
           refresh at K=4 (the same); (c) one timed
           actor step, its launches and peak memory; (d) one K=1 and one K=4
           search through the kernels and the plain versions, identical
           counts.

Each kernel's line in the JSON carries its bound: the larger of the bytes
the function must move (each input read once, each output written once; a
data-dependent walk counts the cells this run's data reaches, a merge the
stat columns it writes: ``merge_bounds``, whose whole-plane figure, the
four planes read once, rides beside it as ``whole_plane_bound_ms``; a
dense seed the roots' priors and the best planes it writes:
``seed_bounds``, with the whole-plane figure and, as ``sector_bound_ms``,
each prior read as its own 32-byte sector) over
3.35 TB/s, and its operations: f32 ones over 67 TFLOP/s plus bf16 matrix
ones over 989 TFLOP/s plus int8 matrix ones over 1979 TOP/s (the H100
SXM's data-sheet rates at 700 W; the int8 tower's f32 epilogue runs on the
CUDA cores beside its tensor-core products and is not added, and its
products count only the taps whose neighbour is on the board).

The second-to-last line is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``. Any failed phase raises and the
script exits non-zero without that line. Run from the repository root:

    python3 chip_smoke.py

``python3 chip_smoke.py --actors`` runs only the two actors whose steps
the dense merges set, the Gomoku 15 uniform actor (phase 9d) and the
Othello ``full`` actor at K=4 (phase 11c): each is timed, one step
profiled, then timed again after ``torch.cuda.empty_cache()``. It calls
only entry points the package has had since its K=4 rounds, so two trees
are compared in one call by copying this file into the other tree's root
and running both in turns (the other, this, this, the other).

``python3 chip_smoke.py --sweep`` runs only the build's report of the two
uniform fused kernels (not gated) and phase 6's batch sweep, on the
uniform actor's roots after 1 + 10 steps at B=65536; it too runs against
older trees.

``python3 chip_smoke.py --merges`` runs only what the A <= 8 merges set:
the build's report of ``merge_kernel`` and ``merge_round_kernel`` (not
gated), the two merges held bit-equal to plain on phase 3's and phase
11's Connect-Four planes (B=4096, K=1 and K=4) with MERGE_REPS readings of
their device time each, the AZResNet-64x5 actor (phase 5's search, one
warm-up and C4_STEPS timed steps, one profiled step) and one K=4 search
of phase 11's Connect-Four roots, timed. It too runs against older trees
(since the K=4 rounds), so the merges of two trees are compared in one
call, in turns.

``python3 chip_smoke.py --descends`` does the same for the hybrid
descends: the build's report of ``descend_kernel`` and
``descend_round_kernel`` of each game (not gated), then each game's descend
at K=1 and its round descend at K=4 held bit-equal to plain on the planes
of phases 3, 8, 9, 10 and 15 (Connect-Four B=4096; Othello, Gomoku 9, 15
and 19 and Hex B=1024; C=101), with DESCEND_REPS readings of the device
time per launch each and its bound. It calls only entry points the package
has had since the K=4 rounds, so it too compares two trees in one call.

``python3 chip_smoke.py --seeds`` does the same for the seeds of a fresh
search, ``refresh`` and ``refresh2`` at Connect-Four's A=7 and
``refresh_dense`` and ``refresh2_dense`` above: the build's report of
``seed_dense_kernel``'s eight instances, or on an older tree of the
thread-per-node kernels they replaced (not gated), then both seeds held
bit-equal to the plain full refreshes on the fresh planes of real roots
(the uniform model's root prior, with the preset's Dirichlet noise where it
has one) for Connect-Four (A=7, B=4096, Dirichlet 1.0: the roots of phase
3 and of phase 11's search, and phase 5's actor's first roots, the
initial position), Hex (49), Othello (65), Gomoku 9 (81), Gomoku 15 (225,
at B=1024 and at the uniform actor's B=4096) and Gomoku 19 (361), C=101,
with SEED_REPS readings of the device time per launch each and their
bounds. It calls only entry points the package has had since the K=4
rounds, so it too compares two trees in one call.

``python3 chip_smoke.py --tower`` does the same for the int8 tower: the
build's report of ``int8_tower_kernel`` (not gated), then the kernel held
bit-equal to ``tower_plain`` on the experiment main's inputs (B=4096) and
at the ragged B=4093 with full-range weights, with TOWER_REPS readings of
the device time per launch each and the bound and its share. It calls only
entry points the package has had since the tower's port, so it too
compares two trees in one call.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

B = 4096          # full preset: games per batch
SIMS = 100        # full preset: simulations per move
MAX_DEPTH = 48    # full preset
TEMP_THRESHOLD = 15
WARMUP_STEPS = 2
TIMED_STEPS = 10
SEED = 0

UNIFORM_B = 65536      # the headline bench's uniform-model batch
MLP_HIDDEN = (256, 256)   # the mlp preset's model
MLP_PRESET_B = 512        # the mlp preset's self-play batch ...
MLP_PRESET_SIMS = 50      # ... and simulations
MLP_PRESET_STEPS = 5
MLP_STAGED_HIDDEN = (256, 256, 256, 256)   # too large to stay resident: staged
# the evaluator's tolerance with random weights, where its tensor-core sums
# add in another order than the plain k loop and a few hidden units round
# to the other bf16 neighbour: one such unit of |h| < 2 (a bf16 step <=
# 2^-7) under a head weight |w| < 0.5 moves a logit by < 4e-3, the prior by
# about half that. MLPNet (256, 256) at B=4096 on an H100 shows 0.07% of
# logits off, by at most 1.26e-3 (prior 2.6e-4, value 4.5e-4).
MLP_LOGIT_ATOL = 4e-3     # logits and value
MLP_PRIOR_ATOL = 2e-3     # the masked prior
MLP_EXP_ATOL = 1e-6       # prior and value with bit-equal logits: expf/tanhf against torch's
ROUTE_SAME_GAMES = 0.75   # fused vs hybrid route (bf16 forwards that round differently) ...
ROUTE_MAX_DPI = 0.25      # ... the JAX package's Mosaic-vs-XLA bound (tests/test_fused.py)
HYBRID_STEPS = 3       # uniform actor steps through the hybrid route
FUSED_REPS = 5
SWEEP_BS = (8192, 16384, 32768, 65536)   # the uniform fused kernels' batch sweep (phase 6)
FUSED_KERNELS = ("fused_kernel", "fused_rounds_kernel")   # the uniform fused kernels' ptxas names
MERGE_KERNELS = ("merge_kernel", "merge_round_kernel")    # the A <= 8 merges' ptxas names
MERGE_REPS = 3            # --merges: device-time readings of each A <= 8 merge
DESCEND_REPS = 3          # --descends: device-time readings of each descend
# the hybrid descends' ptxas names: each template's instance of each game
DESCEND_KERNELS = tuple(f"{d}_kernelINS_{g}" for d in ("descend", "descend_round")
                        for g in ("15ConnectFourGame", "11OthelloGame", "10GomokuGameILi8E",
                                  "7HexGame"))
C4_STEPS = 5              # --merges: timed C4 ResNet actor steps
SEED_REPS = 3             # --seeds: device-time readings of each seed
# the seeds' ptxas names: seed_dense_kernel<J, top-2> of each J (1 at
# A <= 8), and (--seeds on an older tree) the thread-per-node kernels they
# replaced: the dense ones, then the A <= 8 refresh_kernel and
# refresh2_kernel (their mangled names end "_kernelE" + the arguments)
SEED_KERNELS = tuple(f"seed_dense_kernelILi{j}ELb{t}EE" for t in (0, 1) for j in (1, 4, 8, 16))
OLD_SEED_KERNELS = ("refresh_dense_kernel", "refresh2_kernelILb1EE", "refresh_kernelE",
                    "refresh2_kernelE")

OTH_B = 1024              # Othello full preset (examples/train_othello.py): games per batch
OTH_CHANNELS, OTH_BLOCKS = 128, 5   # ... its AZResNet
OTH_MAX_DEPTH = 80
OTH_DIRICHLET = 0.3
OTH_TEMP_THRESHOLD = 12
OTH_STEPS = 5             # timed steps after one warm-up
OTH_CUT_DEPTH = 4         # phase 8c's max_depth
OTH_UNIFORM_B = 4096      # the engine bench's oth_uniform_B4096_100sims
OTH_UNIFORM_STEPS = 3
OTH_MLP_HIDDEN = (512, 512)   # the Othello mlp preset: model, batch, sims, depth
OTH_MLP_B, OTH_MLP_SIMS, OTH_MLP_DEPTH = 256, 50, 64
OTH_MLP_STEPS = 3

GMK_B, GMK_MAX_DEPTH, GMK_DIRICHLET = 1024, 48, 0.15   # Gomoku full preset (examples/train_gomoku.py)
GMK_CHANNELS, GMK_BLOCKS = 64, 5
GMK_TEMP_THRESHOLD = 8
GMK_STEPS = 5             # timed steps after one warm-up
GMK15_B, GMK15_MAX_DEPTH, GMK15_STEPS = 4096, 64, 3   # gomoku15_uniform_B4096_100sims
HEX_B, HEX_MAX_DEPTH, HEX_DIRICHLET = 1024, 56, 0.2   # Hex full preset (examples/train_hex.py)
HEX_TEMP_THRESHOLD = 8
HEX_STEPS = 5
HEX_MLP_HIDDEN = (256, 256)   # the Hex mlp preset: model, batch, sims
HEX_MLP_B, HEX_MLP_SIMS, HEX_MLP_STEPS = 256, 50, 3
ROUND_K = 4               # phase 11: parallel_sims, leaf-parallel descents per round
ROUND_WARM = 6            # plain rounds before the round kernels' planes are captured
FUSED_ROUND_KS = (2, 4, 9)    # phase 12(a): K of the fused rounds held against plain ...
FUSED_ROUND_VALUES = (0.0, 0.3)   # ... at the uniform value 0 (integer W) and 0.3
BENCH_K_GAMES, BENCH_K_SIMS, BENCH_K_SEEDS, BENCH_K_TEMP_MOVES = 1024, 100, 2, 8   # bench_k.py defaults
BENCH_K_KS = (2, 4)
WIDE_MLP_HIDDEN = (512, 512)   # phase 14: wider than the in-kernel evaluator takes
TOWER_RAGGED_B = 4093     # phase 13(a): a tail tile of 5 games (the kernel's tiles hold 8)
TOWER_REPS = 3            # --tower: device-time readings at each B
TOWER_KERNELS = ("int8_tower_kernel",)   # the tower's ptxas name

SOURCE = {
    "descend": "alphazero_tpu_torch/csrc/hybrid.cu",
    "merge": "alphazero_tpu_torch/csrc/hybrid.cu",
    "refresh": "alphazero_tpu_torch/csrc/hybrid.cu",
    "descend_othello": "alphazero_tpu_torch/csrc/hybrid.cu",   # with its step, csrc/othello.cuh
    "merge_dense": "alphazero_tpu_torch/csrc/hybrid.cu",
    "refresh_dense": "alphazero_tpu_torch/csrc/hybrid.cu",
    "fused": "alphazero_tpu_torch/csrc/fused.cu",
    "fused_mlp": "alphazero_tpu_torch/csrc/fused.cu",   # with its evaluator, csrc/mlp.cuh
    "descend_gomoku": "alphazero_tpu_torch/csrc/hybrid.cu",   # with its step, csrc/gomoku.cuh
    "descend_hex": "alphazero_tpu_torch/csrc/hybrid.cu",      # with its step, csrc/hex.cuh
    # the K>1 round kernels, descend_round_kernel<Game> with each game's step
    "descend_round": "alphazero_tpu_torch/csrc/hybrid.cu",
    "descend_round_othello": "alphazero_tpu_torch/csrc/hybrid.cu",
    "descend_round_gomoku": "alphazero_tpu_torch/csrc/hybrid.cu",
    "descend_round_hex": "alphazero_tpu_torch/csrc/hybrid.cu",
    "merge_round": "alphazero_tpu_torch/csrc/hybrid.cu",
    "merge_round_dense": "alphazero_tpu_torch/csrc/hybrid.cu",
    "refresh2": "alphazero_tpu_torch/csrc/hybrid.cu",
    "refresh2_dense": "alphazero_tpu_torch/csrc/hybrid.cu",
    "fused_rounds": "alphazero_tpu_torch/csrc/fused.cu",
    "fused_mlp_rounds": "alphazero_tpu_torch/csrc/fused.cu",   # with its evaluator, csrc/mlp.cuh
    "int8_tower": "alphazero_tpu_torch/csrc/int8_tower.cu",
}
REPLACES = {
    "descend": "alphazero_tpu/mcts/hybrid.py:242",   # descend_kernel
    "merge": "alphazero_tpu/mcts/hybrid.py:363",     # merge_kernel (+ _refresh)
    "refresh": "alphazero_tpu/mcts/hybrid.py:120",   # _refresh, seeding at :815
    # descend_kernel with OthelloFlatOps.step (alphazero_tpu/games/othello.py:228) traced in
    "descend_othello": "alphazero_tpu/mcts/hybrid.py:242 + alphazero_tpu/games/othello.py:228",
    "merge_dense": "alphazero_tpu/mcts/hybrid.py:363",   # merge_kernel + _refresh's dense branch :150
    "refresh_dense": "alphazero_tpu/mcts/hybrid.py:150",  # _refresh's dense branch, seeding at :815
    "fused": "alphazero_tpu/mcts/fused.py:156",      # kernel, K=1 sim_body :282
    # the same kernel with the in-kernel MLP (K3, eval_fn of attach_mlp_kernel_eval)
    "fused_mlp": "alphazero_tpu/mcts/fused.py:156 + alphazero_tpu/models/nets.py:129",
    # descend_kernel with GomokuFlatOps.step / HexFlatOps.step traced in
    "descend_gomoku": "alphazero_tpu/mcts/hybrid.py:242 + alphazero_tpu/games/gomoku.py:191",
    "descend_hex": "alphazero_tpu/mcts/hybrid.py:242 + alphazero_tpu/games/hex.py:214",
    "descend_round": "alphazero_tpu/mcts/hybrid.py:437",   # descend_round_kernel
    "descend_round_othello": "alphazero_tpu/mcts/hybrid.py:437 + alphazero_tpu/games/othello.py:228",
    "descend_round_gomoku": "alphazero_tpu/mcts/hybrid.py:437 + alphazero_tpu/games/gomoku.py:191",
    "descend_round_hex": "alphazero_tpu/mcts/hybrid.py:437 + alphazero_tpu/games/hex.py:214",
    "merge_round": "alphazero_tpu/mcts/hybrid.py:579",   # merge_round_kernel + _refresh2 :170
    "merge_round_dense": "alphazero_tpu/mcts/hybrid.py:579",   # + _refresh2's dense branch :210
    "refresh2": "alphazero_tpu/mcts/hybrid.py:170",   # _refresh2, seeding at :874
    "refresh2_dense": "alphazero_tpu/mcts/hybrid.py:210",   # its dense branch, seeding at :874
    "fused_rounds": "alphazero_tpu/mcts/fused.py:428",   # kernel, K>1 round_body (+ top-2 :258)
    "fused_mlp_rounds": "alphazero_tpu/mcts/fused.py:428 + alphazero_tpu/models/nets.py:129",
    "int8_tower": "experiments/int8_fused_tower.py:46",   # tower_kernel, pallas_call :112
}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_OPS_PER_S = 67e12       # H100 SXM data sheet, f32 outside the tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM data sheet, dense bf16 on the tensor cores
INT8_OPS_PER_S = 1979e12    # H100 SXM data sheet, dense int8 on the tensor cores
F32 = 4


def bound(nbytes: float, ops: float, bf16_ops: float = 0.0, int8_ops: float = 0.0) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over their rates (f32 ones over the f32 rate plus bf16 and
    int8 matrix ones over the tensor cores' rates), whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S + bf16_ops / BF16_OPS_PER_S + int8_ops / INT8_OPS_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def puct_ops(nodes: float, A: int) -> float:
    """f32 operations of the PUCT argmax of ``nodes`` nodes: per edge q, u,
    the score and the compare (8), per node the visit sum, EPS and sqrt."""
    return nodes * (8 * A + A + 2)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def random_positions(game, batch: int, max_moves: int, seed: int, device) -> torch.Tensor:
    """Boards after a per-game random number (0..max_moves) of uniformly
    random legal moves; finished games freeze."""
    rng = np.random.default_rng(seed)
    target = torch.as_tensor(rng.integers(0, max_moves + 1, batch), device=device)
    state = game.init(batch, device)
    for t in range(max_moves):
        valid = game.valid_moves(state).cpu().numpy()
        acts = np.array([rng.choice(np.flatnonzero(v)) if v.any() else 0 for v in valid])
        nxt = game.step(state, torch.as_tensor(acts, device=device))
        done, _ = game.terminal(nxt)
        keep = (done | (t >= target))[:, None, None]
        state = torch.where(keep, state, nxt)
    return state


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def timed_once(fn):
    """``fn()`` and its device time in ms (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(k_fn, p_fn, k_reps: int = 50, p_reps: int = 20) -> tuple:
    """Mean device ms of a kernel and of its plain version, timed in turns
    (plain, kernel, kernel, plain): ``(k1, k2, p1, p2)``."""
    p1 = time_ms(p_fn, p_reps)
    k1 = time_ms(k_fn, k_reps)
    k2 = time_ms(k_fn, k_reps)
    p2 = time_ms(p_fn, p_reps)
    return k1, k2, p1, p2


def launches_of(kernels, **nonzero) -> dict:
    """Every kernel's launch count: 0 but for those named."""
    return {k: nonzero.get(k, 0) for k in kernels.launch_counts()}


def launched(counts: dict) -> dict:
    """The kernels of ``counts`` that launched, for printing."""
    return {k: v for k, v in counts.items() if v}


def profile_step(step) -> tuple:
    """One call of ``step`` under ``torch.profiler``: ``(wall ms, device
    busy ms, [(kernel, device ms, launches), ...] by time)``, the busy time
    being the sum of the device kernels' own times (one stream: they do not
    overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:   # the host ops that launched them
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        kernels.append((evt.key, dev_us / 1e3, evt.count))
    kernels.sort(key=lambda k: -k[1])
    return 1e3 * wall, sum(k[1] for k in kernels), kernels


def device_ms(fn, reps: int = 20, sleep_cycles: int = 50_000_000) -> float:
    """Mean device time per call of the kernels ``fn`` launches, without
    the host work between launches: the calls queue up behind a kernel that
    sleeps ``sleep_cycles`` clock cycles (~25 ms), so the events around
    them time the device alone. Fails if the host took longer to queue them
    than the sleep lasted. (No profiler: its sessions slow the host-paced
    steps that follow.)"""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    queued_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    if queued_ms >= 0.5 * sleep_cycles / 2.0e6:   # at most half the sleep at <= 2 GHz
        fail(f"queuing {reps} calls took {queued_ms:.3f} ms: the device time is not measurable")
    return start.elapsed_time(end) / reps


def read_goldens(name: str) -> dict:
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", name)) as f:
        return json.load(f)


def fused_test_positions(game, batch: int, moves: int, seed: int, device) -> torch.Tensor:
    """The boards of tests/test_fused.py's ``_random_positions``, which the
    TPU goldens were frozen from, made with the port's game: one
    ``rng.choice`` per game per move over its valid moves, and a game keeps
    its state whenever its next state would be terminal."""
    rng = np.random.default_rng(seed)
    state = game.init(batch, device)
    for _ in range(moves):
        valid = game.valid_moves(state).cpu().numpy()
        acts = np.array([rng.choice(np.nonzero(v)[0]) for v in valid])
        nxt = game.step(state, torch.as_tensor(acts, device=device))
        done, _ = game.terminal(nxt)
        state = torch.where(done[:, None, None], state, nxt)
    return state


def capture_search_args(game, apply_fn, cfg, roots, noise, sims: int = 24) -> tuple:
    """The arguments of the last descend and merge calls of a plain search
    of ``sims`` simulations at ``cfg``'s tree capacity, and of its seed
    refresh (the fresh planes): planes as the main path meets them."""
    from alphazero_tpu_torch.config import MCTSConfig
    from alphazero_tpu_torch.mcts import SearchKernels, hybrid

    captured = {}

    def capture(name, fn):
        def wrapped(*args):
            captured[name] = [a.clone() if torch.is_tensor(a) else a for a in args]
            return fn(*args)
        return wrapped

    cap_cfg = MCTSConfig(num_sims=sims, max_nodes=cfg.nodes, max_depth=cfg.max_depth,
                         dirichlet_alpha=cfg.dirichlet_alpha)
    hybrid.make_hybrid_root_fn(game, apply_fn, cap_cfg, kernels=SearchKernels(
        capture("descend", hybrid.descend), capture("merge", hybrid.merge),
        capture("refresh", hybrid.refresh)))(roots, noise)
    d_args, m_args = captured["descend"], captured["merge"]
    B, A = roots.shape[0], game.num_actions
    if d_args[4].shape != (B, game.flat_ops().size) or m_args[0].shape != (B, A, cfg.nodes):
        fail(f"captured {game.name} planes have shapes {d_args[4].shape}, {m_args[0].shape}")
    return d_args, m_args, captured["refresh"]


def descend_vs_plain(name: str, kernel, d_args) -> tuple:
    """A descend kernel wrapper against ``hybrid.descend`` on the same
    arguments: bit-equal outputs. Returns ``(result entry, path edges, cut
    leaves)``."""
    from alphazero_tpu_torch.mcts import hybrid

    out_k = kernel(*d_args)
    out_p = hybrid.descend(*d_args)
    for nm, k, p in zip(("bd", "patha", "psgn", "meta"), out_k, out_p):
        if not bit_equal(k, p):
            fail(f"{name} output {nm} differs from the plain version")
    B, C = d_args[0].shape
    L = d_args[4].shape[1]
    edges = float((out_p[1] > 0).sum())
    leaves = float((out_p[3][:, 1] + out_p[3][:, 4]).sum())
    result = {
        "max_abs_err": max(float((k - p).abs().max()) for k, p in zip(out_k, out_p)),
        # reads: the board, each path node's besta/bestc, the root's done
        # and a leaf's tval; writes: the leaf board, the patha/psgn rows, meta
        **bound(F32 * (B * L + 2 * edges + B + leaves + B * L + 2 * B * C + B * 8), 0.0),
    }
    return result, edges, float(out_p[3][:, hybrid.M_CUT].sum())


def merge_bounds(m_args) -> dict:
    """The bound of a merge call (K=1 or a round's, by ``m_args``' record
    shapes) for what its data needs: the stat columns whose cells it keeps
    (the path nodes and the expanded parents) read once, the best cells of
    every column it writes written (those and the install slots), the path
    records, ``meta2``, the installed prior rows, and the cells that change
    (path n/w, install rows with their done/tval, links). An install slot's
    column is not read: the merge writes it anew from its prior row (the
    round merge's x * keep is 0 there). Beside it, labelled, the
    whole-plane bound of a kernel that refreshes every node (the four stat
    planes read once), and the touched columns."""
    from alphazero_tpu_torch.mcts import hybrid

    n, patha, meta2, slot = m_args[0], m_args[7], m_args[9], m_args[-2]
    B, A, C = n.shape
    rounds = meta2.dim() == 3
    if not rounds:   # K=1: one record a game
        patha, meta2 = patha[None], meta2[None]
    K = patha.shape[0]
    cols = torch.arange(C, device=n.device)
    slots = slot + torch.arange(K, device=n.device)[:, None, None]                # [K, 1, 1]
    inst = meta2[..., hybrid.M2_EXPOK, None] > 0.5                               # [K, B, 1]
    installed = inst & (cols == slots)                                           # [K, B, C]
    linked = inst & (cols == meta2[..., hybrid.M2_ENODE, None].long())
    kept = ((patha > 0) | linked).any(dim=0)                                     # [B, C]
    touched = float((kept | installed.any(dim=0)).sum())
    installs = float(installed.sum())
    links = float(inst.sum())
    path_cells = float(sum(((patha == a + 1).any(dim=0)).sum() for a in range(A)))
    edges = float((patha > 0).sum())
    n_best = 4 if rounds else 2
    records = K * B * (2 * C + 8)
    writes = 2 * path_cells + installs * (4 * A + 2) + links + n_best * touched
    ops = puct_ops(touched, A) + 3 * edges
    if rounds:   # the top-2 scan, and x * keep + the k-ordered terms in every cell it rewrites
        ops += (1 + 9) * A * touched
    needed = bound(F32 * (4 * A * float(kept.sum()) + records + A * installs + writes), ops)
    # the whole-plane figure as the kernel table's earlier rows count it:
    # every pm row, the best planes of every node, done/tval read by the
    # round merge
    changed = 2 * path_cells + installs * (4 * A + 3)
    if rounds:
        whole = bound(F32 * (4 * B * A * C + 2 * B * C + K * B * (A + 2 * C + 8) + 4 * B * C
                             + changed), puct_ops(B * C, A) + 9 * A * B * C + 3 * edges)
    else:
        whole = bound(F32 * (4 * B * A * C + 2 * B * C + B * A + B * 8 + 2 * B * C + changed),
                      puct_ops(B * C, A) + 3 * edges)
    return {**needed, "whole_plane_bound_ms": whole["bound_ms"], "touched_per_game": touched / B}


def seed_bounds(r_args, top2: bool) -> dict:
    """The bound of a seed (``refresh``/``refresh_dense``, with ``top2``
    ``refresh2``/``refresh2_dense``) on a fresh search's planes, for what its data
    needs: the roots' priors read (B x A floats), the 2 or 4 best planes
    written (B x C floats each), the PUCT scores of the roots' edges.
    Beside it, labelled, the same with each prior read as its own 32-byte
    sector (an A-strided column of [B, A, C]), and the whole-plane bound of
    a refresh that reads the four stat planes, which the earlier kernel
    table's rows count."""
    B, A, C = r_args[0].shape
    writes = F32 * (4 if top2 else 2) * B * C
    root_ops = puct_ops(B, A) + (A * B if top2 else 0)
    needed = bound(F32 * B * A + writes, root_ops)
    sector = bound(32 * B * A + writes, root_ops)
    whole = bound(F32 * 4 * B * A * C + writes, puct_ops(B * C, A) + (A * B * C if top2 else 0))
    return {**needed, "sector_bound_ms": sector["bound_ms"],
            "whole_plane_bound_ms": whole["bound_ms"]}


def seed_vs_plain(name: str, kernel, plain, r_args) -> tuple:
    """A seed's wrapper against the plain full refresh on the seed's own
    arguments: a fresh search's planes (checked: the priors at node 0, the
    empty node elsewhere), bit-equal outputs. Returns ``(result entry,
    (kernel fn, plain fn) for in_turns)``."""
    n, w, p, code = r_args[:4]
    if not (bool((n == 0).all()) and bool((w == 0).all()) and bool((p[:, :, 1:] == 0).all())
            and bool((code == -1).all())):
        fail(f"{name}'s arguments are not a fresh search's planes")
    out_k = kernel(*r_args)
    out_p = plain(*r_args)
    if not all(bit_equal(k, q) for k, q in zip(out_k, out_p)):
        fail(f"{name} differs from the plain version at A={n.shape[1]}")
    result = {"max_abs_err": max(float((k - q).abs().max()) for k, q in zip(out_k, out_p)),
              **seed_bounds(r_args, len(out_k) == 4)}
    return result, (lambda: kernel(*r_args), lambda: plain(*r_args))


def merge_vs_plain(name: str, k_fn, p_fn, m_args) -> tuple:
    """A merge kernel wrapper (K=1 or a round's) against its plain version
    on copies of the same planes, best planes included (the precondition:
    captured from a plain search, they are the refresh of the captured
    planes): bit-equal outputs. Returns ``(result entry, (kernel fn, plain
    fn) for in_turns)``."""
    best = 2 if m_args[9].dim() == 2 else 4
    head, tail = 10 + best, m_args[10 + best:]

    def planes():
        return [t.clone() for t in (*m_args[:6], *m_args[10:head])]

    def call(fn, ps):
        return fn(*ps[:6], *m_args[6:10], *ps[6:], *tail)

    outs_k, outs_p = planes(), planes()
    call(k_fn, outs_k)
    call(p_fn, outs_p)
    names = ("n", "w", "p", "code", "done", "tval", "besta", "bestc", "seca", "secc")[:6 + best]
    for nm, k, p in zip(names, outs_k, outs_p):
        if not bit_equal(k, p):
            fail(f"{name} output {nm} differs from the plain version at A={m_args[0].shape[1]}")
    result = {"max_abs_err": max(float((k - p).abs().max()) for k, p in zip(outs_k, outs_p)),
              **merge_bounds(m_args)}
    scratch = planes()
    return result, (lambda: call(k_fn, scratch), lambda: call(p_fn, scratch))


def dense_vs_plain(kernels, m_args, r_args) -> tuple:
    """``merge_dense`` against the plain merge on the captured planes and
    ``refresh_dense`` against the plain refresh on the seed's fresh planes
    of the same search: bit-equal outputs. Returns ``(result entries, stat
    plane bytes, timing pairs for in_turns)``."""
    from alphazero_tpu_torch.mcts import hybrid

    B, A, C = m_args[0].shape
    results, fns = {}, {}
    results["merge_dense"], fns["merge_dense"] = merge_vs_plain(
        "merge_dense", kernels.merge_dense, hybrid.merge, m_args)
    results["refresh_dense"], fns["refresh_dense"] = seed_vs_plain(
        "refresh_dense", kernels.refresh_dense, hybrid.refresh, r_args)
    return results, F32 * 4 * B * A * C, fns


def time_in_turns(results: dict, fns: dict, tag: str, card: str, label: str = "") -> None:
    """Each kernel and its plain version timed in turns; the means go into
    the kernel's result entry."""
    for name, (k_fn, p_fn) in fns.items():
        k1, k2, p1, p2 = in_turns(k_fn, p_fn)
        dev = device_ms(k_fn)
        results[name].update({"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": None})
        print(f"[{tag}] {name}{label}: kernel {k1:.4f}/{k2:.4f} ms per call ({dev:.4f} ms of device "
              f"time), plain {p1:.4f}/{p2:.4f} ms, bound {bound_text(results[name])} | {card}",
              flush=True)


def bound_text(entry: dict) -> str:
    """A result entry's bound, with the labelled figures beside it: a
    merge's touched columns and whole-plane bound, a seed's sector-granular
    and whole-plane bounds."""
    extra = ""
    if "touched_per_game" in entry:
        extra += f"; {entry['touched_per_game']:.2f} touched columns a game"
    if "sector_bound_ms" in entry:
        extra += f"; 32-byte-sector bound {entry['sector_bound_ms']:.5f} ms"
    if "whole_plane_bound_ms" in entry:
        extra += f"; whole-plane bound {entry['whole_plane_bound_ms']:.4f} ms"
    return f"{entry['bound_ms']:.5f} ms ({entry['bound_by']}{extra})"


def run_actor(tag: str, game, apply_fn, run_cfg, batch: int, steps: int, temp_threshold: int,
              want: dict, card: str, label: str) -> tuple:
    """Actor steps through the ladder: one warm-up step, then ``steps``
    timed ones with the launch counters set to 0 just before and read just
    after; pi rows must sum to 1 and the launches be ``want`` per step.
    Returns ``(carry, step, generator, launches, mean ms per step)``."""
    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.ops import sample_draws
    from alphazero_tpu_torch.selfplay import make_actor_step_fn

    dev = torch.device("cuda", 0)
    A = game.num_actions
    torch.cuda.reset_peak_memory_stats()
    init, step = make_actor_step_fn(game, apply_fn, run_cfg, batch, temp_threshold, device=dev)
    carry = init()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    alpha = run_cfg.dirichlet_alpha
    carry, _ = step(carry, sample_draws(gen, batch, A, alpha, dev))   # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    times = []
    for _ in range(steps):
        draws = sample_draws(gen, batch, A, alpha, dev)
        t0 = time.perf_counter()
        carry, pi = step(carry, draws)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if not torch.allclose(pi.sum(dim=1), torch.ones(batch, device=dev), atol=1e-5):
            fail(f"{tag} {label}: pi rows do not sum to 1")
    got = dict(kernels.launch_counts())
    expect = launches_of(kernels, **{k: v * steps for k, v in want.items()})
    if got != expect:
        fail(f"{tag} {label}: launches {got} != {expect}")
    ms = 1e3 * sum(times) / len(times)
    print(f"[{tag}] {label}: B={batch}, {run_cfg.num_sims} sims, max_depth "
          f"{run_cfg.max_depth}: {ms:.3f} ms/step mean, "
          f"{1e3 * sorted(times)[len(times) // 2]:.3f} upper median "
          f"({', '.join(f'{1e3 * t:.3f}' for t in times)}), {batch / (ms / 1e3):.1f} "
          f"env-steps/s | launches {launched(got)} | peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB | {card}", flush=True)
    return carry, step, gen, got, ms


def print_profiled_step(tag: str, step, card: str, label: str = "full-preset") -> None:
    wall, busy, top = profile_step(step)
    print(f"[{tag}] one profiled {label} step: {wall:.3f} ms wall (profiler on), device "
          f"busy {busy:.3f} ms ({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%, "
          f"{sum(k[2] for k in top)} device kernels | {card}", flush=True)
    for name, ms, count in top[:12]:
        print(f"[{tag}]   {ms:9.3f} ms {count:6d}x {name[:100]}", flush=True)


def same_counts_through_kernels_and_plain(tag: str, game, apply_fn, cfg, state, dirichlet,
                                          want: dict) -> dict:
    """One search of ``state`` through the kernels (exactly ``want``
    launches) and through the plain versions: identical, finite counts
    that sum to the simulation budget on live games. Returns the
    launches."""
    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.mcts import PLAIN, hybrid

    B, A = state.shape[0], game.num_actions
    kernels.reset_launch_counts()
    c_kernel = hybrid.make_hybrid_root_fn(game, apply_fn, cfg)(state, dirichlet)
    got = kernels.launch_counts()
    if got != launches_of(kernels, **want):
        fail(f"{tag} kernel search launches {got} != {want}")
    c_plain = hybrid.make_hybrid_root_fn(game, apply_fn, cfg, kernels=PLAIN)(state, dirichlet)
    live = ~game.terminal(state)[0]
    if not torch.isfinite(c_kernel).all() or c_kernel.shape != (B, A):
        fail(f"{tag} kernel-path counts are not finite [B, A]")
    if not bool((c_kernel.sum(dim=1)[live] == cfg.num_sims).all()):
        fail(f"{tag} root counts of live games do not sum to the simulation budget")
    if not torch.equal(c_kernel, c_plain):
        fail(f"{tag} kernel and plain searches differ on "
             f"{int((c_kernel != c_plain).any(dim=1).sum())} of {B} games")
    print(f"[{tag}] one search through the kernels ({launched(got)}) and the plain versions: "
          f"identical counts on all {B} games ({int(live.sum())} live, each summing to "
          f"{cfg.num_sims})", flush=True)
    return got


def othello_phase(card: str) -> tuple:
    """Phase 8: Othello on the hybrid engine (see the module docstring).
    Returns the kernels line's entries of its three kernels and their
    launches on the main path, the ``full`` preset's actor."""
    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.config import MCTSConfig
    from alphazero_tpu_torch.games import Othello
    from alphazero_tpu_torch.mcts import PLAIN, SearchKernels, hybrid
    from alphazero_tpu_torch.models import (
        convert_az_resnet,
        convert_mlp,
        make_apply_fn,
        make_uniform_model,
        random_az_resnet_variables,
        random_mlp_variables,
    )
    from alphazero_tpu_torch.ops import sample_draws

    dev = torch.device("cuda", 0)
    game = Othello()
    ops = game.flat_ops()
    A = game.num_actions
    resnet = make_apply_fn(convert_az_resnet(
        random_az_resnet_variables(A, OTH_CHANNELS, OTH_BLOCKS, cells=ops.size, seed=SEED),
        dtype=torch.bfloat16).to(dev))
    cfg = MCTSConfig(num_sims=SIMS, max_depth=OTH_MAX_DEPTH, dirichlet_alpha=OTH_DIRICHLET)
    C = cfg.nodes
    roots = random_positions(game, OTH_B, 40, SEED, dev)
    noise = sample_draws(torch.Generator(device=dev).manual_seed(SEED), OTH_B, A, OTH_DIRICHLET,
                         dev).dirichlet

    # (a) the three kernels against their plain versions, on planes taken
    # from a few simulations of the plain search
    d_args, m_args, r_args = capture_search_args(game, resnet, cfg, roots, noise)
    results = {}
    results["descend_othello"], edges, cuts = descend_vs_plain(
        "descend_othello", kernels.descend_othello, d_args)
    dense, planes_bytes, dense_fns = dense_vs_plain(kernels, m_args, r_args)
    results.update(dense)
    print(f"[othello] B={OTH_B} C={C} A={A}: descend_othello, merge_dense, refresh_dense "
          f"bit-equal to plain ({edges / OTH_B:.2f} path edges per game, {cuts:.0f} cut leaves; "
          f"stat planes {planes_bytes / 1e6:.1f} MB)", flush=True)
    time_in_turns(results, {"descend_othello": (lambda: kernels.descend_othello(*d_args),
                                                lambda: hybrid.descend(*d_args)), **dense_fns},
                  "othello", card)
    feats = game.to_features(roots).contiguous()
    nn_ms = time_ms(lambda: resnet(feats), 20)
    print(f"[othello] AZResNet-{OTH_CHANNELS}x{OTH_BLOCKS} bf16 folded forward, B={OTH_B}: "
          f"{nn_ms:.4f} ms per sim | {card}", flush=True)

    # (b) the goldens through the CUDA path
    golden = read_goldens("golden_counts.json")["othello"]
    states = []
    for seq in golden["seqs"]:
        st = game.init(1, dev)
        for a in seq:
            st = game.step(st, torch.tensor([a], device=dev))
        states.append(st)
    kernels.reset_launch_counts()
    counts = hybrid.make_hybrid_root_fn(
        game, make_uniform_model(game).apply_fn, MCTSConfig(num_sims=50, max_depth=64)
    )(torch.cat(states))
    want = launches_of(kernels, descend_othello=50, merge_dense=50, refresh_dense=1)
    if kernels.launch_counts() != want:
        fail(f"Othello golden search launches {kernels.launch_counts()} != {want}")
    if counts.round().int().tolist() != golden["counts"]:
        fail(f"Othello golden counts differ: {counts.int().tolist()} != {golden['counts']}")
    print(f"[othello] CUDA path reproduces tests/golden_counts.json othello ({len(states)} "
          f"positions, 50 sims) | launches {want}", flush=True)

    # (c) depth cutoffs on the card: the heuristic path, kernels vs plain
    cut_cfg = MCTSConfig(num_sims=SIMS, max_depth=OTH_CUT_DEPTH, dirichlet_alpha=OTH_DIRICHLET)
    cut_leaves = []

    def counting_descend(*args):
        out = kernels.descend(*args)
        cut_leaves.append(float(out[3][:, hybrid.M_CUT].sum()))
        return out

    c_kernel = hybrid.make_hybrid_root_fn(game, resnet, cut_cfg, kernels=SearchKernels(
        counting_descend, kernels.merge, kernels.refresh))(roots, noise)
    c_plain = hybrid.make_hybrid_root_fn(game, resnet, cut_cfg, kernels=PLAIN)(roots, noise)
    if sum(cut_leaves) == 0:
        fail("the max_depth cutoff search cut no leaf")
    if not torch.equal(c_kernel, c_plain):
        fail(f"cutoff search: kernels and plain differ on "
             f"{int((c_kernel != c_plain).any(dim=1).sum())} of {OTH_B} games")
    print(f"[othello] max_depth {OTH_CUT_DEPTH}: {sum(cut_leaves):.0f} cut leaves backed up the "
          f"heuristic; kernel and plain counts identical on all {OTH_B} games", flush=True)

    # (d)-(f): the actors
    per_step = {"descend_othello": SIMS, "merge_dense": SIMS, "refresh_dense": 1}
    carry, step, gen, launches, _ = run_actor(
        "othello", game, resnet, cfg, OTH_B, OTH_STEPS, OTH_TEMP_THRESHOLD, per_step, card,
        f"full preset actor, AZResNet-{OTH_CHANNELS}x{OTH_BLOCKS} bf16")
    print_profiled_step(
        "othello", lambda: step(carry, sample_draws(gen, OTH_B, A, OTH_DIRICHLET, dev)), card)
    state, _ = carry
    same_counts_through_kernels_and_plain(
        "othello", game, resnet, cfg, state,
        sample_draws(gen, OTH_B, A, OTH_DIRICHLET, dev).dirichlet, per_step)

    run_actor("othello", game, make_uniform_model(game).apply_fn,
              MCTSConfig(num_sims=SIMS, max_depth=OTH_MAX_DEPTH), OTH_UNIFORM_B, OTH_UNIFORM_STEPS,
              OTH_TEMP_THRESHOLD, per_step, card, "uniform actor")
    mlp = make_apply_fn(convert_mlp(
        random_mlp_variables(A, OTH_MLP_HIDDEN, cells=ops.size, seed=SEED)).to(dev))
    run_actor("othello", game, mlp, MCTSConfig(num_sims=OTH_MLP_SIMS, max_depth=OTH_MLP_DEPTH,
                                               dirichlet_alpha=OTH_DIRICHLET),
              OTH_MLP_B, OTH_MLP_STEPS, OTH_TEMP_THRESHOLD,
              {"descend_othello": OTH_MLP_SIMS, "merge_dense": OTH_MLP_SIMS, "refresh_dense": 1},
              card, f"mlp preset actor, MLPNet {OTH_MLP_HIDDEN}")
    return results, {k: launches[k] for k in results}


def golden_search(tag: str, game, boards, sims: int, max_depth: int, key: str, want: dict) -> None:
    """The uniform model's search of ``boards`` through the CUDA path gives
    ``tests/tpu_goldens.json[key]`` (the first 4 games' counts) with
    exactly the launches ``want``."""
    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.config import MCTSConfig
    from alphazero_tpu_torch.mcts import hybrid
    from alphazero_tpu_torch.models import make_uniform_model

    kernels.reset_launch_counts()
    counts = hybrid.make_hybrid_root_fn(
        game, make_uniform_model(game).apply_fn, MCTSConfig(num_sims=sims, max_depth=max_depth)
    )(boards)
    if kernels.launch_counts() != launches_of(kernels, **want):
        fail(f"{tag} golden search launches {kernels.launch_counts()} != {want}")
    golden = read_goldens("tpu_goldens.json")[key]
    if counts[:4].tolist() != golden:
        fail(f"{tag} counts differ from tests/tpu_goldens.json {key}")
    print(f"[{tag}] CUDA path reproduces tests/tpu_goldens.json {key} (B={boards.shape[0]}, "
          f"{sims} sims, max_depth {max_depth}) | launches {want}", flush=True)


def gomoku_phase(card: str) -> tuple:
    """Phase 9: Gomoku on the hybrid engine (see the module docstring).
    Returns the kernels line's entry of the Gomoku descend and its
    launches on the main path, the ``full`` preset's actor."""
    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.config import MCTSConfig
    from alphazero_tpu_torch.games import Gomoku
    from alphazero_tpu_torch.mcts import hybrid
    from alphazero_tpu_torch.models import (
        convert_az_resnet,
        make_apply_fn,
        make_uniform_model,
        random_az_resnet_variables,
    )
    from alphazero_tpu_torch.ops import sample_draws

    dev = torch.device("cuda", 0)
    game = Gomoku(9)
    A = game.num_actions
    resnet = make_apply_fn(convert_az_resnet(
        random_az_resnet_variables(A, GMK_CHANNELS, GMK_BLOCKS, cells=A, seed=SEED),
        dtype=torch.bfloat16).to(dev))
    cfg = MCTSConfig(num_sims=SIMS, max_depth=GMK_MAX_DEPTH, dirichlet_alpha=GMK_DIRICHLET)
    game15 = Gomoku(15)
    cfg15 = MCTSConfig(num_sims=SIMS, max_depth=GMK15_MAX_DEPTH)

    # (a) the Gomoku descend at 9x9 (the full preset's AZResNet and
    # Dirichlet) and 15x15 (the uniform model), the dense merge and refresh
    # at A=81 and A=225, against their plain versions
    results = {}
    for g, apply_fn, run_cfg in ((game, resnet, cfg),
                                 (game15, make_uniform_model(game15).apply_fn, cfg15)):
        roots = random_positions(g, GMK_B, g.num_actions // 2, SEED, dev)
        noise = None
        if run_cfg.dirichlet_alpha is not None:
            noise = sample_draws(torch.Generator(device=dev).manual_seed(SEED), GMK_B,
                                 g.num_actions, run_cfg.dirichlet_alpha, dev).dirichlet
        d_args, m_args, r_args = capture_search_args(g, apply_fn, run_cfg, roots, noise)
        entries = {}
        entries["descend_gomoku"], edges, cuts = descend_vs_plain(
            "descend_gomoku", kernels.descend_gomoku, d_args)
        dense, planes_bytes, dense_fns = dense_vs_plain(kernels, m_args, r_args)
        entries.update(dense)
        print(f"[gomoku] {g.name}, B={GMK_B} C={run_cfg.nodes} A={g.num_actions}: descend_gomoku, "
              f"merge_dense, refresh_dense bit-equal to plain ({edges / GMK_B:.2f} path edges per "
              f"game; stat planes {planes_bytes / 1e6:.1f} MB)", flush=True)
        time_in_turns(entries, {"descend_gomoku": (lambda: kernels.descend_gomoku(*d_args),
                                                   lambda: hybrid.descend(*d_args)), **dense_fns},
                      "gomoku", card, f" at A={g.num_actions}")
        if g is game:
            results["descend_gomoku"] = entries["descend_gomoku"]
            feats = g.to_features(roots).contiguous()
    nn_ms = time_ms(lambda: resnet(feats), 20)
    print(f"[gomoku] AZResNet-{GMK_CHANNELS}x{GMK_BLOCKS} bf16 folded forward at 81 cells, "
          f"B={GMK_B}: {nn_ms:.4f} ms per sim | {card}", flush=True)

    # (b) the TPU goldens through the CUDA path
    golden_search("gomoku", game, game.init(256, dev), 16, 32, "hybrid_gomoku_uniform_counts_head",
                  {"descend_gomoku": 16, "merge_dense": 16, "refresh_dense": 1})
    golden_search("gomoku", game15, fused_test_positions(game15, 256, 9, 31, dev), 16, 64,
                  "hybrid_gomoku15_uniform_counts_head",
                  {"descend_gomoku": 16, "merge_dense": 16, "refresh_dense": 1})

    # (c) the full preset's actor, then one search through both paths
    per_step = {"descend_gomoku": SIMS, "merge_dense": SIMS, "refresh_dense": 1}
    carry, step, gen, launches, _ = run_actor(
        "gomoku", game, resnet, cfg, GMK_B, GMK_STEPS, GMK_TEMP_THRESHOLD, per_step, card,
        f"full preset actor, AZResNet-{GMK_CHANNELS}x{GMK_BLOCKS} bf16")
    same_counts_through_kernels_and_plain(
        "gomoku", game, resnet, cfg, carry[0],
        sample_draws(gen, GMK_B, A, GMK_DIRICHLET, dev).dirichlet, per_step)

    # (d) the 15x15 uniform actor of the engine bench
    run_actor("gomoku", game15, make_uniform_model(game15).apply_fn, cfg15, GMK15_B, GMK15_STEPS,
              GMK_TEMP_THRESHOLD, per_step, card, "gomoku15 uniform actor")

    # (e) Gomoku 7 (49 cells, as Hex): kernels and plain agree
    game7 = Gomoku(7)
    same_counts_through_kernels_and_plain(
        "gomoku", game7, make_uniform_model(game7).apply_fn,
        MCTSConfig(num_sims=SIMS, max_depth=GMK_MAX_DEPTH),
        random_positions(game7, GMK_B, 20, SEED, dev), None, per_step)
    return results, {k: launches[k] for k in results}


def hex_phase(card: str) -> tuple:
    """Phase 10: Hex on the hybrid engine (see the module docstring).
    Returns the kernels line's entry of the Hex descend and its launches
    on the main path, the ``full`` preset's actor."""
    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.config import MCTSConfig
    from alphazero_tpu_torch.games import Hex
    from alphazero_tpu_torch.mcts import hybrid
    from alphazero_tpu_torch.models import (
        convert_az_resnet,
        convert_mlp,
        make_apply_fn,
        random_az_resnet_variables,
        random_mlp_variables,
    )
    from alphazero_tpu_torch.ops import sample_draws

    dev = torch.device("cuda", 0)
    game = Hex()
    A = game.num_actions
    resnet = make_apply_fn(convert_az_resnet(
        random_az_resnet_variables(A, GMK_CHANNELS, GMK_BLOCKS, cells=A, seed=SEED),
        dtype=torch.bfloat16).to(dev))
    cfg = MCTSConfig(num_sims=SIMS, max_depth=HEX_MAX_DEPTH, dirichlet_alpha=HEX_DIRICHLET)
    roots = random_positions(game, HEX_B, 30, SEED, dev)
    noise = sample_draws(torch.Generator(device=dev).manual_seed(SEED), HEX_B, A, HEX_DIRICHLET,
                         dev).dirichlet

    # (a) the Hex descend and the dense merge and refresh at A=49
    d_args, m_args, r_args = capture_search_args(game, resnet, cfg, roots, noise)
    entries = {}
    entries["descend_hex"], edges, _ = descend_vs_plain("descend_hex", kernels.descend_hex, d_args)
    dense, planes_bytes, dense_fns = dense_vs_plain(kernels, m_args, r_args)
    entries.update(dense)
    print(f"[hex] B={HEX_B} C={cfg.nodes} A={A}: descend_hex, merge_dense, refresh_dense bit-equal "
          f"to plain ({edges / HEX_B:.2f} path edges per game; stat planes "
          f"{planes_bytes / 1e6:.1f} MB)", flush=True)
    time_in_turns(entries, {"descend_hex": (lambda: kernels.descend_hex(*d_args),
                                            lambda: hybrid.descend(*d_args)), **dense_fns},
                  "hex", card, f" at A={A}")
    results = {"descend_hex": entries["descend_hex"]}
    feats = game.to_features(roots).contiguous()
    nn_ms = time_ms(lambda: resnet(feats), 20)
    print(f"[hex] AZResNet-{GMK_CHANNELS}x{GMK_BLOCKS} bf16 folded forward at 49 cells, B={HEX_B}: "
          f"{nn_ms:.4f} ms per sim | {card}", flush=True)
    ops = game.flat_ops()
    aux = ops.aux(dev)
    flat = ops.from_state(roots)
    term_ms = time_ms(lambda: ops.valid_terminal(flat, aux), 20)
    print(f"[hex] valid_terminal (the connection test), B={HEX_B}: {term_ms:.4f} ms per sim | "
          f"{card}", flush=True)

    # (b) the TPU golden through the CUDA path
    golden_search("hex", game, fused_test_positions(game, 256, 5, 15, dev), 16, HEX_MAX_DEPTH,
                  "hybrid_hex_uniform_counts_head",
                  {"descend_hex": 16, "merge_dense": 16, "refresh_dense": 1})

    # (c) the full preset's actor, a profiled step, one search through both
    per_step = {"descend_hex": SIMS, "merge_dense": SIMS, "refresh_dense": 1}
    carry, step, gen, launches, _ = run_actor(
        "hex", game, resnet, cfg, HEX_B, HEX_STEPS, HEX_TEMP_THRESHOLD, per_step, card,
        f"full preset actor, AZResNet-{GMK_CHANNELS}x{GMK_BLOCKS} bf16")
    print_profiled_step(
        "hex", lambda: step(carry, sample_draws(gen, HEX_B, A, HEX_DIRICHLET, dev)), card)
    same_counts_through_kernels_and_plain(
        "hex", game, resnet, cfg, carry[0],
        sample_draws(gen, HEX_B, A, HEX_DIRICHLET, dev).dirichlet, per_step)

    # (d) the mlp preset's actor
    mlp = make_apply_fn(convert_mlp(random_mlp_variables(A, HEX_MLP_HIDDEN, cells=A, seed=SEED)).to(dev))
    run_actor("hex", game, mlp, MCTSConfig(num_sims=HEX_MLP_SIMS, max_depth=HEX_MAX_DEPTH,
                                           dirichlet_alpha=HEX_DIRICHLET),
              HEX_MLP_B, HEX_MLP_STEPS, HEX_TEMP_THRESHOLD,
              {"descend_hex": HEX_MLP_SIMS, "merge_dense": HEX_MLP_SIMS, "refresh_dense": 1},
              card, f"mlp preset actor, MLPNet {HEX_MLP_HIDDEN}")
    return results, {k: launches[k] for k in results}


def fallthrough_phase(card: str) -> None:
    """Phase 14: configurations the fused kernel declines run on the hybrid
    engine through the ladder (see the module docstring)."""
    from alphazero_tpu_torch.config import MCTSConfig
    from alphazero_tpu_torch.games import ConnectFour, Gomoku
    from alphazero_tpu_torch.mcts import make_fused_root_fn
    from alphazero_tpu_torch.models import (
        convert_mlp,
        make_apply_fn,
        make_uniform_model,
        random_mlp_variables,
    )

    dev = torch.device("cuda", 0)
    c4 = ConnectFour()
    wide = make_apply_fn(convert_mlp(random_mlp_variables(
        c4.num_actions, WIDE_MLP_HIDDEN, seed=SEED)).to(dev))
    cfg = MCTSConfig(num_sims=MLP_PRESET_SIMS, max_depth=MAX_DEPTH)
    if make_fused_root_fn(c4, wide, cfg) is not None:
        fail(f"the fused engine took MLPNet {WIDE_MLP_HIDDEN}, wider than its evaluator")
    run_actor("fallthrough", c4, wide, cfg, MLP_PRESET_B, 3, TEMP_THRESHOLD,
              {"descend": MLP_PRESET_SIMS, "merge": MLP_PRESET_SIMS, "refresh": 1}, card,
              f"Connect-Four MLPNet {WIDE_MLP_HIDDEN} through the ladder (hybrid route)")
    g4 = Gomoku(4, 4)
    uni = make_uniform_model(g4).apply_fn
    if make_fused_root_fn(g4, uni, cfg) is not None:
        fail("the fused engine took Gomoku(4, 4), whose step it lacks")
    run_actor("fallthrough", g4, uni, cfg, MLP_PRESET_B, 3, 4,
              {"descend_gomoku": MLP_PRESET_SIMS, "merge_dense": MLP_PRESET_SIMS,
               "refresh_dense": 1}, card, "Gomoku(4, 4) uniform through the ladder (hybrid route)")


def gomoku19_phase(card: str) -> None:
    """Phase 15: Gomoku 19 (361 cells, 6 of the descends' 8 board words)
    on the hybrid engine (see the module docstring). The kernels line's
    entries of the Gomoku descends are phases 9 and 11's."""
    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.config import MCTSConfig
    from alphazero_tpu_torch.games import Gomoku
    from alphazero_tpu_torch.mcts import hybrid
    from alphazero_tpu_torch.models import make_uniform_model

    dev = torch.device("cuda", 0)
    game = Gomoku(19)
    A = game.num_actions
    uni = make_uniform_model(game).apply_fn
    cfg = MCTSConfig(num_sims=SIMS, max_depth=GMK15_MAX_DEPTH)
    roots = random_positions(game, GMK_B, A // 3, SEED, dev)

    # (a) the descend and the dense merge and refresh at A=361
    d_args, m_args, r_args = capture_search_args(game, uni, cfg, roots, None)
    entry, edges, _ = descend_vs_plain("descend_gomoku", kernels.descend_gomoku, d_args)
    dense, planes_bytes, dense_fns = dense_vs_plain(kernels, m_args, r_args)
    print(f"[gomoku19] B={GMK_B} C={cfg.nodes} A={A}: descend_gomoku, merge_dense, "
          f"refresh_dense bit-equal to plain ({edges / GMK_B:.2f} path edges per game; stat planes "
          f"{planes_bytes / 1e6:.1f} MB)", flush=True)
    time_in_turns({"descend_gomoku": entry, **dense}, {
        "descend_gomoku": (lambda: kernels.descend_gomoku(*d_args),
                           lambda: hybrid.descend(*d_args)), **dense_fns},
        "gomoku19", card, f" at A={A}")

    # (b) the round kernels at K=4
    cfg4 = MCTSConfig(num_sims=SIMS, max_depth=GMK15_MAX_DEPTH, parallel_sims=ROUND_K)
    rounds_vs_plain(game, *capture_round_args(game, uni, cfg4, roots, None), card)

    # (c) one timed step of the uniform actor, its peak memory; (d) a K=1
    # and a K=4 search through the kernels and the plain versions
    per_step = {"descend_gomoku": SIMS, "merge_dense": SIMS, "refresh_dense": 1}
    carry, _, _, _, _ = run_actor("gomoku19", game, uni, cfg, GMK_B, 1, GMK_TEMP_THRESHOLD,
                                  per_step, card, "gomoku19 uniform actor")
    same_counts_through_kernels_and_plain("gomoku19", game, uni, cfg, carry[0], None, per_step)
    want4 = {"descend_round_gomoku": SIMS // ROUND_K, "merge_round_dense": SIMS // ROUND_K,
             "refresh2_dense": 1}
    same_counts_through_kernels_and_plain("gomoku19", game, uni, cfg4, carry[0], None, want4)


def capture_round_args(game, apply_fn, cfg, roots, noise, rounds: int = ROUND_WARM) -> tuple:
    """The arguments of the last descend_round and merge_round calls of a
    plain search of ``rounds`` rounds of ``cfg.parallel_sims`` descents at
    ``cfg``'s tree capacity, and of its seed refresh2 (the fresh planes):
    planes as the main path meets them."""
    from alphazero_tpu_torch.config import MCTSConfig
    from alphazero_tpu_torch.mcts import PLAIN, hybrid

    captured = {}

    def capture(name, fn):
        def wrapped(*args):
            captured[name] = [a.clone() if torch.is_tensor(a) else a for a in args]
            return fn(*args)
        return wrapped

    K = cfg.parallel_sims
    cap_cfg = MCTSConfig(num_sims=rounds * K, max_nodes=cfg.nodes, max_depth=cfg.max_depth,
                         dirichlet_alpha=cfg.dirichlet_alpha, parallel_sims=K)
    hybrid.make_hybrid_root_fn(game, apply_fn, cap_cfg, kernels=PLAIN._replace(
        descend_round=capture("descend_round", hybrid.descend_round),
        merge_round=capture("merge_round", hybrid.merge_round),
        refresh2=capture("refresh2", hybrid.refresh2)))(roots, noise)
    return captured["descend_round"], captured["merge_round"], captured["refresh2"]


def descend_round_vs_plain(d_args) -> tuple:
    """The game's round descend (routed as ``kernels.descend_round`` routes
    it) against ``hybrid.descend_round`` on the same arguments: bit-equal
    outputs. Returns ``(name, wrapper, result entry, runner-up takes,
    duplicates)``."""
    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.mcts import hybrid

    ops, K = d_args[8], d_args[9]
    B, C = d_args[0].shape
    L = d_args[6].shape[1]
    name = kernels._DESCEND_ROUND_ENTRIES[kernels.descend_entry(ops)][3:]
    kernel = getattr(kernels, name)
    out_k = kernel(*d_args)
    out_p = hybrid.descend_round(*d_args)
    for nm, k, p in zip(("bd", "patha", "psgn", "meta"), out_k, out_p):
        if not bit_equal(k, p):
            fail(f"{name} output {nm} differs from the plain version")
    patha, meta = out_p[1], out_p[3]
    seca = d_args[2]
    second = float(((patha - 1 == seca) & (patha > 0)).sum())
    dups = float(meta[..., hybrid.M_DUP].sum())
    # reads: the root board, the four best planes at every node a descent
    # visits, the root's done and the leaves' tval; writes: K leaf boards,
    # K patha/psgn rows and K meta rows per game
    visited = float((patha > 0).any(dim=0).sum())
    leaves = float((meta[..., hybrid.M_TERM] + meta[..., hybrid.M_CUT]).sum())
    result = {
        "max_abs_err": max(float((k - p).abs().max()) for k, p in zip(out_k, out_p)),
        **bound(F32 * (B * L + 4 * visited + B + leaves + K * (B * L + 2 * B * C + 8 * B)), 0.0),
    }
    return name, kernel, result, second, dups


def rounds_vs_plain(game, d_args, m_args, r_args, card: str) -> dict:
    """The game's round descend, the round merge and the top-2 refresh
    against their plain versions: the first two on the captured arguments,
    the refresh, the search's seed, on its fresh planes ``r_args``;
    bit-equal outputs, then each timed in turns. Returns their result
    entries."""
    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.mcts import hybrid

    K = d_args[9]
    B, C = d_args[0].shape
    A = m_args[0].shape[1]
    dense = "_dense" if A > hybrid.UNROLLED_MAX_A else ""
    m_name, r_name = f"merge_round{dense}", f"refresh2{dense}"
    m_kernel, r_kernel = (getattr(kernels, n) for n in (m_name, r_name))
    d_name, d_kernel, d_result, second, dups = descend_round_vs_plain(d_args)
    results = {d_name: d_result}

    results[m_name], merge_fns = merge_vs_plain(m_name, m_kernel, hybrid.merge_round, m_args)
    m_patha = m_args[7]
    edges = float((m_patha > 0).sum())
    shared = edges - float(sum(((m_patha == a + 1).any(dim=0)).sum() for a in range(A)))
    installs = float(m_args[9][..., hybrid.M2_EXPOK].sum())
    planes_bytes = F32 * 4 * B * A * C
    results[r_name], refresh_fns = seed_vs_plain(r_name, r_kernel, hybrid.refresh2, r_args)
    print(f"[rounds] {game.name}, B={B} C={C} A={A} K={K}: {d_name}, {m_name}, {r_name} bit-equal "
          f"to plain ({second:.0f} runner-up takes, {dups:.0f} duplicates, {shared:.0f} shared path "
          f"edges, {installs:.0f} installs; stat planes {planes_bytes / 1e6:.1f} MB)", flush=True)
    time_in_turns(results, {
        d_name: (lambda: d_kernel(*d_args), lambda: hybrid.descend_round(*d_args)),
        m_name: merge_fns,
        r_name: refresh_fns,
    }, "rounds", card, f" at A={A}")
    return results


def rounds_phase(card: str) -> tuple:
    """Phase 11: K=4 leaf-parallel rounds on the hybrid engine (see the
    module docstring). Returns the kernels line's entries of the round
    kernels and their launches on the paths that run them: the Othello
    ``full`` preset's actor for descend_round_othello, merge_round_dense
    and refresh2_dense, one search each of Connect-Four, Gomoku 15 and Hex
    for the others."""
    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.config import MCTSConfig
    from alphazero_tpu_torch.games import ConnectFour, Gomoku, Hex, Othello
    from alphazero_tpu_torch.mcts import hybrid
    from alphazero_tpu_torch.models import (
        convert_az_resnet,
        make_apply_fn,
        make_uniform_model,
        random_az_resnet_variables,
    )
    from alphazero_tpu_torch.ops import sample_draws

    dev = torch.device("cuda", 0)
    K = ROUND_K

    def resnet(game, channels, blocks):
        A = game.num_actions
        return make_apply_fn(convert_az_resnet(
            random_az_resnet_variables(A, channels, blocks, cells=game.flat_ops().size, seed=SEED),
            dtype=torch.bfloat16).to(dev))

    def noise_of(batch, A, alpha):
        if alpha is None:
            return None
        return sample_draws(torch.Generator(device=dev).manual_seed(SEED), batch, A, alpha, dev).dirichlet

    c4, oth, gmk15, hx = ConnectFour(), Othello(), Gomoku(15), Hex()
    c4_net, oth_net, hex_net = resnet(c4, 64, 5), resnet(oth, OTH_CHANNELS, OTH_BLOCKS), resnet(hx, 64, 5)
    configs = [   # game, batch, model, search config, random moves of the roots
        (c4, B, c4_net, MCTSConfig(num_sims=SIMS, max_depth=MAX_DEPTH, dirichlet_alpha=1.0,
                                   parallel_sims=K), 30),
        (oth, OTH_B, oth_net, MCTSConfig(num_sims=SIMS, max_depth=OTH_MAX_DEPTH,
                                         dirichlet_alpha=OTH_DIRICHLET, parallel_sims=K), 40),
        (gmk15, GMK_B, make_uniform_model(gmk15).apply_fn,
         MCTSConfig(num_sims=SIMS, max_depth=GMK15_MAX_DEPTH, parallel_sims=K), 112),
        (hx, HEX_B, hex_net, MCTSConfig(num_sims=SIMS, max_depth=HEX_MAX_DEPTH,
                                        dirichlet_alpha=HEX_DIRICHLET, parallel_sims=K), 30),
    ]

    # (a) every round kernel against its plain version at full width; the
    # kernels line keeps the first game's entry of each (the dense kernels:
    # Othello's, the main path)
    results, roots = {}, {}
    for game, batch, apply_fn, cfg, moves in configs:
        roots[game.name] = random_positions(game, batch, moves, SEED, dev)
        args = capture_round_args(game, apply_fn, cfg, roots[game.name],
                                  noise_of(batch, game.num_actions, cfg.dirichlet_alpha))
        for name, entry in rounds_vs_plain(game, *args, card).items():
            results.setdefault(name, entry)

    # (b) the round goldens through the kernels
    goldens = read_goldens("torch_round_goldens.json")
    for game, names in ((c4, ("descend_round", "merge_round", "refresh2")),
                        (oth, ("descend_round_othello", "merge_round_dense", "refresh2_dense"))):
        spec = goldens[game.name]
        states = []
        for seq in spec["seqs"]:
            st = game.init(1, dev)
            for a in seq:
                st = game.step(st, torch.tensor([a], device=dev))
            states.append(st)
        rounds = spec["num_sims"] // spec["parallel_sims"]
        want = dict(zip(names, (rounds, rounds, 1)))
        kernels.reset_launch_counts()
        counts = hybrid.make_hybrid_root_fn(game, make_uniform_model(game).apply_fn, MCTSConfig(
            num_sims=spec["num_sims"], max_depth=spec["max_depth"],
            parallel_sims=spec["parallel_sims"]))(torch.cat(states))
        if kernels.launch_counts() != launches_of(kernels, **want):
            fail(f"{game.name} round golden launches {kernels.launch_counts()} != {want}")
        if counts.round().int().tolist() != spec["counts"]:
            fail(f"{game.name} round golden counts differ from tests/torch_round_goldens.json")
        print(f"[rounds] CUDA path reproduces tests/torch_round_goldens.json {game.name} "
              f"({len(states)} positions, {spec['num_sims']} sims, K={spec['parallel_sims']}) | "
              f"launches {want}", flush=True)

    # (c) the Othello full preset's actor at K=4 (phase 8d ran it at K=1)
    oth_cfg = configs[1][3]
    rounds = SIMS // K
    per_step = {"descend_round_othello": rounds, "merge_round_dense": rounds, "refresh2_dense": 1}
    carry, step, gen, launches, _ = run_actor(
        "rounds", oth, oth_net, oth_cfg, OTH_B, OTH_STEPS, OTH_TEMP_THRESHOLD, per_step, card,
        f"Othello full preset actor at K={K}, AZResNet-{OTH_CHANNELS}x{OTH_BLOCKS} bf16")
    print_profiled_step(
        "rounds", lambda: step(carry, sample_draws(gen, OTH_B, oth.num_actions, OTH_DIRICHLET, dev)),
        card)
    same_counts_through_kernels_and_plain(
        "rounds", oth, oth_net, oth_cfg, carry[0],
        sample_draws(gen, OTH_B, oth.num_actions, OTH_DIRICHLET, dev).dirichlet, per_step)
    launches = {k: launches[k] for k in per_step}

    # (d) the engine bench's oth_uniform_B4096_100sims_K4
    run_actor("rounds", oth, make_uniform_model(oth).apply_fn,
              MCTSConfig(num_sims=SIMS, max_depth=OTH_MAX_DEPTH, parallel_sims=K), OTH_UNIFORM_B,
              OTH_UNIFORM_STEPS, OTH_TEMP_THRESHOLD, per_step, card,
              f"oth_uniform_B{OTH_UNIFORM_B}_100sims_K{K}")

    # (e)-(f) one search each of Connect-Four (AZResNet-64x5, B=4096, also
    # timed), Gomoku 15 and Hex at K=4 through the kernels and the plain
    # versions
    game, batch, apply_fn, cfg, _ = configs[0]
    timed_search("rounds", game, apply_fn, cfg, roots[game.name],
                 noise_of(batch, game.num_actions, cfg.dirichlet_alpha), card)
    for (game, batch, apply_fn, cfg, _), names in zip(
            [configs[0], configs[2], configs[3]],
            [("descend_round", "merge_round", "refresh2"),
             ("descend_round_gomoku", "merge_round_dense", "refresh2_dense"),
             ("descend_round_hex", "merge_round_dense", "refresh2_dense")]):
        got = same_counts_through_kernels_and_plain(
            "rounds", game, apply_fn, cfg, roots[game.name],
            noise_of(batch, game.num_actions, cfg.dirichlet_alpha),
            dict(zip(names, (rounds, rounds, 1))))
        for name in names:
            launches.setdefault(name, got[name])
    return results, launches


def fused_rounds_phase(card: str, k1_ms: dict) -> tuple:
    """Phase 12: the fused engine's K>1 rounds (K2) for the uniform model
    and MLPNet (see the module docstring). ``k1_ms`` holds the K=1 actors'
    ms per step from phases 6 and 7 of this call, printed beside K=4's.
    Returns the kernels line's entries of ``fused_rounds`` and
    ``fused_mlp_rounds`` and their launches on the K=4 actors' steps."""
    from alphazero_tpu_torch import bench_k, kernels
    from alphazero_tpu_torch.config import MCTSConfig
    from alphazero_tpu_torch.games import ConnectFour
    from alphazero_tpu_torch.games.connect_four import FlatOps
    from alphazero_tpu_torch.mcts import PLAIN, fused, hybrid
    from alphazero_tpu_torch.mcts.tree import INVALID_P
    from alphazero_tpu_torch.models import (
        convert_mlp,
        make_apply_fn,
        make_uniform_model,
        order_free_mlp_variables,
        random_mlp_variables,
    )
    from alphazero_tpu_torch.ops import root_prior, sample_draws

    dev = torch.device("cuda", 0)
    game, flat, K = ConnectFour(), FlatOps(), ROUND_K
    A = game.num_actions
    uniform = make_uniform_model(game)
    mlp_apply = make_apply_fn(convert_mlp(random_mlp_variables(A, MLP_HIDDEN, seed=SEED)).to(dev))
    mlp_w = mlp_apply.kernel_eval_factory(flat)
    free_apply = make_apply_fn(
        convert_mlp(order_free_mlp_variables(A, MLP_HIDDEN, seed=SEED)).to(dev))
    free_w = free_apply.kernel_eval_factory(flat)

    def cfg_of(k: int, sims: int = SIMS) -> MCTSConfig:
        return MCTSConfig(num_sims=sims, max_depth=MAX_DEPTH, parallel_sims=k)

    def search_inputs(state, apply_fn, cfg) -> tuple:
        """Flat root boards and masked root priors, as ``root_counts`` makes them."""
        prior, valid = root_prior(game, apply_fn, cfg, state, None)
        return flat.from_state(state).contiguous(), torch.where(valid, prior, INVALID_P)

    def plain_rounds(bds, pm, cfg, evaluate):
        """The plain version through its body (``fused_rounds_search`` and
        ``fused_mlp_rounds_search`` return only the root's N and W):
        ``(N, W, done)`` planes of every node."""
        kept = {}

        def merge_round_keeping_done(*args):
            kept["done"] = args[4]   # the done plane, which merge_round updates in place
            return hybrid.merge_round(*args)

        n, w = hybrid.run_rounds(flat, bds, pm, cfg, evaluate,
                                 PLAIN._replace(merge_round=merge_round_keeping_done))
        return n, w, kept["done"]

    def against_plain(name: str, k_fn, p_fn, label: str, timed: bool, exact: bool = True) -> tuple:
        """The kernel against its plain version on the same inputs: counts
        and root W bit-equal, or with ``exact`` False (an MLP with random
        weights, whose tensor-core sums add in another order) within
        ``search_agreement``'s bound. With ``timed``, both are timed in
        turns and the kernel's device time per launch measured. Returns
        ``(entry, N plane, done plane, kernel counts)``."""
        (n_all, w_all, done), p1 = timed_once(p_fn)
        (ck, wk), k0 = timed_once(k_fn)
        cp, wp = n_all[:, :, 0], w_all[:, :, 0]
        if exact and not (bit_equal(ck, cp) and bit_equal(wk, wp)):
            diff = int(((ck != cp) | (wk != wp)).any(dim=1).sum())
            fail(f"{name} differs from its plain version on {diff} of {ck.shape[0]} games ({label})")
        agreement = "bit-equal to its plain version (counts and root W"
        if not exact:
            same, dpi = search_agreement(f"{name} ({label})", ck, cp)
            agreement = (f"identical to its plain version on {same:.4f} of games, max |dpi| "
                         f"{dpi:.4f} (gate >= {ROUTE_SAME_GAMES}, <= {ROUTE_MAX_DPI}")
        entry = {"max_abs_err": max(float((ck - cp).abs().max()), float((wk - wp).abs().max()))}
        if timed:
            k1 = time_ms(k_fn, FUSED_REPS)
            k2 = time_ms(k_fn, FUSED_REPS)
            _, p2 = timed_once(p_fn)
            dev_ms = device_ms(k_fn, reps=FUSED_REPS)
            entry.update({"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2})
            times = (f"kernel {k1:.4f}/{k2:.4f} ms ({dev_ms:.4f} ms of device time), plain "
                     f"{p1:.4f}/{p2:.4f} ms")
        else:
            times = f"kernel {k0:.4f} ms (first call), plain {p1:.4f} ms"
        print(f"[fused_rounds] {label}: {name} {agreement}; "
              f"{float(n_all.sum()) / ck.shape[0]:.2f} descent steps per game); {times} | {card}",
              flush=True)
        return entry, n_all, done, ck

    def uniform_against_plain(state, k: int, value: float, label: str, timed: bool) -> tuple:
        cfg = cfg_of(k, SIMS - SIMS % k)   # K=9 runs 99 simulations
        bds, pm = search_inputs(state, uniform.apply_fn, cfg)
        nb = bds.shape[0]
        entry, n_all, _, _ = against_plain(
            "fused_rounds",
            lambda: kernels.fused_rounds(bds, pm, cfg.num_sims, cfg.nodes, MAX_DEPTH,
                                         float(cfg.cpuct), value, k),
            lambda: plain_rounds(bds, pm, cfg, fused.uniform_evaluator(k * nb, value, dev)),
            f"{label}, B={nb}, K={k}, {cfg.num_sims} sims, uval {value}", timed)
        # the work depends on the data: every descent step is one top-2 PUCT
        # scan, one take count and one backup; a search's steps are the sum
        # of N over every edge
        steps = float(n_all.sum())
        entry.update(bound(F32 * nb * (42 + A + 2 * A), steps * (puct_ops(1, A) + A + 4)))
        return entry

    # (a) fused_rounds against fused_rounds_search on random roots
    roots = random_positions(game, B, 30, SEED, dev)
    for k in FUSED_ROUND_KS:
        for value in FUSED_ROUND_VALUES:
            uniform_against_plain(roots, k, value, "random roots", timed=False)

    # (c) the round golden through fused_rounds, in one launch
    spec = read_goldens("torch_round_goldens.json")["connect_four"]
    states = []
    for seq in spec["seqs"]:
        st = game.init(1, dev)
        for a in seq:
            st = game.step(st, torch.tensor([a], device=dev))
        states.append(st)
    kernels.reset_launch_counts()
    counts = fused.make_fused_root_fn(game, uniform.apply_fn, MCTSConfig(
        num_sims=spec["num_sims"], max_depth=spec["max_depth"],
        parallel_sims=spec["parallel_sims"]))(torch.cat(states))
    if kernels.launch_counts() != launches_of(kernels, fused_rounds=1):
        fail(f"fused round golden launches {kernels.launch_counts()}: want one fused_rounds")
    if counts.round().int().tolist() != spec["counts"]:
        fail("fused round golden counts differ from tests/torch_round_goldens.json")
    print(f"[fused_rounds] the fused engine reproduces tests/torch_round_goldens.json connect_four "
          f"({len(states)} positions, {spec['num_sims']} sims, K={spec['parallel_sims']}) in 1 "
          f"launch", flush=True)

    # (e) the uniform actor at the headline bench's size at K=4, then (a)
    # on its own roots (the numbers of the kernels line) and (d) its roots
    # through the fused and the hybrid routes
    cfg_u = cfg_of(K)
    carry_u, step_u, gen_u, launches_u, ms_u = run_actor(
        "fused_rounds", game, uniform.apply_fn, cfg_u, UNIFORM_B, TIMED_STEPS, TEMP_THRESHOLD,
        {"fused_rounds": 1}, card, f"uniform actor at K={K}")
    print(f"[fused_rounds] uniform actor, B={UNIFORM_B}: K={K} {ms_u:.3f} ms/step, K=1 (phase 6) "
          f"{k1_ms['uniform']:.3f} ms/step | {card}", flush=True)
    print_profiled_step(
        "fused_rounds", lambda: step_u(carry_u, sample_draws(gen_u, UNIFORM_B, A, None, dev)), card,
        f"uniform K={K}")
    state_u, _ = carry_u
    results = {"fused_rounds": uniform_against_plain(
        state_u, K, float(uniform.apply_fn.uniform_value), "the K=4 uniform actor's roots", True)}
    c_fused = fused.make_fused_root_fn(game, uniform.apply_fn, cfg_u)(state_u)
    c_hybrid = hybrid.make_hybrid_root_fn(game, uniform.apply_fn, cfg_u)(state_u)
    live = ~game.terminal(state_u)[0]
    if not torch.isfinite(c_fused).all() or c_fused.shape != (UNIFORM_B, A):
        fail("fused-route K=4 counts are not finite [B, A]")
    if not bool((c_fused.sum(dim=1)[live] == SIMS).all()):
        fail("fused-route K=4 counts of live games do not sum to the simulation budget")
    if not torch.equal(c_fused, c_hybrid):
        fail(f"K=4 fused and hybrid routes differ on {int((c_fused != c_hybrid).any(dim=1).sum())} "
             f"of {UNIFORM_B} games")
    print(f"[fused_rounds] one K={K} search of the actor's roots through the fused and the hybrid "
          f"routes: identical counts on all {UNIFORM_B} games", flush=True)

    # (b) fused_mlp_rounds against fused_mlp_rounds_search on random roots:
    # order-free weights bit-equal; random weights within the bound, timed
    # in turns (the numbers of the kernels line)
    cfg_m = cfg_of(K)
    bds, pm = search_inputs(roots, free_apply, cfg_m)
    against_plain(
        "fused_mlp_rounds",
        lambda: kernels.fused_mlp_rounds(bds, pm, free_w, SIMS, cfg_m.nodes, MAX_DEPTH,
                                         float(cfg_m.cpuct), K),
        lambda: plain_rounds(bds, pm, cfg_m, lambda bd, vm: fused.mlp_eval(bd, vm, free_w)),
        f"MLPNet {MLP_HIDDEN} order-free weights, random roots, B={B}, K={K}, {SIMS} sims", False)
    bds, pm = search_inputs(roots, mlp_apply, cfg_m)
    entry, n_all, done, ck = against_plain(
        "fused_mlp_rounds",
        lambda: kernels.fused_mlp_rounds(bds, pm, mlp_w, SIMS, cfg_m.nodes, MAX_DEPTH,
                                         float(cfg_m.cpuct), K),
        lambda: plain_rounds(bds, pm, cfg_m, lambda bd, vm: fused.mlp_eval(bd, vm, mlp_w)),
        f"MLPNet {MLP_HIDDEN} random weights, random roots, B={B}, K={K}, {SIMS} sims", True,
        exact=False)
    # informative: the plain rounds with the kernel's own evaluator at their leaves
    n_e, _ = hybrid.run_rounds(flat, bds, pm, cfg_m, lambda bd, vm: kernels.mlp_eval(bd, mlp_w)[:2],
                               PLAIN)
    print(f"[fused_rounds] fused_mlp_rounds identical to the plain rounds with kernels.mlp_eval at "
          f"their leaves on {float((ck == n_e[:, :, 0]).all(dim=1).float().mean()):.4f} of games "
          f"(not gated) | {card}", flush=True)
    # the work this run's data needs, as phase 7(b) counts it: every descent
    # step, and one evaluation per install of a child that is not terminal
    # (a duplicate's leaf is the claimed one: it needs none)
    steps, installs = float(n_all.sum()), float((n_all > 0).sum())
    expansions = installs - float(done[:, 1:].sum())
    widths = (84, *MLP_HIDDEN)
    entry.update(bound(
        sum(t.numel() * t.element_size() for t in mlp_w.sections()) + F32 * B * (42 + A + 2 * A),
        steps * (puct_ops(1, A) + A + 4)
        + expansions * (2 * sum(MLP_HIDDEN) + 2 * MLP_HIDDEN[-1] * (A + 1) + (A + 1) + 5 * A + 1),
        expansions * 2 * sum(a * b for a, b in zip(widths, widths[1:]))))
    # the library's forward of the K*B leaves of a round, once per round
    feats = game.to_features(roots.repeat(K, 1, 1)).contiguous()
    entry["library_ms"] = time_ms(lambda: mlp_apply(feats), 20) * (SIMS // K)
    results["fused_mlp_rounds"] = entry
    print(f"[fused_rounds] MLP: {expansions / B:.2f} evaluations needed per game, bound "
          f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}); library forward of {K * B} boards x "
          f"{SIMS // K} rounds {entry['library_ms']:.4f} ms | {card}", flush=True)

    # (e) the MLP actor at K=4, then (d) its roots through both routes
    carry_m, step_m, gen_m, launches_m, ms_m = run_actor(
        "fused_rounds", game, mlp_apply, cfg_m, B, TIMED_STEPS, TEMP_THRESHOLD,
        {"fused_mlp_rounds": 1}, card, f"MLP actor at K={K}, MLPNet {MLP_HIDDEN}")
    print(f"[fused_rounds] MLP actor, B={B}: K={K} {ms_m:.3f} ms/step, K=1 (phase 7) "
          f"{k1_ms['mlp']:.3f} ms/step | {card}", flush=True)
    print_profiled_step("fused_rounds", lambda: step_m(carry_m, sample_draws(gen_m, B, A, None, dev)),
                        card, f"MLP K={K}")
    state_m, _ = carry_m
    c_fused = fused.make_fused_root_fn(game, mlp_apply, cfg_m)(state_m)
    c_hybrid = hybrid.make_hybrid_root_fn(game, mlp_apply, cfg_m)(state_m)
    live_m = ~game.terminal(state_m)[0]
    for label, c in (("fused", c_fused), ("hybrid", c_hybrid)):
        if not torch.isfinite(c).all() or not bool((c.sum(dim=1)[live_m] == SIMS).all()):
            fail(f"MLP K={K} {label}-route counts are not finite or do not sum to the budget")
    same = float((c_fused == c_hybrid).all(dim=1).float().mean())
    p_f = c_fused / c_fused.sum(dim=1, keepdim=True).clamp(min=1)
    p_h = c_hybrid / c_hybrid.sum(dim=1, keepdim=True).clamp(min=1)
    dpi = float((p_f - p_h).abs().max())
    if same < ROUTE_SAME_GAMES or dpi > ROUTE_MAX_DPI:
        fail(f"MLP K={K} fused and hybrid routes: {same:.4f} of games identical, max |dpi| {dpi}")
    print(f"[fused_rounds] one MLP K={K} search of the actor's roots through the fused and the hybrid "
          f"routes: {same:.4f} of {B} games identical, max |dpi| {dpi:.4f}", flush=True)

    # (f) bench_k.py's head-to-head at its defaults: fused K against fused K=1
    for k in BENCH_K_KS:
        kw = ew = dr = 0
        t0 = time.perf_counter()
        for seed in range(BENCH_K_SEEDS):
            a, b, c = bench_k.head_to_head(
                game, k, BENCH_K_SIMS, BENCH_K_GAMES, MAX_DEPTH,
                torch.Generator(device=dev).manual_seed(51 + seed), BENCH_K_TEMP_MOVES, dev)
            if a + b + c != BENCH_K_GAMES:
                fail(f"head_to_head K={k} seed {51 + seed}: {a} + {b} + {c} != {BENCH_K_GAMES}")
            kw, ew, dr = kw + a, ew + b, dr + c
        summary = bench_k.elo_summary(kw, ew, dr)
        print(f"[fused_rounds] bench_k head-to-head, K={k} vs K=1, {BENCH_K_SIMS} sims, "
              f"{BENCH_K_SEEDS} seeds x {BENCH_K_GAMES} games, temp_moves {BENCH_K_TEMP_MOVES}: "
              f"W/L/D {kw}/{ew}/{dr}, {json.dumps(summary)} ({time.perf_counter() - t0:.1f} s) | "
              f"{card}", flush=True)
    return results, {"fused_rounds": launches_u["fused_rounds"],
                     "fused_mlp_rounds": launches_m["fused_mlp_rounds"]}


def int8_tower_phase(card: str) -> tuple:
    """Phase 13: the fused int8 tower (see the module docstring). Returns
    the kernels line's ``int8_tower`` entry and its launches in the
    experiment's main."""
    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.experiments import int8_fused_tower as exp
    from alphazero_tpu_torch.models import int8_tower as tower

    dev = torch.device("cuda", 0)
    kernels.reset_launch_counts()
    run = exp.main()
    got = dict(kernels.launch_counts())
    if got != launches_of(kernels, int8_tower=exp.MAIN_LAUNCHES):
        fail(f"the tower experiment's launches {launched(got)}: want {exp.MAIN_LAUNCHES} "
             f"int8_tower launches and no other")
    x, w, out = run["x"], run["w"], run["out"]
    B = exp.MAIN_B
    rows = B * tower.CELLS
    if out.shape != (rows, tower.CH) or not torch.isfinite(out).all():
        fail(f"int8_tower output is not finite f32[{rows}, {tower.CH}]")

    # (a) the kernel against its plain version: the main's inputs, then a
    # ragged B with full-range weights
    def held(label, xs, ws, k_out):
        p_out = tower.tower_plain(xs, ws)
        if not bit_equal(k_out, p_out):
            fail(f"int8_tower differs from tower_plain ({label}) on "
                 f"{int((k_out != p_out).sum())} of {k_out.numel()} outputs "
                 f"(max {float((k_out - p_out).abs().max())})")
        return p_out

    plain = held(f"B={B}, main weights", x, w, out)
    k1, k2, p1, p2 = in_turns(lambda: kernels.int8_tower(x, w), lambda: tower.tower_plain(x, w),
                              k_reps=30, p_reps=5)
    dev_ms = device_ms(lambda: kernels.int8_tower(x, w))
    xr_np, wsr = exp.random_tower_inputs(SEED + 1, TOWER_RAGGED_B, -127, 128)
    xr, wr = torch.from_numpy(xr_np).to(dev), tower.tower_weights_from_jax(wsr).to(dev)
    kr = kernels.int8_tower(xr, wr)
    pr = held(f"B={TOWER_RAGGED_B}, full-range weights", xr, wr, kr)
    scaled = pr * tower.ASCALE
    clipped, ties = int((scaled > 127).sum()), int((scaled - scaled.floor() == 0.5).sum())
    if clipped == 0 or ties == 0:
        fail(f"the ragged check reached {clipped} clipped outputs and {ties} half ties")
    rk1, rk2, rp1, rp2 = in_turns(lambda: kernels.int8_tower(xr, wr),
                                  lambda: tower.tower_plain(xr, wr), k_reps=30, p_reps=5)
    print(f"[int8] int8_tower bit-equal to tower_plain at B={B} (the main's inputs, seed "
          f"{exp.MAIN_SEED}; {got['int8_tower']} launches in main) and at B={TOWER_RAGGED_B} with weights in "
          f"-127..127 ({clipped} clipped and {ties} half-tie outputs in the last layer); "
          f"kernel {k1:.4f}/{k2:.4f} ms [device {dev_ms:.4f}], plain {p1:.4f}/{p2:.4f} ms; "
          f"ragged kernel {rk1:.4f}/{rk2:.4f} ms, plain {rp1:.4f}/{rp2:.4f} ms | {card}", flush=True)

    # (b) the library's int8 tower, the kernels line's library call, and (c)
    # the bf16 cuDNN tower on the same input, both timed by the main
    lib_out = exp.int_mm_tower(x, w)
    if not bit_equal(lib_out, out):
        fail(f"the torch._int_mm tower differs from int8_tower on {int((lib_out != out).sum())} outputs")
    h = exp.cudnn_tower(exp.cudnn_input(x), exp.cudnn_weights(w))
    if h.shape != (B, tower.CH, tower.ROWS, tower.COLS) or not torch.isfinite(h).all():
        fail("the bf16 cuDNN tower's output is not finite")
    lib_ms, cudnn_ms = run["int_mm_ms"], run["cudnn_ms"]

    # (d) TOPS at the reference's operation count; the bound at the
    # operations the function needs (on-board taps only)
    k_ms, ops = (k1 + k2) / 2, tower.tower_ops(B)
    res = {
        "max_abs_err": max(float((out - plain).abs().max()), float((kr - pr).abs().max())),
        "ms": k_ms, "plain_ms": (p1 + p2) / 2, "library_ms": lib_ms,
        # reads x and the weights once, writes f once
        **tower_bound(x, w),
    }
    print(f"[int8] library int8 tower (torch._int_mm chain) bit-equal to the kernel; main's best "
          f"of {exp.MAIN_TRIALS}x{exp.MAIN_REPS}: kernel {run['ms']:.4f}, _int_mm {lib_ms:.4f}, "
          f"bf16 cuDNN conv tower {cudnn_ms:.4f} ms; TOPS (reference count) kernel "
          f"{ops / k_ms / 1e9:.1f}, _int_mm {ops / lib_ms / 1e9:.1f}, cuDNN {ops / cudnn_ms / 1e9:.1f}; "
          f"bound {res['bound_ms']:.4f} ms ({res['bound_by']}), the kernel at "
          f"{100 * res['bound_ms'] / k_ms:.1f}% of it [device {100 * res['bound_ms'] / dev_ms:.1f}%] "
          f"| {card}", flush=True)
    return {"int8_tower": res}, {"int8_tower": got["int8_tower"]}


def tower_bound(x: torch.Tensor, w: torch.Tensor) -> dict:
    """The tower's bound: x and the weights read once, f written once; the
    products of the taps whose neighbour is on the board."""
    from alphazero_tpu_torch.models import int8_tower as tower

    return bound(2 * F32 * x.numel() + w.numel(), 0.0,
                 int8_ops=tower.board_ops(x.shape[0] // tower.CELLS))


def tower_turns(card: str) -> None:
    """``--tower`` (see the module docstring)."""
    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.experiments import int8_fused_tower as exp
    from alphazero_tpu_torch.models import int8_tower as tower

    dev = torch.device("cuda", 0)
    ptxas_lines(kernels.library(), TOWER_KERNELS, gate=False)
    cells = ((f"B={exp.MAIN_B}, the main's inputs", exp.MAIN_SEED, exp.MAIN_B, -16, 16),
             (f"B={TOWER_RAGGED_B}, full-range weights", SEED + 1, TOWER_RAGGED_B, -127, 128))
    for label, seed, batch, low, high in cells:
        x_np, ws = exp.random_tower_inputs(seed, batch, low, high)
        x, w = torch.from_numpy(x_np).to(dev), tower.tower_weights_from_jax(ws).to(dev)
        out = kernels.int8_tower(x, w)
        if not bit_equal(out, tower.tower_plain(x, w)):
            fail(f"int8_tower differs from tower_plain at {label}")
        devs = [device_ms(lambda: kernels.int8_tower(x, w)) for _ in range(TOWER_REPS)]
        b = tower_bound(x, w)
        shares = [100 * b["bound_ms"] / d for d in devs]
        print(f"[tower] int8_tower, {label}: bit-equal to tower_plain; "
              f"{', '.join(f'{d:.4f}' for d in devs)} ms of device time per launch; bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}), "
              f"{', '.join(f'{p:.1f}' for p in shares)}% of it | {card}", flush=True)


def ptxas_report(log: str, kernels_wanted) -> dict:
    """ptxas's ``-v`` report of each named kernel in the build log:
    ``{name: "N registers, S bytes stack, spill stores/loads, M bytes
    smem"}`` (the static shared memory; the MLP kernels' is dynamic)."""
    import re

    out, current = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", ln)
        if m:
            current = next((k for k in kernels_wanted if k in m.group(1)), None)
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out.setdefault(current, {}).update(stack=int(m.group(1)), spill_st=int(m.group(2)),
                                               spill_ld=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            smem = re.search(r"(\d+) bytes smem", ln)
            out.setdefault(current, {}).update(registers=int(m.group(1)),
                                               smem=int(smem.group(1)) if smem else 0)
    return out


def search_agreement(label: str, ck: torch.Tensor, cp: torch.Tensor) -> tuple:
    """The statistical gate of a search whose evaluator adds in another
    order than its plain version's (random weights): >= ROUTE_SAME_GAMES of
    games with identical counts and max |dpi| <= ROUTE_MAX_DPI, the JAX
    package's bound between its Mosaic and XLA engines. Returns ``(share
    identical, max |dpi|)``."""
    same = float((ck == cp).all(dim=1).float().mean())
    p_k = ck / ck.sum(dim=1, keepdim=True).clamp(min=1)
    p_p = cp / cp.sum(dim=1, keepdim=True).clamp(min=1)
    dpi = float((p_k - p_p).abs().max())
    if same < ROUTE_SAME_GAMES or dpi > ROUTE_MAX_DPI:
        fail(f"{label}: {same:.4f} of games identical to the plain search, max |dpi| {dpi}")
    return same, dpi


def evaluator_vs_plain(tag: str, bds, weights, kind: str, card: str) -> None:
    """The kernel's evaluator alone against its plain version on the boards
    ``bds``: with order-free weights the logits bit-equal and prior and
    value within MLP_EXP_ATOL; with random ones within MLP_LOGIT_ATOL and
    MLP_PRIOR_ATOL. Prints the share of bit-equal entries and the largest
    differences."""
    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.games.connect_four import FlatOps
    from alphazero_tpu_torch.mcts import fused

    pm_k, v_k, lg_k = kernels.mlp_eval(bds, weights)
    lg_p, v_p = fused.mlp_forward(bds, weights)
    pm_p = fused.mlp_prior(lg_p, FlatOps().valid(bds))
    err_lg, err_pm, err_v = (float((a - b).abs().max())
                             for a, b in ((lg_k, lg_p), (pm_k, pm_p), (v_k, v_p)))
    if kind == "order-free":
        if not bit_equal(lg_k, lg_p):
            fail(f"{tag} evaluator ({kind} weights): logits differ from the plain version on "
                 f"{int((lg_k != lg_p).sum())} entries (max {err_lg})")
        if max(err_pm, err_v) > MLP_EXP_ATOL:
            fail(f"{tag} evaluator ({kind} weights): prior/value differ by {err_pm}, {err_v}")
    elif max(err_lg, err_v) > MLP_LOGIT_ATOL or err_pm > MLP_PRIOR_ATOL:
        fail(f"{tag} evaluator ({kind} weights): |dlogit| {err_lg}, |dprior| {err_pm}, "
             f"|dvalue| {err_v} beyond {MLP_LOGIT_ATOL}, {MLP_PRIOR_ATOL}, {MLP_LOGIT_ATOL}")
    print(f"[{tag}] evaluator, {kind} weights, B={bds.shape[0]}: logits "
          f"{float((lg_k == lg_p).float().mean()):.6f} bit-equal, max |dlogit| {err_lg}; prior "
          f"{float((pm_k == pm_p).float().mean()):.6f} bit-equal, max |dprior| {err_pm}; value "
          f"{float((v_k == v_p).float().mean()):.6f} bit-equal, max |dvalue| {err_v} | {card}",
          flush=True)


def mlp_phase(card: str, roots: torch.Tensor) -> tuple:
    """Phase 7: MLPNet (256, 256) on the fused kernel (see the module
    docstring). ``roots``: phase 3's random positions (B games). Returns
    the kernels line's ``fused_mlp`` entry, its launches on the actor's
    steps, and the actor's ms per step."""
    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.config import MCTSConfig
    from alphazero_tpu_torch.games import ConnectFour
    from alphazero_tpu_torch.games.connect_four import FlatOps
    from alphazero_tpu_torch.mcts import PLAIN, SearchKernels, fused, hybrid
    from alphazero_tpu_torch.mcts.tree import INVALID_P
    from alphazero_tpu_torch.models import (
        convert_mlp,
        make_apply_fn,
        order_free_mlp_variables,
        random_mlp_variables,
    )
    from alphazero_tpu_torch.ops import root_prior, sample_draws
    from alphazero_tpu_torch.selfplay import _make_root_counts_fn, make_actor_step_fn

    dev = torch.device("cuda", 0)
    game, flat = ConnectFour(), FlatOps()
    A = game.num_actions
    mlp_apply = make_apply_fn(convert_mlp(random_mlp_variables(A, MLP_HIDDEN, seed=SEED)).to(dev))
    mlp_w = mlp_apply.kernel_eval_factory(flat)
    free_apply = make_apply_fn(
        convert_mlp(order_free_mlp_variables(A, MLP_HIDDEN, seed=SEED)).to(dev))
    free_w = free_apply.kernel_eval_factory(flat)
    cfg_mlp = MCTSConfig(num_sims=SIMS, max_depth=MAX_DEPTH)
    bds = flat.from_state(roots).contiguous()
    live_r = ~game.terminal(roots)[0]
    nbytes, resident = kernels.mlp_plan(MLP_HIDDEN)
    print(f"[mlp] MLPNet {MLP_HIDDEN}: {'resident' if resident else 'staged'} weights, "
          f"{nbytes} bytes of dynamic shared memory a block", flush=True)

    # (a) the evaluator alone against its plain version
    evaluator_vs_plain("mlp", bds, free_w, "order-free", card)
    evaluator_vs_plain("mlp", bds, mlp_w, "random", card)

    # (b) the fused MLP kernel against its plain version on random roots
    def inputs(apply_fn, weights, cfg=cfg_mlp) -> tuple:
        prior, valid = root_prior(game, apply_fn, cfg, roots, None)
        return (bds, torch.where(valid, prior, INVALID_P), weights, cfg.num_sims, cfg.nodes,
                cfg.max_depth, float(cfg.cpuct))

    def plain_of(f_args, evaluate, cfg=cfg_mlp):
        """The plain search through its body: ``(N, W, done)`` planes."""
        planes = {}

        def merge_keeping_done(*args):
            planes["done"] = args[4]   # the done plane, which merge updates in place
            return hybrid.merge(*args)

        def plain():
            n, w = hybrid.run_search(flat, bds, f_args[1], cfg, evaluate,
                                     SearchKernels(hybrid.descend, merge_keeping_done,
                                                   hybrid.refresh))
            return n, w, planes["done"]
        return plain

    def conserved(label: str, ck: torch.Tensor, sims: int) -> None:
        if not bool((ck.sum(dim=1)[live_r] == sims).all() and (ck.sum(dim=1)[~live_r] == 0).all()):
            fail(f"{label} counts do not sum to the simulation budget")

    f_free = inputs(free_apply, free_w)
    (n_p, w_p, _), _ = timed_once(plain_of(f_free, lambda bd, vm: fused.mlp_eval(bd, vm, free_w)))
    ck, wk = kernels.fused_mlp(*f_free)
    conserved("fused_mlp (order-free weights)", ck, SIMS)
    if not (bit_equal(ck, n_p[:, :, 0]) and bit_equal(wk, w_p[:, :, 0])):
        diff = int(((ck != n_p[:, :, 0]) | (wk != w_p[:, :, 0])).any(dim=1).sum())
        fail(f"fused_mlp (order-free weights) differs from its plain version on {diff} of {B} "
             f"games (counts or root W)")
    print(f"[mlp] random roots, order-free weights: fused_mlp bit-equal to fused_mlp_search "
          f"(counts and root W) on all {B} games", flush=True)

    f_args = inputs(mlp_apply, mlp_w)
    plain_mlp = plain_of(f_args, lambda bd, vm: fused.mlp_eval(bd, vm, mlp_w))
    (n_all, w_all, done), p1 = timed_once(plain_mlp)
    ck, wk = kernels.fused_mlp(*f_args)
    cp, wp = n_all[:, :, 0], w_all[:, :, 0]
    conserved("fused_mlp", ck, SIMS)
    same, dpi = search_agreement("fused_mlp (random weights)", ck, cp)
    # informative: the plain search with the kernel's own evaluator at its leaves
    n_e, _ = hybrid.run_search(flat, bds, f_args[1], cfg_mlp,
                               lambda bd, vm: kernels.mlp_eval(bd, mlp_w)[:2], PLAIN)
    same_e = float((ck == n_e[:, :, 0]).all(dim=1).float().mean())
    k1 = time_ms(lambda: kernels.fused_mlp(*f_args), FUSED_REPS)
    k2 = time_ms(lambda: kernels.fused_mlp(*f_args), FUSED_REPS)
    dev_ms = device_ms(lambda: kernels.fused_mlp(*f_args), reps=FUSED_REPS)
    _, p2 = timed_once(plain_mlp)
    # the work this run's data needs: every descent step's PUCT argmax and
    # backup (the sum of N over every edge), and one evaluation per
    # expansion into a child that is not terminal (every edge ever visited
    # installed one child; a terminal child's slot has done = 1, and its
    # evaluation is discarded)
    steps, installs = float(n_all.sum()), float((n_all > 0).sum())
    terminal = float(done[:, 1:].sum())
    expansions = installs - terminal
    widths = (84, *MLP_HIDDEN)
    bf16_ops = expansions * 2 * sum(a * b for a, b in zip(widths, widths[1:]))
    f32_ops = (steps * (puct_ops(1, A) + 3)
               + expansions * (2 * sum(MLP_HIDDEN)                      # bias adds, ReLU
                               + 2 * MLP_HIDDEN[-1] * (A + 1) + (A + 1)  # the head
                               + 5 * A + 1))                             # softmax, tanh
    entry = {
        "max_abs_err": max(float((ck - cp).abs().max()), float((wk - wp).abs().max())),
        "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
        **bound(sum(t.numel() * t.element_size() for t in mlp_w.sections())
                + F32 * B * (42 + A + 2 * A), f32_ops, bf16_ops),
    }
    print(f"[mlp] random roots, random weights: B={B}, {SIMS} sims, max_depth {MAX_DEPTH}: "
          f"fused_mlp identical to fused_mlp_search on {same:.4f} of games, max |dpi| {dpi:.4f} "
          f"(gate >= {ROUTE_SAME_GAMES}, <= {ROUTE_MAX_DPI}); identical to the plain search "
          f"with kernels.mlp_eval at its leaves on {same_e:.4f} (not gated); {installs / B:.2f} "
          f"installs per game, of which {terminal / B:.2f} terminal children, so "
          f"{expansions / B:.2f} evaluations needed, and {steps / B:.2f} descent steps; kernel "
          f"{k1:.4f}/{k2:.4f} ms ({dev_ms:.4f} ms of device time), plain {p1:.4f}/{p2:.4f} ms, "
          f"bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}) | {card}", flush=True)

    # (b') a stack too large to stay resident runs staged: order-free
    # weights, bit-equal to its plain version
    staged_apply = make_apply_fn(
        convert_mlp(order_free_mlp_variables(A, MLP_STAGED_HIDDEN, seed=SEED)).to(dev))
    staged_w = staged_apply.kernel_eval_factory(flat)
    nbytes_s, resident_s = kernels.mlp_plan(MLP_STAGED_HIDDEN)
    if resident_s:
        fail(f"MLPNet {MLP_STAGED_HIDDEN} planned resident: the staged path would not run")
    s_args = inputs(staged_apply, staged_w)
    n_s, w_s, _ = plain_of(s_args, lambda bd, vm: fused.mlp_eval(bd, vm, staged_w))()
    (cs_, ws_), ks = timed_once(lambda: kernels.fused_mlp(*s_args))
    conserved(f"fused_mlp {MLP_STAGED_HIDDEN}", cs_, SIMS)
    if not (bit_equal(cs_, n_s[:, :, 0]) and bit_equal(ws_, w_s[:, :, 0])):
        fail(f"staged fused_mlp {MLP_STAGED_HIDDEN} differs from its plain version")
    print(f"[mlp] MLPNet {MLP_STAGED_HIDDEN}, order-free weights: staged ({nbytes_s} bytes of "
          f"dynamic shared memory), fused_mlp bit-equal to fused_mlp_search on all {B} games; "
          f"kernel {ks:.4f} ms (first call) | {card}", flush=True)

    # (c) the MLP actor through the ladder, at the engine bench's size and
    # at the mlp preset's
    def mlp_actor(batch: int, cfg: MCTSConfig, steps: int) -> tuple:
        torch.cuda.reset_peak_memory_stats()
        init_m, step_m = make_actor_step_fn(game, mlp_apply, cfg, batch, TEMP_THRESHOLD, device=dev)
        carry_m = init_m()
        gen_m = torch.Generator(device=dev).manual_seed(SEED)
        for _ in range(WARMUP_STEPS):
            carry_m, _ = step_m(carry_m, sample_draws(gen_m, batch, A, None, dev))
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        times = []
        for _ in range(steps):
            draws = sample_draws(gen_m, batch, A, None, dev)
            t0 = time.perf_counter()
            carry_m, pi_m = step_m(carry_m, draws)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        got = dict(kernels.launch_counts())
        if got != launches_of(kernels, fused_mlp=steps):
            fail(f"MLP actor launches {got}: want one fused_mlp launch per step and no other")
        if not torch.allclose(pi_m.sum(dim=1), torch.ones(batch, device=dev), atol=1e-5):
            fail("MLP actor pi rows do not sum to 1")
        ms = 1e3 * sum(times) / len(times)
        print(f"[mlp] actor, fused route, B={batch}, {cfg.num_sims} sims, max_depth "
              f"{cfg.max_depth}: {ms:.3f} ms/step mean, {1e3 * sorted(times)[len(times) // 2]:.3f} "
              f"upper median ({', '.join(f'{1e3 * t:.3f}' for t in times)}), "
              f"{batch / (ms / 1e3):.1f} env-steps/s | launches {launched(got)} | peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB | {card}", flush=True)
        return carry_m, got, ms

    carry_m, mlp_launches, ms_mlp = mlp_actor(B, cfg_mlp, TIMED_STEPS)
    mlp_actor(MLP_PRESET_B, MCTSConfig(num_sims=MLP_PRESET_SIMS, max_depth=MAX_DEPTH),
              MLP_PRESET_STEPS)

    # (d) one search of the actor's roots through both routes: the hybrid
    # route evaluates with the library forward (apply_fn without the
    # kernel_eval_factory that makes the ladder pick the fused kernel)
    state_m, _ = carry_m

    def no_kernel_eval(feats):
        return mlp_apply(feats)

    no_kernel_eval.needs_features = True
    c_fused = _make_root_counts_fn(game, mlp_apply, cfg_mlp)(state_m)
    hybrid_route = _make_root_counts_fn(game, no_kernel_eval, cfg_mlp)
    c_hybrid, ms_hybrid = timed_once(lambda: hybrid_route(state_m))
    live_m = ~game.terminal(state_m)[0]
    for label, c in (("fused", c_fused), ("hybrid", c_hybrid)):
        if not torch.isfinite(c).all() or c.shape != (B, A):
            fail(f"MLP {label}-route counts are not finite [B, A]")
        if not bool((c.sum(dim=1)[live_m] == SIMS).all()):
            fail(f"MLP {label}-route counts of live games do not sum to the simulation budget")
    same_route, dpi = search_agreement("MLP fused and hybrid routes", c_fused, c_hybrid)
    print(f"[mlp] one search of the actor's roots through the fused and the hybrid routes: "
          f"{same_route:.4f} of {B} games identical, max |dpi| {dpi:.4f}; hybrid-route search "
          f"{ms_hybrid:.3f} ms | {card}", flush=True)

    # (e) the library forward, the hybrid route's evaluation, per call
    feats_m = game.to_features(state_m).contiguous()
    mlp_fwd_ms = time_ms(lambda: mlp_apply(feats_m), 20)
    entry["library_ms"] = mlp_fwd_ms * SIMS
    print(f"[mlp] library forward (F.linear, bf16), B={B}: {mlp_fwd_ms:.4f} ms per call, "
          f"{mlp_fwd_ms * SIMS:.4f} ms for {SIMS} sims | {card}", flush=True)
    return {"fused_mlp": entry}, {"fused_mlp": mlp_launches["fused_mlp"]}, ms_mlp


def fused_sweep(card: str, roots: torch.Tensor) -> None:
    """``az_fused`` and ``az_fused_rounds`` (K=ROUND_K) at each B of
    SWEEP_BS on the first B of ``roots`` (the uniform actor's; 100 sims,
    C=101, max_depth 48, the uniform model's value): the device time per
    launch, a line each. Time linear in B at the top end is a throughput
    limit; time flat in B is latency."""
    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.config import MCTSConfig
    from alphazero_tpu_torch.games import ConnectFour
    from alphazero_tpu_torch.games.connect_four import FlatOps
    from alphazero_tpu_torch.mcts.tree import INVALID_P
    from alphazero_tpu_torch.models import make_uniform_model
    from alphazero_tpu_torch.ops import root_prior

    game, flat = ConnectFour(), FlatOps()
    uniform = make_uniform_model(game)
    uval = float(uniform.apply_fn.uniform_value)
    for K in (1, ROUND_K):
        cfg = MCTSConfig(num_sims=SIMS, max_depth=MAX_DEPTH, parallel_sims=K)
        for nb in SWEEP_BS:
            state = roots[:nb]
            prior, valid = root_prior(game, uniform.apply_fn, cfg, state, None)
            args = (flat.from_state(state).contiguous(), torch.where(valid, prior, INVALID_P),
                    SIMS, cfg.nodes, MAX_DEPTH, float(cfg.cpuct), uval)
            if K == 1:
                name, kernel = "az_fused", kernels.fused
            else:
                name, kernel, args = f"az_fused_rounds K={K}", kernels.fused_rounds, (*args, K)
            ms = device_ms(lambda: kernel(*args), reps=FUSED_REPS)
            print(f"[sweep] {name} B={nb}: {ms:.4f} ms of device time per launch, "
                  f"{1e6 * ms / nb:.3f} ns a game | {card}", flush=True)


def ptxas_lines(lib, names, gate: bool = True) -> None:
    """ptxas's report of the named kernels: registers, stack, spills and
    static shared bytes. With ``gate``, fails on a stack frame or a
    spill."""
    report = ptxas_report(lib.build_log, names)
    for name in names:
        got = report.get(name)
        print(f"[build] ptxas -v {name}: {got or 'not in the build log (a cached build)'}",
              flush=True)
        if gate and got and (got.get("stack") or got.get("spill_st") or got.get("spill_ld")):
            fail(f"{name} has a stack frame or spills: {got}")


def sweep(card: str) -> None:
    """``--sweep`` (see the module docstring)."""
    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.config import MCTSConfig
    from alphazero_tpu_torch.games import ConnectFour
    from alphazero_tpu_torch.models import make_uniform_model

    ptxas_lines(kernels.library(), FUSED_KERNELS, gate=False)   # also an older tree's kernels
    game = ConnectFour()
    carry, *_ = run_actor("sweep", game, make_uniform_model(game).apply_fn,
                          MCTSConfig(num_sims=SIMS, max_depth=MAX_DEPTH), UNIFORM_B, TIMED_STEPS,
                          TEMP_THRESHOLD, {"fused": 1}, card, "uniform actor")
    fused_sweep(card, carry[0])


def timed_search(tag: str, game, apply_fn, cfg, roots, noise, card: str, reps: int = 3) -> None:
    """One hybrid search of ``roots`` through the kernels, after a warm-up,
    ``reps`` times: ms per search (host clock around work ending in a
    synchronize)."""
    from alphazero_tpu_torch.mcts import hybrid

    root_counts = hybrid.make_hybrid_root_fn(game, apply_fn, cfg)
    root_counts(roots, noise)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        root_counts(roots, noise)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    print(f"[{tag}] one {game.name} search, B={roots.shape[0]}, {cfg.num_sims} sims, "
          f"K={cfg.parallel_sims}: {', '.join(f'{t:.3f}' for t in times)} ms | {card}", flush=True)


def merge_turns(card: str) -> None:
    """``--merges`` (see the module docstring)."""
    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.config import MCTSConfig
    from alphazero_tpu_torch.games import ConnectFour
    from alphazero_tpu_torch.mcts import hybrid
    from alphazero_tpu_torch.models import (
        convert_az_resnet,
        make_apply_fn,
        random_az_resnet_variables,
    )
    from alphazero_tpu_torch.ops import sample_draws

    dev = torch.device("cuda", 0)
    ptxas_lines(kernels.library(), MERGE_KERNELS, gate=False)   # also an older tree's kernels
    game = ConnectFour()
    A = game.num_actions
    apply_fn = make_apply_fn(convert_az_resnet(
        random_az_resnet_variables(A, channels=64, blocks=5, seed=SEED), dtype=torch.bfloat16).to(dev))
    # phase 3's and phase 11's Connect-Four planes
    roots = random_positions(game, B, 30, SEED, dev)
    noise = sample_draws(torch.Generator(device=dev).manual_seed(SEED), B, A, 1.0, dev).dirichlet
    cfg = MCTSConfig(num_sims=SIMS, max_depth=MAX_DEPTH, dirichlet_alpha=1.0)
    cfg_k = MCTSConfig(num_sims=SIMS, max_depth=MAX_DEPTH, dirichlet_alpha=1.0, parallel_sims=ROUND_K)
    _, m_args, _ = capture_search_args(game, apply_fn, cfg, roots, noise)
    _, m_round_args, _ = capture_round_args(game, apply_fn, cfg_k, roots, noise)
    for name, k_fn, p_fn, args in (("merge", kernels.merge, hybrid.merge, m_args),
                                   ("merge_round", kernels.merge_round, hybrid.merge_round,
                                    m_round_args)):
        result, (k_call, _) = merge_vs_plain(name, k_fn, p_fn, args)
        devs = [device_ms(k_call) for _ in range(MERGE_REPS)]
        print(f"[merges] {name} at B={B}, A={A}, K={1 if args[9].dim() == 2 else ROUND_K}: "
              f"bit-equal to plain; {', '.join(f'{d:.4f}' for d in devs)} ms of device time "
              f"per launch; bound {result['bound_ms']:.4f} ms ({result['touched_per_game']:.2f} "
              f"touched columns a game; whole-plane bound {result['whole_plane_bound_ms']:.4f} ms) "
              f"| {card}", flush=True)
    carry, step, gen, _, _ = run_actor(
        "merges", game, apply_fn, cfg, B, C4_STEPS, TEMP_THRESHOLD,
        {"descend": SIMS, "merge": SIMS, "refresh": 1}, card, "C4 ResNet actor, AZResNet-64x5 bf16")
    print_profiled_step("merges", lambda: step(carry, sample_draws(gen, B, A, 1.0, dev)), card,
                        "C4 ResNet K=1")
    timed_search("merges", game, apply_fn, cfg_k, roots, noise, card)


def descend_turns(card: str) -> None:
    """``--descends`` (see the module docstring)."""
    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.config import MCTSConfig
    from alphazero_tpu_torch.games import ConnectFour, Gomoku, Hex, Othello
    from alphazero_tpu_torch.models import (
        convert_az_resnet,
        make_apply_fn,
        make_uniform_model,
        random_az_resnet_variables,
    )
    from alphazero_tpu_torch.ops import sample_draws

    dev = torch.device("cuda", 0)
    ptxas_lines(kernels.library(), DESCEND_KERNELS, gate=False)   # also an older tree's kernels

    def resnet(game, channels):
        A = game.num_actions
        return make_apply_fn(convert_az_resnet(random_az_resnet_variables(
            A, channels, 5, cells=game.flat_ops().size, seed=SEED), dtype=torch.bfloat16).to(dev))

    c4, oth, g9, g15, g19, hx = ConnectFour(), Othello(), Gomoku(9), Gomoku(15), Gomoku(19), Hex()
    cells = (   # the planes of phases 3, 8, 9, 10 and 15: game, B, model, depth, Dirichlet, moves
        (c4, B, resnet(c4, 64), MAX_DEPTH, 1.0, 30),
        (oth, OTH_B, resnet(oth, OTH_CHANNELS), OTH_MAX_DEPTH, OTH_DIRICHLET, 40),
        (g9, GMK_B, resnet(g9, GMK_CHANNELS), GMK_MAX_DEPTH, GMK_DIRICHLET, g9.num_actions // 2),
        (g15, GMK_B, make_uniform_model(g15).apply_fn, GMK15_MAX_DEPTH, None, g15.num_actions // 2),
        (g19, GMK_B, make_uniform_model(g19).apply_fn, GMK15_MAX_DEPTH, None, g19.num_actions // 3),
        (hx, HEX_B, resnet(hx, GMK_CHANNELS), HEX_MAX_DEPTH, HEX_DIRICHLET, 30),
    )
    for game, batch, apply_fn, depth, alpha, moves in cells:
        A = game.num_actions
        roots = random_positions(game, batch, moves, SEED, dev)
        noise = None if alpha is None else sample_draws(
            torch.Generator(device=dev).manual_seed(SEED), batch, A, alpha, dev).dirichlet
        for K in (1, ROUND_K):
            cfg = MCTSConfig(num_sims=SIMS, max_depth=depth, dirichlet_alpha=alpha, parallel_sims=K)
            if K == 1:
                d_args, _, _ = capture_search_args(game, apply_fn, cfg, roots, noise)
                name = kernels.descend_entry(game.flat_ops())[3:]
                kernel = getattr(kernels, name)
                result, _, _ = descend_vs_plain(name, kernel, d_args)
            else:
                d_args, _, _ = capture_round_args(game, apply_fn, cfg, roots, noise)
                name, kernel, result, _, _ = descend_round_vs_plain(d_args)
            devs = [device_ms(lambda: kernel(*d_args)) for _ in range(DESCEND_REPS)]
            print(f"[descends] {name}, {game.name}, B={batch}, C={cfg.nodes}, K={K}: bit-equal to "
                  f"plain; {', '.join(f'{d:.4f}' for d in devs)} ms of device time per launch; "
                  f"bound {result['bound_ms']:.5f} ms ({result['bound_by']}) | {card}", flush=True)


def seed_turns(card: str) -> None:
    """``--seeds`` (see the module docstring)."""
    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.config import MCTSConfig
    from alphazero_tpu_torch.games import ConnectFour, Gomoku, Hex, Othello
    from alphazero_tpu_torch.mcts import hybrid
    from alphazero_tpu_torch.mcts.tree import INVALID_P
    from alphazero_tpu_torch.models import make_uniform_model
    from alphazero_tpu_torch.ops import root_prior, sample_draws

    dev = torch.device("cuda", 0)
    ptxas_lines(kernels.library(), (*SEED_KERNELS, *OLD_SEED_KERNELS), gate=False)
    c4, oth, g9, g15, g19, hx = ConnectFour(), Othello(), Gomoku(9), Gomoku(15), Gomoku(19), Hex()
    # the roots of phases 3 and 11(e) (the same), 5 (its first: the initial
    # position), 10, 8, 9, 9(d)'s batch and 15: game, B, Dirichlet, moves
    cells = (
        (c4, B, 1.0, 30),
        (c4, B, 1.0, 0),
        (hx, HEX_B, HEX_DIRICHLET, 30),
        (oth, OTH_B, OTH_DIRICHLET, 40),
        (g9, GMK_B, GMK_DIRICHLET, g9.num_actions // 2),
        (g15, GMK_B, None, g15.num_actions // 2),
        (g15, GMK15_B, None, g15.num_actions // 2),
        (g19, GMK_B, None, g19.num_actions // 3),
    )
    for game, batch, alpha, moves in cells:
        A = game.num_actions
        ops = game.flat_ops()
        roots = random_positions(game, batch, moves, SEED, dev)
        noise = None if alpha is None else sample_draws(
            torch.Generator(device=dev).manual_seed(SEED), batch, A, alpha, dev).dirichlet
        cfg = MCTSConfig(num_sims=SIMS, dirichlet_alpha=alpha)
        # the fresh planes a search seeds its best planes from, the uniform
        # model's root prior (with the preset's Dirichlet noise) at node 0
        prior, valid = root_prior(game, make_uniform_model(game).apply_fn, cfg, roots, noise)
        planes = hybrid._init_planes(ops, ops.from_state(roots), torch.where(valid, prior, INVALID_P),
                                     cfg.nodes, ops.aux(dev))
        r_args = (*planes[:4], float(cfg.cpuct))
        dense = "_dense" if A > hybrid.UNROLLED_MAX_A else ""
        for name, plain in ((f"refresh{dense}", hybrid.refresh), (f"refresh2{dense}", hybrid.refresh2)):
            result, (k_call, _) = seed_vs_plain(name, getattr(kernels, name), plain, r_args)
            devs = [device_ms(k_call) for _ in range(SEED_REPS)]
            print(f"[seeds] {name}, {game.name}, B={batch}, C={cfg.nodes}, A={A}: bit-equal to "
                  f"plain; {', '.join(f'{d:.4f}' for d in devs)} ms of device time per launch; "
                  f"bound {bound_text(result)} | {card}", flush=True)


def actors(card: str) -> None:
    """``--actors`` (see the module docstring)."""
    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.config import MCTSConfig
    from alphazero_tpu_torch.games import Gomoku, Othello
    from alphazero_tpu_torch.models import (
        convert_az_resnet,
        make_apply_fn,
        make_uniform_model,
        random_az_resnet_variables,
    )
    from alphazero_tpu_torch.ops import sample_draws

    dev = torch.device("cuda", 0)
    kernels.library()
    g15, oth = Gomoku(15), Othello()
    oth_net = make_apply_fn(convert_az_resnet(
        random_az_resnet_variables(oth.num_actions, OTH_CHANNELS, OTH_BLOCKS, cells=64, seed=SEED),
        dtype=torch.bfloat16).to(dev))
    rounds = SIMS // ROUND_K
    cells = (
        ("gomoku15 uniform actor", g15, make_uniform_model(g15).apply_fn,
         MCTSConfig(num_sims=SIMS, max_depth=GMK15_MAX_DEPTH), GMK15_B, GMK_TEMP_THRESHOLD,
         {"descend_gomoku": SIMS, "merge_dense": SIMS, "refresh_dense": 1}),
        (f"Othello full preset actor at K={ROUND_K}", oth, oth_net,
         MCTSConfig(num_sims=SIMS, max_depth=OTH_MAX_DEPTH, dirichlet_alpha=OTH_DIRICHLET,
                    parallel_sims=ROUND_K), OTH_B, OTH_TEMP_THRESHOLD,
         {"descend_round_othello": rounds, "merge_round_dense": rounds, "refresh2_dense": 1}),
    )
    for label, game, apply_fn, cfg, batch, temp, want in cells:
        for after in ("", ", after empty_cache"):
            if after:
                torch.cuda.empty_cache()
            carry, step, gen, _, _ = run_actor("actors", game, apply_fn, cfg, batch, OTH_STEPS,
                                               temp, want, card, label + after)
            print_profiled_step("actors", lambda: step(carry, sample_draws(
                gen, batch, game.num_actions, cfg.dirichlet_alpha, dev)), card, label + after)
            del carry, step


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from alphazero_tpu_torch.config import MCTSConfig
    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.games import ConnectFour
    from alphazero_tpu_torch.games.connect_four import FlatOps
    from alphazero_tpu_torch.mcts import PLAIN, SearchKernels, fused, hybrid
    from alphazero_tpu_torch.mcts.tree import INVALID_P
    from alphazero_tpu_torch.models import (
        convert_az_resnet,
        make_apply_fn,
        make_uniform_model,
        random_az_resnet_variables,
    )
    from alphazero_tpu_torch.ops import root_prior, sample_draws
    from alphazero_tpu_torch.selfplay import _make_root_counts_fn, make_actor_step_fn

    # f32 matmuls/convs in full precision wherever f32 runs (the bf16
    # ResNet convs are unaffected)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    game = ConnectFour()
    A = game.num_actions

    # ---- 1. card -------------------------------------------------------
    card = card_line()
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {torch.cuda.get_device_name(0)}", flush=True)
    if sys.argv[1:] == ["--actors"]:
        actors(card)
        return 0
    if sys.argv[1:] == ["--sweep"]:
        sweep(card)
        return 0
    if sys.argv[1:] == ["--merges"]:
        merge_turns(card)
        return 0
    if sys.argv[1:] == ["--descends"]:
        descend_turns(card)
        return 0
    if sys.argv[1:] == ["--seeds"]:
        seed_turns(card)
        return 0
    if sys.argv[1:] == ["--tower"]:
        tower_turns(card)
        return 0

    # ---- 2. build ------------------------------------------------------
    lib = kernels.library()
    print(f"[build] nvcc {' '.join(kernels.NVCC_FLAGS[:2])} -> {os.path.relpath(lib.path)} "
          f"({len(kernels.SOURCES)} sources compiled in parallel, linked into one library; "
          f"{lib.build_seconds:.3f} s)", flush=True)
    for ln in lib.build_log.splitlines():
        if ln.startswith("[") or "entry function" in ln or "registers" in ln or "spill" in ln:
            print(f"[build] {ln.strip()}", flush=True)
    mlp_kernels = ("fused_mlp_kernel", "fused_mlp_rounds_kernel", "mlp_eval_kernel")
    # the dense merges' instances (J actions a lane), by a piece of their
    # mangled names
    instances = {f"merge{r}_dense_kernel<{j}>": f"merge{r}_dense_kernelILi{j}E"
                 for r in ("", "_round") for j in (4, 8, 16)}
    report = ptxas_report(lib.build_log, (*mlp_kernels, *instances.values()))
    for name in (*mlp_kernels, *instances):
        print(f"[build] ptxas -v {name}: "
              f"{report.get(instances.get(name, name), 'not in the build log (a cached build)')}",
              flush=True)
    ptxas_lines(lib, (*FUSED_KERNELS, *MERGE_KERNELS, *DESCEND_KERNELS, *SEED_KERNELS,
                      *TOWER_KERNELS))

    # ---- 3. kernels vs plain at the main path's shapes ------------------
    variables = random_az_resnet_variables(A, channels=64, blocks=5, seed=SEED)
    model = convert_az_resnet(variables, dtype=torch.bfloat16).to(dev)
    apply_fn = make_apply_fn(model)
    cfg_full = MCTSConfig(num_sims=SIMS, max_depth=MAX_DEPTH, dirichlet_alpha=1.0)
    C = cfg_full.nodes

    captured = {}

    def capture_descend(*args):
        captured["descend"] = [a.clone() if torch.is_tensor(a) else a for a in args]
        return hybrid.descend(*args)

    def capture_merge(*args):
        captured["merge"] = [a.clone() if torch.is_tensor(a) else a for a in args]
        return hybrid.merge(*args)

    def capture_refresh(*args):
        captured["refresh"] = [a.clone() if torch.is_tensor(a) else a for a in args]
        return hybrid.refresh(*args)

    warm_sims = 24
    cfg_cap = MCTSConfig(num_sims=warm_sims, max_nodes=C, max_depth=MAX_DEPTH, dirichlet_alpha=1.0)
    roots = random_positions(game, B, 30, SEED, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    noise = sample_draws(gen, B, A, 1.0, dev).dirichlet
    hybrid.make_hybrid_root_fn(
        game, apply_fn, cfg_cap, kernels=SearchKernels(capture_descend, capture_merge, capture_refresh)
    )(roots, noise)
    d_args, m_args, r_args = captured["descend"], captured["merge"], captured["refresh"]
    if d_args[0].shape != (B, C) or m_args[0].shape != (B, A, C):
        fail(f"captured planes have shapes {d_args[0].shape}, {m_args[0].shape}")

    results = {}
    results["descend"], edges, _ = descend_vs_plain("descend", kernels.descend, d_args)

    # the A <= 8 merge reads and refreshes only the columns it writes; the
    # captured best planes are the refresh of the captured planes (its
    # precondition). Its bound counts those columns; the whole-plane one
    # rides beside it, labelled
    results["merge"], merge_fns = merge_vs_plain("merge", kernels.merge, hybrid.merge, m_args)

    # the refresh seeds a search from its fresh planes (_init_planes), its
    # precondition, and reads only the roots' priors; its bound counts those
    # and the rows it writes, the sector and whole-plane ones ride beside it
    results["refresh"], refresh_fns = seed_vs_plain("refresh", kernels.refresh, hybrid.refresh,
                                                    r_args)
    print(f"[kernels] B={B} C={C} A={A}: descend, merge, refresh bit-equal to plain "
          f"(mean path length {edges / B:.2f} edges/game)", flush=True)

    # timing, in turns: plain, kernel, kernel, plain
    fns = {
        "descend": (lambda: kernels.descend(*d_args), lambda: hybrid.descend(*d_args)),
        "merge": merge_fns,
        "refresh": refresh_fns,
    }
    time_in_turns(results, fns, "kernels", card)

    feats = game.to_features(roots).contiguous()
    nn_ms = time_ms(lambda: apply_fn(feats), 20)
    print(f"[nn] AZResNet-64x5 bf16 folded forward, B={B}: {nn_ms:.4f} ms per sim | {card}",
          flush=True)

    # ---- 4. goldens ----------------------------------------------------
    golden = read_goldens("golden_counts.json")["connect_four"]
    states = []
    for seq in golden["seqs"]:
        s = game.init(1, dev)
        for a in seq:
            s = game.step(s, torch.tensor([a], device=dev))
        states.append(s)
    uniform = make_uniform_model(game)
    kernels.reset_launch_counts()
    counts = hybrid.make_hybrid_root_fn(
        game, uniform.apply_fn, MCTSConfig(num_sims=50, max_depth=64)
    )(torch.cat(states))
    if kernels.descend.launches != 50 or kernels.merge.launches != 50:
        fail(f"golden search did not run the kernels: {kernels.launch_counts()}")
    if counts.round().int().tolist() != golden["counts"]:
        fail(f"golden counts differ: {counts.int().tolist()} != {golden['counts']}")
    print(f"[goldens] CUDA path reproduces tests/golden_counts.json connect_four "
          f"({len(states)} positions, 50 sims)", flush=True)

    # ---- 5. the slice: actor steps --------------------------------------
    init_carry, actor_step = make_actor_step_fn(
        game, apply_fn, cfg_full, B, TEMP_THRESHOLD, device=dev
    )
    gen = torch.Generator(device=dev).manual_seed(SEED)
    carry = init_carry()
    for _ in range(WARMUP_STEPS):
        carry, pi = actor_step(carry, sample_draws(gen, B, A, 1.0, dev))
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    step_s = []
    for _ in range(TIMED_STEPS):
        draws = sample_draws(gen, B, A, 1.0, dev)
        t0 = time.perf_counter()
        carry, pi = actor_step(carry, draws)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if not torch.allclose(pi.sum(dim=1), torch.ones(B, device=dev), atol=1e-5):
            fail("pi rows do not sum to 1")
    launches = dict(kernels.launch_counts())
    want = launches_of(kernels, descend=TIMED_STEPS * SIMS, merge=TIMED_STEPS * SIMS,
                       refresh=TIMED_STEPS)
    if launches != want:
        fail(f"launch counts {launches} != {want}")
    ms_move = 1e3 * sum(step_s) / len(step_s)
    ms_median = 1e3 * sorted(step_s)[len(step_s) // 2]
    print(f"[slice] AZResNet-64x5 bf16, B={B}, {SIMS} sims, dirichlet 1.0: "
          f"{ms_move:.3f} ms/move mean, {ms_median:.3f} upper median "
          f"({', '.join(f'{1e3 * s:.3f}' for s in step_s)}), "
          f"{B / (ms_move / 1e3):.1f} env-steps/s | launches {launched(launches)} | {card}", flush=True)
    print_profiled_step("slice", lambda: actor_step(carry, sample_draws(gen, B, A, 1.0, dev)), card,
                        "C4 ResNet K=1")

    # identical counts through the kernels and through the plain versions
    state, _ = carry
    draws = sample_draws(gen, B, A, 1.0, dev)
    c_kernel = hybrid.make_hybrid_root_fn(game, apply_fn, cfg_full)(state, draws.dirichlet)
    c_plain = hybrid.make_hybrid_root_fn(game, apply_fn, cfg_full, kernels=PLAIN)(
        state, draws.dirichlet
    )
    if not torch.isfinite(c_kernel).all() or c_kernel.shape != (B, A):
        fail("kernel-path counts are not finite [B, A]")
    live = ~game.terminal(state)[0]
    if not bool((c_kernel.sum(dim=1)[live] == SIMS).all()):
        fail("root counts of live games do not sum to the simulation budget")
    if not torch.equal(c_kernel, c_plain):
        diff = int((c_kernel != c_plain).any(dim=1).sum())
        fail(f"kernel and plain searches differ on {diff} of {B} games")
    print(f"[slice] one search through the plain versions: identical counts on all {B} games",
          flush=True)

    # ---- 6. the fused kernel and the uniform actor ----------------------
    flat = FlatOps()
    cfg_uni = MCTSConfig(num_sims=SIMS, max_depth=MAX_DEPTH)
    uval = float(uniform.apply_fn.uniform_value)

    def fused_inputs(state, value: float) -> tuple:
        """The arguments of ``kernels.fused`` for a search of ``state``, as
        the fused engine's ``root_counts`` makes them."""
        prior, valid = root_prior(game, uniform.apply_fn, cfg_uni, state, None)
        return (flat.from_state(state).contiguous(), torch.where(valid, prior, INVALID_P),
                SIMS, cfg_uni.nodes, MAX_DEPTH, float(cfg_uni.cpuct), value)

    def fused_vs_plain(f_args, label: str) -> dict:
        """``az_fused`` against its plain version (``fused.fused_search``,
        run here through its body so that the whole N plane is kept) on the
        same inputs: counts and root W bit-equal; both timed, in turns."""
        bds, pm, value = f_args[0], f_args[1], f_args[-1]
        nb = bds.shape[0]

        def plain():
            return hybrid.run_search(flat, bds, pm, cfg_uni,
                                     fused.uniform_evaluator(nb, value, dev), PLAIN)

        (n_all, w_all), p1 = timed_once(plain)
        ck, wk = kernels.fused(*f_args)
        cp, wp = n_all[:, :, 0], w_all[:, :, 0]
        if not (bit_equal(ck, cp) and bit_equal(wk, wp)):
            diff = int(((ck != cp) | (wk != wp)).any(dim=1).sum())
            fail(f"fused kernel differs from its plain version on {diff} of {nb} games ({label})")
        k1 = time_ms(lambda: kernels.fused(*f_args), FUSED_REPS)
        k2 = time_ms(lambda: kernels.fused(*f_args), FUSED_REPS)
        _, p2 = timed_once(plain)
        dev_ms = device_ms(lambda: kernels.fused(*f_args), reps=FUSED_REPS)
        # the work depends on the data: every descent step is one PUCT
        # argmax and one backup; a search's steps are the sum of N over
        # every edge
        steps = float(n_all.sum())
        out = {"max_abs_err": max(float((ck - cp).abs().max()), float((wk - wp).abs().max())),
               "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
               **bound(F32 * nb * (42 + A + 2 * A), steps * (puct_ops(1, A) + 3))}
        print(f"[fused] {label}: B={nb}, {SIMS} sims, max_depth {MAX_DEPTH}, uval {value}: "
              f"az_fused bit-equal to fused_search (counts and root W; {steps / nb:.2f} descent "
              f"steps per game); kernel {k1:.4f}/{k2:.4f} ms ({dev_ms:.4f} ms of device time), "
              f"plain {p1:.4f}/{p2:.4f} ms, "
              f"bound {out['bound_ms']:.4f} ms ({out['bound_by']}) | {card}", flush=True)
        return out

    fused_vs_plain(fused_inputs(roots, 0.5), "random roots")

    kernels.reset_launch_counts()
    counts = fused.make_fused_root_fn(game, uniform.apply_fn, MCTSConfig(num_sims=50, max_depth=64))(
        torch.cat(states)
    )
    if kernels.launch_counts() != launches_of(kernels, fused=1):
        fail(f"golden search did not run the fused kernel once: {kernels.launch_counts()}")
    if counts.round().int().tolist() != golden["counts"]:
        fail(f"fused golden counts differ: {counts.int().tolist()} != {golden['counts']}")
    print("[fused] the fused engine reproduces tests/golden_counts.json connect_four in 1 launch",
          flush=True)

    # the uniform actor at the headline bench's size, through the ladder
    torch.cuda.reset_peak_memory_stats()
    init_u, step_u = make_actor_step_fn(game, uniform.apply_fn, cfg_uni, UNIFORM_B, TEMP_THRESHOLD,
                                        device=dev)
    carry_u = init_u()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for _ in range(WARMUP_STEPS):
        carry_u, _ = step_u(carry_u, sample_draws(gen, UNIFORM_B, A, None, dev))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    step_s = []
    for _ in range(TIMED_STEPS):
        draws = sample_draws(gen, UNIFORM_B, A, None, dev)
        t0 = time.perf_counter()
        carry_u, pi = step_u(carry_u, draws)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    uni_launches = dict(kernels.launch_counts())
    if uni_launches != launches_of(kernels, fused=TIMED_STEPS):
        fail(f"uniform actor launches {uni_launches}: want one fused launch per step, no hybrid")
    if not torch.allclose(pi.sum(dim=1), torch.ones(UNIFORM_B, device=dev), atol=1e-5):
        fail("uniform actor pi rows do not sum to 1")
    peak = torch.cuda.max_memory_allocated()
    ms_u = 1e3 * sum(step_s) / len(step_s)
    print(f"[uniform] fused route, B={UNIFORM_B}, {SIMS} sims, max_depth {MAX_DEPTH}: "
          f"{ms_u:.3f} ms/step mean, {1e3 * sorted(step_s)[len(step_s) // 2]:.3f} upper median "
          f"({', '.join(f'{1e3 * t:.3f}' for t in step_s)}), {UNIFORM_B / (ms_u / 1e3):.1f} "
          f"env-steps/s | launches {launched(uni_launches)} | peak memory {peak / 2**30:.3f} GiB | {card}",
          flush=True)
    print_profiled_step("uniform", lambda: step_u(carry_u, sample_draws(gen, UNIFORM_B, A, None, dev)),
                        card, "uniform K=1")
    state_u, _ = carry_u
    # the main path's kernel, held against its plain version on the actor's
    # own roots at the actor's shape and uniform value
    results["fused"] = fused_vs_plain(fused_inputs(state_u, uval), "the uniform actor's roots")
    fused_sweep(card, state_u)

    # the same actor through the hybrid route: the uniform model's apply_fn
    # without the uniform_value that makes the ladder pick the fused kernel
    def no_fused(feats):
        return uniform.apply_fn(feats)

    no_fused.needs_features = False
    init_h, step_h = make_actor_step_fn(game, no_fused, cfg_uni, UNIFORM_B, TEMP_THRESHOLD,
                                        device=dev)
    carry_h = (state_u, carry_u[1])
    carry_h, _ = step_h(carry_h, sample_draws(gen, UNIFORM_B, A, None, dev))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    step_h_s = []
    for _ in range(HYBRID_STEPS):
        draws = sample_draws(gen, UNIFORM_B, A, None, dev)
        t0 = time.perf_counter()
        carry_h, _ = step_h(carry_h, draws)
        torch.cuda.synchronize()
        step_h_s.append(time.perf_counter() - t0)
    hyb_launches = dict(kernels.launch_counts())
    if hyb_launches["fused"] != 0 or hyb_launches["merge"] != HYBRID_STEPS * SIMS:
        fail(f"hybrid-route actor launches {hyb_launches}")
    ms_h = 1e3 * sum(step_h_s) / len(step_h_s)
    print(f"[uniform] hybrid route, same actor: {ms_h:.3f} ms/step mean "
          f"({', '.join(f'{1e3 * t:.3f}' for t in step_h_s)}), {UNIFORM_B / (ms_h / 1e3):.1f} "
          f"env-steps/s | launches {launched(hyb_launches)} | fused is {ms_h / ms_u:.1f}x faster | {card}",
          flush=True)

    c_fused = _make_root_counts_fn(game, uniform.apply_fn, cfg_uni)(state_u)
    c_hybrid = _make_root_counts_fn(game, no_fused, cfg_uni)(state_u)
    if not torch.isfinite(c_fused).all() or c_fused.shape != (UNIFORM_B, A):
        fail("fused-route counts are not finite [B, A]")
    live_u = ~game.terminal(state_u)[0]
    if not bool((c_fused.sum(dim=1)[live_u] == SIMS).all()):
        fail("fused-route counts of live games do not sum to the simulation budget")
    if not torch.equal(c_fused, c_hybrid):
        diff = int((c_fused != c_hybrid).any(dim=1).sum())
        fail(f"fused and hybrid routes differ on {diff} of {UNIFORM_B} games")
    print(f"[uniform] one search through the fused and the hybrid routes: identical counts on "
          f"all {UNIFORM_B} games", flush=True)
    launches["fused"] = uni_launches["fused"]

    # ---- 7. the MLP: the fused kernel with the in-kernel evaluator ------
    phase_results, phase_launches, ms_mlp = mlp_phase(card, roots)
    results.update(phase_results)
    launches.update(phase_launches)

    # ---- 8-11. Othello, Gomoku and Hex on the hybrid engine; rounds ----
    for phase in (othello_phase, gomoku_phase, hex_phase, rounds_phase):
        phase_results, phase_launches = phase(card)
        results.update(phase_results)
        launches.update(phase_launches)

    # ---- 12. the fused engine's K>1 rounds ------------------------------
    phase_results, phase_launches = fused_rounds_phase(card, {"uniform": ms_u, "mlp": ms_mlp})
    results.update(phase_results)
    launches.update(phase_launches)

    # ---- 13. the fused int8 tower --------------------------------------
    phase_results, phase_launches = int8_tower_phase(card)
    results.update(phase_results)
    launches.update(phase_launches)

    # ---- 14. what the fused engine declines runs on the hybrid one -------
    fallthrough_phase(card)

    # ---- 15. Gomoku 19 --------------------------------------------------
    gomoku19_phase(card)

    print(card)
    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCE[name],
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": results[name]["max_abs_err"],
            "ms": results[name]["ms"],
            "plain_ms": results[name]["plain_ms"],
            "bound_ms": results[name]["bound_ms"],
            "bound_by": results[name]["bound_by"],
            # no single PyTorch call computes these functions; for fused_mlp
            # the chain of library forwards a search's evaluations take, for
            # int8_tower the torch._int_mm chain
            "library_ms": results[name].get("library_ms"),
            # the merges and the seeds: beside the bound of what the
            # data needs, the bound of a kernel that refreshes every node,
            # and a seed's with each prior read as its own 32-byte sector
            **{k: results[name][k] for k in ("whole_plane_bound_ms", "sector_bound_ms")
               if k in results[name]},
        }
        for name in ("descend", "merge", "refresh", "fused", "fused_mlp",
                     "descend_othello", "merge_dense", "refresh_dense", "descend_gomoku",
                     "descend_hex", "descend_round", "descend_round_othello",
                     "descend_round_gomoku", "descend_round_hex", "merge_round",
                     "merge_round_dense", "refresh2", "refresh2_dense", "fused_rounds",
                     "fused_mlp_rounds", "int8_tower")
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
