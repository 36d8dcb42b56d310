#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``alphazero_tpu_torch``).

Drives the port's self-play paths — the steady-state Connect-Four actor on
the hybrid engine with an AZResNet-64x5, on the fused kernel with the
uniform model, and on the fused kernel with an MLPNet (256, 256) evaluated
inside it; then Othello, Gomoku and Hex on the hybrid engine, the hybrid
engine's K=4 leaf-parallel rounds, and the fused engine's K>1 rounds for
the uniform model and the MLP; then the fused int8 ResNet tower of the
experiment ``int8_fused_tower``; then the fused engine at any MLP width
and on Gomoku boards of at most 16 cells, and Gomoku 19; then the learner
loop (recycling self-play, the replay ring, the learner step and back);
then the coach
(gate arena, anchored rating pass, whole-state checkpoint and resume); then
the coach on Othello, Gomoku, Hex and the Connect-Four ``AZConvNet``; then
the dense engine (plain PyTorch, the engine ladder's last rung), forced
playouts in the fixed scan, and the play and analyze CLIs; then the
training economy (Gumbel search, the ``economy`` preset, playout-cap
randomization, reanalyze); then the transposition-DAG engine through its
routes; then the data-parallel path; then Gomoku boards above 512 cells on
the kernels' wider instances; then Gomoku boards above 768 cells and round
searches above K = 16 on the leaf-row, streamed and wide instances — on one
CUDA card, in phases:

1. card:   the card's name and power limit (``nvidia-smi``);
2. build:  the hand-written kernels (``csrc/hybrid.cu``, ``csrc/fused.cu``,
           ``csrc/int8_tower.cu``)
           compiled with nvcc for sm_90a, one process per source, and linked
           into one library, with the build seconds and ptxas's register
           report, and the registers, stack and static shared bytes of the
           three MLP kernels, of the two uniform fused kernels, of the two
           A <= 8 merges, of the eight hybrid descends and of the eight
           instances of the seed (these twenty must have no stack frame and
           no spill), and of the dense merges' instances (J = 4, 8, 16 and
           24 actions a lane; phase 23 prints the 12-word descends' and the
           J = 24 seeds', none of these gated: a spill is printed; phase 24
           prints and gates the leaf-row, streamed and wide instances');
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
           of games identical and max |dpi| <= 0.25, both timed, with the
           library forward's time for 100 calls on the roots' features
           (``fused_mlp_vs_plain``, which phase 16(e) runs again on the
           ``mlp`` preset's own roots for the kernels line), and, not
           gated, the share of games identical to a plain search whose
           leaves ``kernels.mlp_eval`` evaluates; (b') MLPNet (256, 256, 256, 256), too large to stay
           in shared memory, runs staged once, order-free, bit-equal to
           plain; (c) the MLP actor
           at the engine bench's size (B=4096, 100 sims, max_depth 48, no
           Dirichlet): one fused_mlp launch per step and no other, ms/step,
           env-steps/s and peak memory, then a few steps at the preset's
           own B=512, 50 sims; (d) one search of the actor's roots through
           the fused route and through the hybrid route (the library
           forward): >= 75% of games identical and max |dpi| <= 0.25, the
           JAX package's bound between its Mosaic and XLA engines;
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
14. fused_wide: the configurations the JAX fused kernel takes and the
           port's fused kernels once declined, on the fused route: (a)
           MLPNet (512, 512) on Connect-Four (the streamed evaluator; seeded
           random and order-free weights), its evaluator alone against its
           plain version on B=4096 boards, then at the mlp preset's B=512,
           50 sims and at B=4096, 100 sims: the kernel bit-equal to its
           plain version with order-free weights, within the gate (>= 75%
           of games identical, max |dpi| <= 0.25) with random ones, timed in
           turns, with the bound, the leaves' library forwards and the
           weights' L2 re-reads; the ladder's fused route (one
           fused_mlp_stream launch and no other) against the hybrid route
           it replaces (whole searches, within the gate, both timed); and
           actor steps at B=512 through the ladder; (b) ``Gomoku(4, 4)``
           (a warp a game) and ``Gomoku(3, 3)`` (16 lanes a game, and K=4
           rounds), B=4096, 100 sims, uniform and MLPNet (256, 256): the
           same checks, uniform counts identical to the hybrid route's;
           ptxas's registers of the new instances (the small-Gomoku uniform
           ones gated for stack and spills, the streamed ones for spills)
           and of the unchanged Connect-Four ones; (c) MLPNet (2048,) on
           Connect-Four, its activations in the device scratch: the
           evaluator alone, order-free weights, bit-equal, one
           mlp_eval_stream launch; (d) ``Gomoku(2, 2)`` at K=20 (the
           leaves past K = 9 in the device scratch), B=4096, 100 sims,
           uniform and MLPNet (32,): the checks of (b); (e) the resident
           and the streamed plan on MLPNet (256, 256) (``fused_mlp``,
           ``fused_mlp_stream``) at B=4096, 100 sims and B=512, 50 sims:
           counts within the gate, device times in turns;
15. gomoku19: Gomoku 19 (361 cells) on the hybrid engine, uniform model,
           B=1024, 100 sims, max_depth 64: (a) ``descend_gomoku`` (6 of its
           8 board words) and the dense merge and refresh at A=361 against
           their plain versions on planes from a plain search (the refresh
           on its fresh planes; bit-equal, timed in turns); (b)
           ``descend_round_gomoku``, the dense round merge and the top-2
           refresh at K=4 (the same); (c) one timed
           actor step, its launches and peak memory; (d) one K=1 and one K=4
           search through the kernels and the plain versions, identical
           counts;
16. learner: the learner loop of the Connect-Four ``full`` preset
           (AZResNet-64x5 bf16, seeded random weights, B=4096, 100 sims,
           Dirichlet 1.0, ``recycle=True``), with the launch counters set
           to 0 just before each self-play call and read just after: (a)
           one recycling call (42 searches: 4200 descend and merge launches,
           42 refresh), its pi rows and boards bit-equal to
           ``make_actor_step_fn``'s steps under the same draws; (b) the
           trajectory into the 2^21-row ring on the card, bit-equal to the
           CPU insert of the same trajectory (twice: the second time is the
           steady one); (c) 16 of the preset's train steps (batch 1024), the
           first against the same step of a CPU copy within
           tests/test_torch_train.py's bf16 bound, the last profiled, then
           one more profiled call by call (``learner_step_stages``: the
           device kernels of the forward, the backward, Adam's step and
           one BatchNorm); (d) a second
           recycling call with the trained weights (refolded), every carried
           fragment row of a game that closed in it valid; (e) the ``mlp``
           preset's fixed scan (MLPNet (256, 256), B=512, 50 sims, T=42: 42
           ``fused_mlp`` launches); ``fused_mlp`` against its plain version
           (``fused_mlp_vs_plain``, 7(b)'s gate) on the scan's own roots at
           step 10 (most games live) and at its last step (most finished:
           frozen terminal roots, which must stay inert), the kernels
           line's ``fused_mlp`` numbers (error over both, times and bound
           at step 10); 8 train steps (batch 512) on its ring, and the scan
           again on the repacked weights. It prints ms per self-play call
           and per move, moves and valid samples per second, the insert's
           ms, train ms per step and peak memory; its launches of
           ``descend``, ``merge``, ``refresh`` and ``fused_mlp`` were the
           kernels line's until phase 17;
17. coach: the outer loop through ``Coach.learn`` (``coach_phase``): (a)
           the ``full`` preset as the training CLI builds it
           (``examples.train_connect_four.preset``: AZResNet-64x5 bf16,
           recycling self-play B=4096 at 100 sims, the 2^21-row ring, 512
           train steps of batch 1024, the 256-game gate arena at 50 sims
           on the combined forward, the anchored pass with warmup x4, the
           ladder (400, 1600) and its one-time calibration), iteration 1
           with a checkpoint in a temporary directory and the launch
           counters set to 0 just before and read just after; a second
           Coach over the directory resumes bit-equal to the first one's
           live state (weights, BatchNorm statistics, Adam moments, ring,
           actor carry, generator, counters, Elo history, match graph) and
           runs iteration 2. The default run cuts the preset by
           ``cut_coach_cfg`` (train steps to GAMES_CUT_STEPS, self-play
           sims to GAMES_CUT_SIMS, the arenas' sims to GAMES_CUT_GATE_SIMS,
           the warmup pass to one repeat) and runs
           iteration 2 without its anchored pass, each cut printed beside
           the preset's own value; ``--coach`` runs this phase uncut: each
           phase's seconds, anchored Elo +- SE,
           launches per kernel, peak memory, checkpoint bytes, save and
           restore ms; (b) the root counts of one gate-arena move at mixed
           seating (B=256, the gate's sims, two AZResNets on the combined
           forward)
           through the kernels and the plain versions, identical, and one
           rung move's uniform side (B=256, 1600 sims, nodes 1601) through
           ``az_fused``, its first COACH_SUBSET roots held against the plain fused
           search; (c) the ``mlp`` preset for 2 iterations (the anchored
           pass at 2: fused calls on both sides); (a') the host example
           archive: each ``full`` iteration's ``{iteration}.examples`` (the
           first coach's ``0.examples``, the resumed one's ``1.examples``)
           loads through the port's ``native.ExampleStore`` bit-equal to the
           valid rows of the trajectories that coach's self-play returned,
           with its rows, bytes and the append, save and load ms; (d) one
           gate arena (the resumed incumbent against a second AZResNet-64x5
           on the combined forward, 256 games at the gate's sims: 50 uncut,
           TRACE_CUT_SIMS in the default run) and one rung of the anchored
           pass (the net at those sims against the uniform rung at 400)
           under ``utils.timing.profiler_trace``, each chrome trace read
           back (``trace_shares``): wall ms, the device's busy and idle
           share, its top operations, and the launches. Its launches of
           ``descend``, ``merge``, ``refresh``, ``fused`` and ``fused_mlp``
           (one iteration of each preset) are the kernels line's;
18. games: the coach on the other games and on ``AZConvNet``
           (``games_phase``): one ``Coach.learn`` iteration each of the
           Othello ``full`` preset (AZResNet-128x5 bf16, B=1024, 100 sims,
           max_depth 80, the 128-game gate at 50 sims in continuous mode,
           the warmup anchored pass x2), Gomoku 9 ``full`` and Hex ``full``
           (AZResNet-64x5, B=1024) and the Connect-Four ``convnet`` preset
           (AZConvNet-512, B=1024 at 50 sims), as their CLIs build them,
           with a checkpoint each and the launch counters set to 0 just
           before and read just after: each phase's seconds, launches,
           peak memory and the checkpoint's bytes. The default run cuts
           each preset as phase 17 does (``cut_coach_cfg``) and prints the
           cuts beside the preset's own values; ``--games`` runs this phase
           alone with nothing cut. A second Othello coach resumes bit-equal to
           the live one; one Othello gate move (B=128, 50 sims, two
           AZResNet-128x5 on the combined forward) gives identical counts
           through the kernels and the plain versions; AZConvNet-512's
           folded forward is held against its unfolded one at B=1024 (f32
           within CONVNET_F32_ATOL, bf16 within CONVNET_BF16_ATOL). Its
           launches of the Othello, Gomoku and Hex descends, ``merge_dense``
           and ``refresh_dense`` (summed over its iterations) are the
           kernels line's;
19. dense: the dense engine (``mcts/search.py``, plain PyTorch: it adds
           no kernel and its searches launch none, counted with the
           counters at 0) against the hybrid engine (``dense_phase``): (a)
           Connect-Four on phase 3's roots and Dirichlet draws (B=4096, 100
           sims, max_depth 48): the uniform prior and order-free MLPNet
           (256, 256) weights give identical counts, the AZResNet-64x5 bf16
           within phase 7(d)'s bound; ms a search of each engine (twice),
           peak memory, and one profiled dense search of 25 sims (device
           idle share, host launch calls and host synchronisations); (b)
           Othello at phase 8c's max_depth 4 (B=1024, Dirichlet 0.3), the
           uniform prior: identical counts, the cutoffs backing up the
           disc differential; (c) ``experiments/train_compare.py``'s
           ``forced`` arm at its ``tpu`` preset: the fixed scan with forced
           playouts (MLPNet (256, 256) order-free, B=2048, 25 sims,
           max_depth 48, temp_threshold 15, Dirichlet 1.0, k=2): one call's
           ms, moves/s and valid samples, the pruned targets summing to 1
           on every valid row, and its first 64 games replayed on the CPU
           with the same draws: moves, features, values and stats
           identical, the targets within 1e-6; (d) the CLIs as a user runs
           them, each exiting 0: ``analyze`` (ANALYZE_SIMS, a seeded
           AZResNet-64x5 checkpoint written by ``save_checkpoint``) on "3 3
           4", ``play_othello --sims 200`` with stdin closed, and, through
           ``analyze.main`` in this process (200 sims), a position with an
           immediate win, which its best move must take;
20. economy: the training economy (``economy_phase``; Gumbel search is
           plain PyTorch on the dense engine's parts and launches no
           kernel, counted with the counters at 0): (a) Gumbel search at
           the ``economy`` preset's width (AZResNet-64x5 bf16, seeded random
           weights through the converter, B=4096, 32 sims, max_depth 48, a
           sampled root Gumbel): root visits sum to 32 on live games, pi'
           rows to 1, the action legal and most visited; ms a search
           (twice), and one profiled 8-sim search (launch calls and syncs a
           simulation, device idle share); then order-free MLPNet (256, 256)
           weights at B=4096, the first 64 games searched again on the CPU:
           counts and actions identical; (b) one ``economy`` fixed-scan
           self-play call (B=4096, 42 steps): seconds, moves/s, valid
           samples, pi' rows summing to 1 and values +-1/0 on valid rows;
           (c) playout-cap randomization on the ``mlp`` preset (MLPNet (256,
           256) order-free, B=512, 50 sims, full_search_prob 0.25, cheap_sims
           8): exactly 2 ``az_fused_mlp`` launches a step and no other
           kernel, exactly 128 policy rows a step (the step permutation's
           first 128; all 128 among live games while every game is live),
           and step 10's two sub-batch searches (B=128 at 51 nodes, B=384 at
           9) bit-equal to the plain version; (d) a reanalyze pass of 1024
           positions recorded with ``record_states`` from a ResNet fixed scan
           (B=128, 16 sims), re-searched at 100 sims on the hybrid route:
           100 ``az_descend``, 100 ``az_merge``, 1 ``az_refresh``, and the
           same pass through the plain versions gives identical counts (the
           seed takes only fresh planes); (e) one cut ``economy`` coach
           iteration with reanalyze (self-play B=512 at 16 Gumbel sims, 16
           train steps, a 64-game Gumbel gate at 25 sims, the anchored pass
           off; each cut printed beside the preset's value): seconds by phase,
           no kernel launched, the rings' bytes reckoned beside the
           checkpoint's, and a new Coach resuming from it bit-equal on both
           rings; (f) ``analyze --engine gumbel`` in this process (200 sims)
           on a position with an immediate win, which it must recommend.
           Its ``fused_mlp`` launches and the pass's hybrid launches add to
           the kernels line's;
21. tt:    the transposition-DAG engine (``tt_phase``; plain PyTorch, it
           launches no kernel, counted with the counters at 0 around each
           search): (a) ``tests/tpu_goldens.json``'s ``tt_c4_uniform_*``
           heads (Connect-Four, uniform model, B=64 positions of
           tests/test_fused.py's generator, 25 sims, max_depth 48); (b) a
           deep search at ``bench_tt``'s defaults (uniform, B=512, 400 sims,
           max_depth 48): the first 64 games' root counts and links equal
           to the CPU's, every live row's counts summing to 400, links made;
           ms a search and a simulation, peak memory, one profiled search
           cut to 25 sims (launch calls and syncs a simulation, device idle
           share), and the dense engine's search of the same roots for the
           cost ratio; (c) Othello (uniform, B=256, 200 sims, max_depth 64),
           the first 16 games equal to the CPU's; (d) MLPNet (256, 256) with
           order-free weights on Connect-Four (B=512, 100 sims), every game
           equal to the CPU's; (e) the routes: the transposition fixed scan
           (uniform, B=512, 25 sims, Dirichlet 1.0: s a call, moves/s), a
           64-game transposition arena at 25 sims (order-free MLPNet against
           the uniform model, results summing to 64) and ``analyze --engine
           tt --sims 400`` from the initial position in this process (links
           made);
22. parallel: the data-parallel path over ``torch.distributed``
           (``parallel_phase``; it adds no kernel: each rank's kernels run
           on its games): (a) a world of one under NCCL in this process:
           the collectives on CUDA tensors, and the global-statistics
           BatchNorm forward and backward (AZResNet-64x5 in f32, B=1024)
           against the mesh-less values: the forward and the running
           statistics bit for bit, the gradients within 1e-5 of each
           tensor's largest entry; one
           ``Coach(mesh=make_mesh())`` iteration against the mesh-less
           coach of the same config, MLPNet (256, 256) with order-free
           weights and AZResNet-64x5 (the multi-process CLI's config at
           B=1024, 100 sims; the ResNet's cut to 25 sims, 16 train steps
           and a gate at 25 sims), the integers equal and the losses within
           1e-5; (b) two ranks sharing the card over gloo, spawned by
           ``launch_local_multihost`` (``--parallel-rank`` is the rank's
           entry) as the phase starts, their start-up overlapping (a) and
           their checks waiting for its end: the MLPNet iteration of (a)
           equal to the one-process one in the integers (the losses
           printed: each rank rounds its bf16 weight gradients before the
           ranks' sum); the learner witness
           (``par_learner``): the iteration's 64 train steps on its ring,
           hidden layers in f32 and in bf16, two ranks against one
           process, the f32 losses within 1e-5 (the bf16 ones printed);
           one sharded AZResNet-64x5 search of phase 3's roots (B=4096,
           100 sims, Dirichlet 1.0), each rank's launches counted, held to
           the bounded-divergence gate (>= 75% of games identical, max
           |dpi| <= 0.25) against the unsharded search; then the CLI at
           full width (``--net resnet --channels 64 --blocks 5 --batch
           1024``; self-play cut to 25 sims of the JAX CLI's 100,
           16 train steps and the gate at 25 sims) for
           1 iteration with a checkpoint directory,
           and a new pair that resumes and prints iteration 2; (c) with a
           second card, the pair of (b) over NCCL,
           one card each; with one, a line saying that (c) did not run;
           (d) ``bench_scaling`` at its defaults, its lines printed. Each
           rank's launches of ``az_fused_mlp``, ``az_descend``,
           ``az_merge`` and ``az_refresh`` in (b) add to the kernels line;
23. gomoku23: Gomoku boards above 512 cells, which the 12-word
           ``descend_gomoku``/``descend_round_gomoku`` instances and the J =
           24 dense merges and seeds take (``gomoku23_phase``): their ptxas
           lines; on Gomoku 23 (A=529) with the ``full`` preset's model
           (AZResNet-64x5 bf16, seeded random weights; B=1024, 100 sims,
           max_depth 48, Dirichlet 0.15, roots of up to WIDE_MOVES random
           moves): (a) the descend, the dense merge and the dense seed
           bit-equal to plain on a plain search's planes (the seed on its
           fresh planes), timed in turns with their device ms and bounds;
           (b) their round variants at K=4, the same; (c) one K=1 and one
           K=4 search through the kernels and the plain versions, equal root
           counts and exactly 100/100/1 and 25/25/1 launches; (d) (a)-(c) at
           A=729 (edge 27) at B=WIDEST_B; (e) ``train_gomoku --size 23
           --preset smoke`` in this process (1 iteration of the preset's 2)
           exiting 0 with the wider kernels launched and ``0.examples``
           written. Its entries ``*_w12``/``*_j24`` in the kernels line
           are (a)-(c)'s at A=529, with (c)'s launches.
24. wider: Gomoku boards above 768 cells and round searches above K = 16
           (``wider_phase``): the ptxas lines of the leaf-row Gomoku
           descends, the round descend's 32-bit-counter instances, the
           streamed dense merges and seeds (J = 0) and the wide A <= 8 round
           merge, gated (no stack, no spill); (a) phase 23(a)-(c) on Gomoku
           32 (A=1024: the board in the leaf row; the streamed merges and
           seeds) with the ``full`` preset's model at B=1024; (b) 23(a)-(b)
           at A=2025 (edge 45) at B=WIDER_B, the kernels against their plain
           versions; (c)
           ``train_gomoku --size 32 --preset smoke`` (1 iteration of 2); (d)
           the Othello ``full`` preset (AZResNet-128x5, B=1024, 100 sims) at
           K = 20, 50 and 100 (past the 16 records a round merge stages, and
           past 32): the streamed round merge bit-equal to plain on the last
           round of a plain search, timed, and one search through the kernels
           and the plain versions, equal root counts; (e) the Connect-Four
           ``full`` preset's AZResNet-64x5 (B=1024) at K=256, 512 sims (the
           round descend's 32-bit counters in the wrapper's global scratch,
           the A <= 8 merge's records read in place) and (f) at K=4, 100
           sims and C = 29 057 nodes (the same counters), the same. Each part's seconds print. Its entries
           ``*_row``/``*_stream`` in the kernels line are (a)'s at
           A=1024 with its searches' launches, ``merge_round_dense_stream_k100``
           (d)'s at K=100, ``descend_round_wide``/``merge_round_wide`` (e)'s
           and ``descend_round_wide_global`` (f)'s, with their searches'
           launches.

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

``python3 chip_smoke.py --learner`` builds the kernels and runs phase 16
alone; ``python3 chip_smoke.py --coach`` runs phase 17 alone, uncut;
``python3 chip_smoke.py --games`` runs phase 18 alone, uncut;
``python3 chip_smoke.py --dense`` runs phase 19 alone;
``python3 chip_smoke.py --economy`` runs phase 20 alone;
``python3 chip_smoke.py --tt`` runs phase 21 alone;
``python3 chip_smoke.py --parallel`` builds the kernels and runs phase 22
alone; ``python3 chip_smoke.py --parallel-cards``, for a machine of
several cards, runs the one-process MLPNet iteration of 22(a) and then
22(c) and (d) alone; ``python3 chip_smoke.py --gomoku23`` builds the
kernels and runs phase 23 alone; ``python3 chip_smoke.py --wide`` builds
the kernels, prints phase 2's report and runs phase 24 alone;
``python3 chip_smoke.py --fused-wide`` does the same for phase 14. Each
phase's seconds print as it ends (``[time]``).

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

import gc
import json
import math
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
# the uniform fused kernels' ptxas names (their Connect-Four instances)
FUSED_KERNELS = ("fused_kernelINS_6C4GameELi8E", "fused_rounds_kernelINS_6C4GameELi8E")
# the A <= 8 merges' ptxas names (the round merge's instance of K <= 16;
# phase 24 prints the wide one's)
MERGE_KERNELS = ("merge_kernel", "merge_round_kernelILb0E")
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
WIDE_MLP_HIDDEN = (512, 512)   # phase 14: train_multihost --net mlp --hidden 512, the streamed plan
SMALL_MLP_HIDDEN = MLP_HIDDEN  # phase 14: the Gomoku boards' MLPNet, the mlp preset's widths
SCRATCH_MLP_HIDDEN = (2048,)   # phase 14(c): activations past shared memory, in the device scratch
TINY_K, TINY_MLP_HIDDEN = 20, (32,)   # phase 14(d): Gomoku(2, 2) rounds, leaves in the device scratch
# phase 14: Gomoku(size, size) boards of at most 16 cells, K, and the kernels
# line's entries of their uniform and MLP searches
SMALL_CELLS = ((4, 1, "fused_gomoku", "fused_mlp_stream_gomoku"),
               (3, 1, "fused_gomoku_3x3", "fused_mlp_stream_gomoku_3x3"),
               (3, ROUND_K, "fused_rounds_gomoku", "fused_mlp_stream_rounds"))
# the kernels line's entries of the fused kernels' new instances (phase 14),
# each its wrapper's kernel
FUSED_WIDE_ENTRIES = {"fused_mlp_stream": "fused_mlp_stream", "fused_gomoku": "fused_gomoku",
                      "fused_mlp_stream_gomoku": "fused_mlp_stream",
                      "fused_gomoku_3x3": "fused_gomoku",
                      "fused_mlp_stream_gomoku_3x3": "fused_mlp_stream",
                      "fused_rounds_gomoku": "fused_rounds_gomoku",
                      "fused_mlp_stream_rounds": "fused_mlp_stream_rounds",
                      "fused_rounds_gomoku_2x2": "fused_rounds_gomoku",
                      "fused_mlp_stream_rounds_2x2": "fused_mlp_stream_rounds"}
# the fused kernels' ptxas names, by a piece of their mangled names: the
# Connect-Four instances of the resident/staged plan (no spill; the rounds
# kernel keeps its leaves in a stack frame), the small-Gomoku uniform
# instances of each group width (no stack, no spill) and the streamed MLP
# instances of both games (no spill)
FUSED_C4_KERNELS = tuple(f"{k}INS_6C4GameENS_12ResidentPlan"
                         for k in ("fused_mlp_kernel", "fused_mlp_rounds_kernel", "mlp_eval_kernel"))
SMALL_UNIFORM_KERNELS = tuple(f"{k}INS_11SmallGomokuELi{g}E"
                              for k in ("fused_kernel", "fused_rounds_kernel") for g in (8, 16, 32))
STREAM_KERNELS = tuple(f"{k}INS_{g}ENS_10StreamPlan"
                       for k in ("fused_mlp_kernel", "fused_mlp_rounds_kernel", "mlp_eval_kernel")
                       for g in ("6C4Game", "11SmallGomoku"))
TOWER_RAGGED_B = 4093     # phase 13(a): a tail tile of 5 games (the kernel's tiles hold 8)
TOWER_REPS = 3            # --tower: device-time readings at each B
TOWER_KERNELS = ("int8_tower_kernel",)   # the tower's ptxas name
LEARNER_RING = 1 << 21    # phase 16: the full preset's ReplayConfig capacity ...
LEARNER_BATCH = 1024      # ... its TrainConfig batch (Adam 1e-3, l2 1e-4) ...
LEARNER_TRAIN_STEPS = 16  # ... and 16 of its 512 steps a phase
COACH_SUBSET = 2          # phase 17(b): roots of the 1600-sim rung search held against plain
                          # (its plain search takes ~1.5 s a root)
MLP_RING, MLP_BATCH, MLP_TRAIN_STEPS = 1 << 17, 512, 8   # the mlp preset's ring and batch
GAMES_CUT_STEPS = 64      # phases 17-18, the default run: train steps an iteration of each preset
GAMES_CUT_SIMS = 16       # ... self-play sims ...
GAMES_CUT_GATE_SIMS = 16  # ... and the arenas' sims (the gate and the anchored pass's net side)
CONVNET_F32_ATOL = 1e-3   # phase 18: AZConvNet folded vs unfolded on the card, f32 ...
CONVNET_BF16_ATOL = 0.1   # ... and bf16 (tests/test_torch_convnet.py's bf16 bound)

FORCED_B, FORCED_SIMS, FORCED_K = 2048, 25, 2.0   # phase 19(c): train_compare.py's forced arm
FORCED_CPU_B = 64         # ... its games replayed on the CPU
ANALYZE_SIMS = 200        # phase 19(d): the analyze CLI's sims on "3 3 4" (cut from 800)
DENSE_PROFILED_SIMS = 25  # phase 19(a): the profiled dense search's simulations (the profiler's
                          # host time grows with the launches: ~38 s for a 100-sim search)
ECO_B, ECO_SIMS = 4096, 32   # phase 20(a-b): the economy preset's self-play batch and Gumbel sims
ECO_SCAN_MOVES = None     # (b): the fixed scan's steps (None: game.max_moves, the preset's)
ECO_PROFILED_SIMS = 8     # (a): the profiled Gumbel search's simulations
ECO_CPU_B = 64            # (a): games of the order-free MLP search replayed on the CPU
PCR_B, PCR_SIMS, PCR_P, PCR_CHEAP = 512, 50, 0.25, 8   # (c): PCR on the mlp preset's scan
PCR_CHECK_STEP = 10       # (c): the step whose two sub-batch searches are held against plain
RZ_SCAN_B, RZ_SCAN_SIMS = 128, 16   # (d): the ResNet fixed scan that records positions ...
RZ_CAP, RZ_R, RZ_SIMS = 1 << 13, 1024, 100   # ... into this ring; the pass re-searches R at SIMS
ECO_COACH_B, ECO_COACH_STEPS, ECO_COACH_GAMES, ECO_COACH_RZ = 512, 16, 64, 1024   # (e): the cut
ECO_COACH_GATE_SIMS = 25  # ... its gate's sims ...
ECO_COACH_SIMS = 16       # ... and its self-play's Gumbel sims (cut from the preset's 32)
TT_GOLDEN_B, TT_GOLDEN_SIMS = 64, 25   # phase 21(a): tests/test_tpu_gate.py's tt golden search
TT_B, TT_SIMS = 512, 400  # (b): bench_tt's defaults (--batch, --sims)
TT_CPU_B = 64             # (b): games of the deep search replayed on the CPU
TT_PROFILED_SIMS = 25     # (b): the profiled search's simulations
TT_OTH_B, TT_OTH_SIMS, TT_OTH_DEPTH, TT_OTH_CPU_B = 256, 200, 64, 16   # (c)
TT_MLP_B, TT_MLP_SIMS = 512, 100   # (d)
TT_MLP_CPU_B = 128        # (d): its games replayed on the CPU
# phase 22: the multi-process CLI's flags at full width (its defaults
# otherwise: 64 train steps of 256, a 64-game gate at 100 sims)
PAR_RESNET = ("--net", "resnet", "--channels", "64", "--blocks", "5", "--batch", "1024",
              "--sims", "100")
PAR_MLP = ("--net", "mlp", "--hidden", "256", "--batch", "1024", "--sims", "100")
# (a)'s ResNet iterations, cut: 25 sims, 16 train steps, the gate at 25 sims
PAR_RESNET_CUT = (*PAR_RESNET, "--sims", "25", "--train-steps", "16", "--arena-sims", "25")
# (b)'s CLI pair: self-play at full width and 100 sims, 16 train steps, the gate at 25 sims
PAR_CLI = (*PAR_RESNET, "--sims", "25", "--train-steps", "16", "--arena-sims", "25")
PAR_BN_B = 1024           # (a): rows of the global-statistics BatchNorm check
PAR_LOSS_ATOL = 1e-5      # a record's loss_first and loss_last (the JAX tests' bound)
PAR_GRAD_RTOL = 1e-5      # (a): the BatchNorm gradients, of each tensor's largest entry
PAR_TIMEOUT = 240         # seconds a spawned gang may take
PAR_INTS = ("iteration", "model_id", "accepted", "arena_wins", "arena_losses", "arena_draws",
            "replay_size", "replay_total", "selfplay_moves", "selfplay_truncated")
TT_SCAN_B, TT_SCAN_SIMS = 512, 25  # (e): the transposition fixed scan
TT_ARENA_GAMES, TT_ARENA_SIMS = 64, 25   # (e): the transposition arena
TRACE_TOP = 8             # phase 17(d): device operations printed of each traced run
TRACE_CUT_SIMS = 8        # phase 17(d), the default run: the traced arenas' sims (a chrome trace
                          # grows with the simulations: ~16 MiB a simulation at 256 games)
WIDE_SIZE, WIDEST_SIZE = 23, 27   # phase 23: Gomoku edges past the 8-word boards (529, 729 cells)
WIDE_MOVES = 66           # phase 23: random moves into the roots (up to)
WIDEST_B = 128            # phase 23(d): games of the A=729 checks
WIDE_CLI_ITERATIONS = 1   # phase 23(e): the smoke CLI's iterations (the preset's own: 2)
# phase 23: the 12-word descends' and the J = 24 seeds' ptxas names (not
# gated: a spill is printed, not hidden; the J = 24 merges print with the
# other dense merges' instances)
WIDE_KERNELS = ("descend_kernelINS_10GomokuGameILi12E", "descend_round_kernelINS_10GomokuGameILi12E",
                "seed_dense_kernelILi24ELb0EE", "seed_dense_kernelILi24ELb1EE")
# the kernels line's entries of the instances that only boards above 512
# cells reach: each its wrapper's kernel at the wider instance
WIDE_ENTRIES = {
    "descend_gomoku_w12": "descend_gomoku", "merge_dense_j24": "merge_dense",
    "refresh_dense_j24": "refresh_dense", "descend_round_gomoku_w12": "descend_round_gomoku",
    "merge_round_dense_j24": "merge_round_dense", "refresh2_dense_j24": "refresh2_dense",
}
WIDER_SIZE, WIDER_CHECK_SIZE = 32, 45   # phase 24: Gomoku past 768 cells (1024; 2025)
WIDER_B = 128             # phase 24(b): games of the A=2025 checks
WIDE_KS = (20, 50, 100)   # phase 24(d): the Othello full preset's K past 16 records and 32 bits
COUNTS_K = 256            # phase 24(e): the round descend's first K past byte counters ...
COUNTS_C = 29057          # ... (f) and its first C past their shared memory
COUNTS_B = 1024           # (e)-(f): Connect-Four games
# phase 24: the ptxas names of the instances the configurations past the
# older ones take (gated: none may spill): the leaf-row Gomoku descends,
# the round descend's 32-bit-counter instance of every game, the streamed
# dense merges and seeds (J = 0) and the A <= 8 round merge of K > 16
WIDER_KERNELS = (
    *(f"{d}_kernelINS_13GomokuRowGame" for d in ("descend", "descend_round")),
    *(f"descend_round_wide_kernelINS_{g}" for g in (
        "15ConnectFourGame", "11OthelloGame", "10GomokuGameILi8E", "10GomokuGameILi12E",
        "13GomokuRowGame", "7HexGame")),
    "merge_dense_kernelILi0E", "merge_round_dense_kernelILi0E", "seed_dense_kernelILi0ELb0EE",
    "seed_dense_kernelILi0ELb1EE", "merge_round_kernelILb1E",
)
# the kernels line's entries of those instances, each its wrapper's kernel:
# Gomoku 32 at full width (K=1 and K=4), the Othello full preset at K=100,
# Connect-Four's full preset at K=256 and at C=29057
WIDER_ENTRIES = {
    "descend_gomoku_row": "descend_gomoku", "merge_dense_stream": "merge_dense",
    "refresh_dense_stream": "refresh_dense", "descend_round_gomoku_row": "descend_round_gomoku",
    "merge_round_dense_stream": "merge_round_dense", "refresh2_dense_stream": "refresh2_dense",
}
COUNTS_ENTRIES = {
    "merge_round_dense_stream_k100": "merge_round_dense", "descend_round_wide": "descend_round",
    "merge_round_wide": "merge_round", "descend_round_wide_global": "descend_round",
}

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
    # phase 23: descend_kernel / descend_round_kernel<GomokuGame<12>> and the
    # J = 24 instances of the dense merges and seeds; phase 24: the leaf-row
    # Gomoku descends, the streamed dense merges and seeds, the wide round
    # merge and descend
    **{name: "alphazero_tpu_torch/csrc/hybrid.cu"
       for name in (*WIDE_ENTRIES, *WIDER_ENTRIES, *COUNTS_ENTRIES)},
    # phase 14: the Gomoku game policy's and the streamed evaluator's
    # instances (the evaluator in csrc/mlp.cuh)
    **{name: "alphazero_tpu_torch/csrc/fused.cu" for name in FUSED_WIDE_ENTRIES},
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
REPLACES.update({name: REPLACES[base]
                 for name, base in (*WIDE_ENTRIES.items(), *WIDER_ENTRIES.items(),
                                    *COUNTS_ENTRIES.items())})
# the fused kernel with GomokuFlatOps.step/terminal traced in (gomoku.py:191, :213), and with
# the in-kernel MLP
_GOMOKU = " + alphazero_tpu/games/gomoku.py:191"
REPLACES.update({
    "fused_mlp_stream": REPLACES["fused_mlp"],
    "fused_gomoku": REPLACES["fused"] + _GOMOKU,
    "fused_gomoku_3x3": REPLACES["fused"] + _GOMOKU,
    "fused_mlp_stream_gomoku": REPLACES["fused_mlp"] + _GOMOKU,
    "fused_mlp_stream_gomoku_3x3": REPLACES["fused_mlp"] + _GOMOKU,
    "fused_rounds_gomoku": REPLACES["fused_rounds"] + _GOMOKU,
    "fused_mlp_stream_rounds": REPLACES["fused_mlp_rounds"] + _GOMOKU,
    "fused_rounds_gomoku_2x2": REPLACES["fused_rounds"] + _GOMOKU,
    "fused_mlp_stream_rounds_2x2": REPLACES["fused_mlp_rounds"] + _GOMOKU,
})
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
    busy ms, [(kernel, device ms, launches), ...] by time, host launch
    calls, host synchronisations)``, the busy time being the sum of the device kernels' own times
    (one stream: they do not overlap). The host launch calls (the CUDA API
    calls that launch a kernel, a memset or a copy) are the count of the
    work sent to the card: the device events can cover
    fewer of them (a card's trace may drop records), and then the busy
    time is a lower bound. A synchronisation is a device value read on
    the host (``aten::_local_scalar_dense``: ``bool()``, ``item()``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, calls, syncs = [], 0, 0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:   # the host ops that launched them
            if evt.key.startswith(("cudaLaunch", "cuLaunch", "cudaMemset", "cudaMemcpy")):
                calls += evt.count
            if evt.key == "aten::_local_scalar_dense":   # a device value read on the host
                syncs += evt.count
            continue
        # a named range's span on the device timeline (the optimizer's
        # step) is not a kernel
        if getattr(evt, "is_user_annotation", False) or "#" in evt.key:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        kernels.append((evt.key, dev_us / 1e3, evt.count))
    kernels.sort(key=lambda k: -k[1])
    return 1e3 * wall, sum(k[1] for k in kernels), kernels, calls, syncs


def device_ms(fn, reps: int = 20, sleep_cycles: int = 50_000_000, tries: int = 4) -> float:
    """Mean device time per call of the kernels ``fn`` launches, without
    the host work between launches: the calls queue up behind a kernel that
    sleeps ``sleep_cycles`` clock cycles (~25 ms), so the events around
    them time the device alone. The reading holds only if the host queued
    the calls within half the sleep; when it did not (the host was
    descheduled: a one-card machine shares its host's cores), the reading
    is dropped and taken again behind a sleep four times as long as that
    queueing took. Fails if none of ``tries`` readings holds. The garbage
    collector is off while the calls queue. (No profiler: its sessions
    slow the host-paced steps that follow.)"""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(tries):
        collecting = gc.isenabled()
        gc.disable()
        try:
            t0 = time.perf_counter()
            torch.cuda._sleep(sleep_cycles)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            queued_ms = 1e3 * (time.perf_counter() - t0)
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize()
        sleep_ms = sleep_cycles / 2.0e6   # at most this long at <= 2 GHz
        if queued_ms < 0.5 * sleep_ms:
            return start.elapsed_time(end) / reps
        print(f"[timing] queuing {reps} calls took {queued_ms:.3f} ms, over half the "
              f"{sleep_ms:.1f} ms sleep: reading dropped, taken again", flush=True)
        sleep_cycles = int(min(4 * queued_ms * 2.0e6, 4.0e9))
    fail(f"queuing {reps} calls took {queued_ms:.3f} ms in each of {tries} tries: "
         "the device time is not measurable")


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


def time_in_turns(results: dict, fns: dict, tag: str, card: str, label: str = "",
                  **reps) -> None:
    """Each kernel and its plain version timed in turns (``reps``:
    ``in_turns``' counts); the means go into the kernel's result entry."""
    for name, (k_fn, p_fn) in fns.items():
        k1, k2, p1, p2 = in_turns(k_fn, p_fn, **reps)
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
    wall, busy, top, calls, _ = profile_step(step)
    print(f"[{tag}] one profiled {label} step: {wall:.3f} ms wall (profiler on), device "
          f"busy {busy:.3f} ms ({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%, "
          f"{sum(k[2] for k in top)} device kernel events of {calls} host launch calls | {card}",
          flush=True)
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


def plain_planes(ops, bds, prior, cfg, evaluate) -> tuple:
    """The fused kernels' plain version through its body (``hybrid.run_search``
    or, at K > 1, ``hybrid.run_rounds`` on the plain kernels) with
    ``evaluate`` at its leaves: the ``(N, W, done)`` planes of the whole
    tree, for the bound's count of the work the data needs."""
    from alphazero_tpu_torch.mcts import SearchKernels, hybrid

    planes = {}

    def keeping_done(merge):
        def run(*args):
            planes["done"] = args[4]   # the done plane, which the merges update in place
            return merge(*args)
        return run

    if cfg.parallel_sims == 1:
        n, w = hybrid.run_search(ops, bds, prior, cfg, evaluate, SearchKernels(
            hybrid.descend, keeping_done(hybrid.merge), hybrid.refresh))
    else:
        n, w = hybrid.run_rounds(ops, bds, prior, cfg, evaluate, SearchKernels(
            hybrid.descend, hybrid.merge, hybrid.refresh, hybrid.descend_round,
            keeping_done(hybrid.merge_round), hybrid.refresh2))
    return n, w, planes["done"]


def fused_route_checks(tag: str, name: str, game, apply_fn, free_apply, roots: torch.Tensor, cfg,
                       card: str) -> tuple:
    """One configuration of phase 14 on the fused route: ``apply_fn`` the
    uniform model or an MLPNet with random weights (``free_apply``: the
    same widths with order-free weights, or None). Checks the kernel
    against its plain version (bit-equal counts and root W: uniform, and
    order-free weights; random weights within ``search_agreement``'s
    gate), the ladder's fused route against the hybrid route it replaces
    (uniform: identical counts; MLP: the gate) with only ``name``'s wrapper
    launching, once, in the fused route's search; times the kernel in turns
    with its plain version, both routes' whole searches, and for an MLP
    the leaves' library forwards (one per simulation, as the K3 rows).
    Returns the kernels line's entry and the route's launches."""
    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.games.connect_four import FlatOps
    from alphazero_tpu_torch.mcts import fused, make_hybrid_root_fn
    from alphazero_tpu_torch.mcts.tree import INVALID_P
    from alphazero_tpu_torch.ops import root_prior
    from alphazero_tpu_torch.selfplay import _make_root_counts_fn

    c4 = game.name == "connect_four"
    ops = FlatOps() if c4 else game.flat_ops()
    gops = None if c4 else ops
    A, L, K, sims = game.num_actions, ops.size, cfg.parallel_sims, cfg.num_sims
    batch = roots.shape[0]
    uval = getattr(apply_fn, "uniform_value", None)
    mlp = uval is None
    label = (f"{game.name} {'MLPNet ' + str(apply_fn.kernel_eval_factory(ops).hidden) if mlp else 'uniform'}"
             f", K={K}, B={batch}, {sims} sims, max_depth {cfg.max_depth}")
    rounds = (K,) if K > 1 else ()
    bds = ops.from_state(roots).contiguous()

    def searches(fn):
        prior, valid = root_prior(game, fn, cfg, roots, None)
        prior = torch.where(valid, prior, INVALID_P)
        if not mlp:
            wrap = kernels.fused_rounds if K > 1 else kernels.fused
            k_fn = lambda: wrap(bds, prior, sims, cfg.nodes, cfg.max_depth, float(cfg.cpuct),  # noqa: E731
                                float(uval), *rounds, ops=gops)
            evaluate = fused.uniform_evaluator(K * batch, float(uval), roots.device)
            return k_fn, prior, evaluate
        weights = fn.kernel_eval_factory(ops)
        wrap = kernels.fused_mlp_rounds if K > 1 else kernels.fused_mlp
        k_fn = lambda: wrap(bds, prior, weights, sims, cfg.nodes, cfg.max_depth,  # noqa: E731
                            float(cfg.cpuct), *rounds, ops=gops)
        return k_fn, prior, lambda bd, vm: fused.mlp_eval(bd, vm, weights)

    # (1) bit-equal to the plain version: the uniform model, order-free weights
    k_fn, prior, evaluate = searches(free_apply if mlp else apply_fn)
    ck, wk = k_fn()
    (n_all, w_p, done), p1 = timed_once(lambda: plain_planes(ops, bds, prior, cfg, evaluate))
    conserved(f"{tag} {label}", game, roots, ck, sims)
    if not (bit_equal(ck, n_all[:, :, 0]) and bit_equal(wk, w_p[:, :, 0])):
        diff = int(((ck != n_all[:, :, 0]) | (wk != w_p[:, :, 0])).any(dim=1).sum())
        fail(f"{tag} {label}{', order-free weights' if mlp else ''}: the kernel differs from its "
             f"plain version on {diff} of {batch} games (counts or root W)")
    err = max(float((ck - n_all[:, :, 0]).abs().max()), float((wk - w_p[:, :, 0]).abs().max()))
    # (2) random weights: the kernel against its plain version within the
    # gate; this plain run is the first of the timed pair
    if mlp:
        k_fn, prior, evaluate = searches(apply_fn)
        ck, wk = k_fn()
        (n_all, _, done), p1 = timed_once(lambda: plain_planes(ops, bds, prior, cfg, evaluate))
        same, dpi = search_agreement(f"{tag} {label} (random weights)", ck, n_all[:, :, 0])
    # (3) timed in turns (plain, kernel, kernel, plain), and the bound of
    # the work this run's data needs
    k1, k2 = time_ms(k_fn, FUSED_REPS), time_ms(k_fn, FUSED_REPS)
    dev_ms = device_ms(k_fn, reps=FUSED_REPS)
    _, p2 = timed_once(lambda: plain_planes(ops, bds, prior, cfg, evaluate))
    steps, installs = float(n_all.sum()), float((n_all > 0).sum())
    expansions = installs - float(done[:, 1:].sum())
    f32_ops = steps * (puct_ops(1, A) + 3) + expansions * 2 * A
    nbytes = F32 * batch * (L + 3 * A)
    bf16_ops, library_ms, lib_text = 0.0, None, ""
    if mlp:
        weights = apply_fn.kernel_eval_factory(ops)
        hidden = weights.hidden
        widths = (2 * L, *hidden)
        bf16_ops = expansions * 2 * sum(a * b for a, b in zip(widths, widths[1:]))
        f32_ops += expansions * (2 * sum(hidden) + 2 * widths[-1] * (A + 1) + (A + 1) + 5 * A + 1)
        wbytes = sum(t.numel() * t.element_size() for t in weights.sections())
        nbytes += wbytes
        feats = game.to_features(roots).contiguous()
        fwd = time_ms(lambda: apply_fn(feats), 20)
        library_ms = fwd * sims
        blocks = -(-batch // 32)
        lib_text = (f"; weights {wbytes} bytes counted once, re-read from L2 by {blocks} blocks x "
                    f"{sims} simulations ({blocks * sims * wbytes / 1e9:.2f} GB); library forward "
                    f"{fwd:.4f} ms a call, {library_ms:.4f} ms for {sims}")
    entry = {"max_abs_err": err, "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
             **bound(nbytes, f32_ops, bf16_ops), "library_ms": library_ms}
    # (4) the ladder's fused route (only this wrapper launches) against the
    # hybrid route it replaces, whole searches
    route = _make_root_counts_fn(game, apply_fn, cfg)
    if not route.__qualname__.startswith("make_fused_root_fn."):
        fail(f"{tag} {label}: the ladder did not pick the fused engine")
    route(roots)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    c_fused, f_ms = timed_once(lambda: route(roots))
    got = dict(kernels.launch_counts())
    if got != launches_of(kernels, **{name: 1}):
        fail(f"{tag} {label}: the fused route launched {launched(got)}, want one {name}")

    def library_only(feats):   # the model without its in-kernel evaluator: the hybrid route
        return apply_fn(feats)

    library_only.needs_features = True
    hybrid_route = make_hybrid_root_fn(game, library_only if mlp else apply_fn, cfg)
    hybrid_route(roots)
    c_hybrid, h_ms = timed_once(lambda: hybrid_route(roots))
    if mlp:
        same_r, dpi_r = search_agreement(f"{tag} {label}: fused and hybrid routes", c_fused, c_hybrid)
        route_text = f"{same_r:.4f} of games identical, max |dpi| {dpi_r:.4f}"
    else:
        if not torch.equal(c_fused, c_hybrid):
            fail(f"{tag} {label}: fused and hybrid routes differ on "
                 f"{int((c_fused != c_hybrid).any(dim=1).sum())} of {batch} games")
        route_text = "identical counts on every game"
    print(f"[{tag}] {label}: {name} bit-equal to its plain version "
          f"{'(order-free weights) ' if mlp else ''}on all {batch} games"
          + (f"; random weights {same:.4f} identical, max |dpi| {dpi:.4f}" if mlp else "")
          + f"; kernel {k1:.4f}/{k2:.4f} ms ({dev_ms:.4f} ms of device time), plain "
          f"{p1:.4f}/{p2:.4f} ms, bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}; "
          f"{steps / batch:.2f} descent steps, {expansions / batch:.2f} evaluations a game){lib_text}; "
          f"fused route {f_ms:.4f} ms a search ({launched(got)}), hybrid route {h_ms:.4f} ms: "
          f"{route_text} | {card}", flush=True)
    return entry, got


def fused_wide_phase(card: str) -> tuple:
    """Phase 14: the configurations the JAX fused kernel takes and the
    port's once declined, on the fused route (see the module docstring).
    Returns the kernels line's entries of the new instances and their
    launches."""
    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.config import MCTSConfig
    from alphazero_tpu_torch.games import ConnectFour, Gomoku
    from alphazero_tpu_torch.games.connect_four import FlatOps
    from alphazero_tpu_torch.models import (
        convert_mlp,
        make_apply_fn,
        make_uniform_model,
        order_free_mlp_variables,
        random_mlp_variables,
    )

    dev = torch.device("cuda", 0)
    lib = kernels.library()
    ptxas_lines(lib, FUSED_KERNELS)
    ptxas_lines(lib, FUSED_C4_KERNELS, gate="spills")
    ptxas_lines(lib, SMALL_UNIFORM_KERNELS)
    ptxas_lines(lib, STREAM_KERNELS, gate="spills")
    entries, launches = {}, {}

    def mlp_pair(game, hidden):
        cells = game.flat_ops().size if game.name != "connect_four" else 42
        return tuple(make_apply_fn(convert_mlp(make(game.num_actions, hidden, cells=cells,
                                                    seed=SEED)).to(dev))
                     for make in (random_mlp_variables, order_free_mlp_variables))

    # (a) MLPNet (512, 512) on Connect-Four: the evaluator alone, the mlp
    # preset's size through the ladder, then the engine bench's size
    c4 = ConnectFour()
    wide, wide_free = mlp_pair(c4, WIDE_MLP_HIDDEN)
    plan = kernels.mlp_plan(WIDE_MLP_HIDDEN)
    print(f"[fused_wide] MLPNet {WIDE_MLP_HIDDEN}: the {plan.kind} plan, {plan.smem_bytes} bytes "
          f"of dynamic shared memory a block, {plan.act_block_bytes} bytes of activation "
          f"scratch a block", flush=True)
    roots = random_positions(c4, B, 30, SEED, dev)
    bds = FlatOps().from_state(roots).contiguous()
    evaluator_vs_plain("fused_wide", bds, wide_free.kernel_eval_factory(FlatOps()), "order-free", card)
    evaluator_vs_plain("fused_wide", bds, wide.kernel_eval_factory(FlatOps()), "random", card)
    cfg_preset = MCTSConfig(num_sims=MLP_PRESET_SIMS, max_depth=MAX_DEPTH)
    fused_route_checks("fused_wide", "fused_mlp_stream", c4, wide, wide_free, roots[:MLP_PRESET_B],
                       cfg_preset, card)
    run_actor("fused_wide", c4, wide, cfg_preset, MLP_PRESET_B, 3, TEMP_THRESHOLD,
              {"fused_mlp_stream": 1}, card, f"Connect-Four MLPNet {WIDE_MLP_HIDDEN} through the "
              "ladder (fused route), the mlp preset's size")
    entries["fused_mlp_stream"], got = fused_route_checks(
        "fused_wide", "fused_mlp_stream", c4, wide, wide_free, roots,
        MCTSConfig(num_sims=SIMS, max_depth=MAX_DEPTH), card)
    launches["fused_mlp_stream"] = got["fused_mlp_stream"]

    # (b) Gomoku boards of at most 16 cells, uniform and MLP, K=4 at 3x3
    for size, K, uni_name, mlp_name in SMALL_CELLS:
        game = Gomoku(size, size)
        small = random_positions(game, B, size * size // 2, SEED, dev)
        cfg = MCTSConfig(num_sims=SIMS, max_depth=GMK_MAX_DEPTH, parallel_sims=K)
        uni = make_uniform_model(game).apply_fn
        wrappers = ("fused_rounds_gomoku", "fused_mlp_stream_rounds") if K > 1 else (
            "fused_gomoku", "fused_mlp_stream")
        entries[uni_name], got = fused_route_checks("fused_wide", wrappers[0], game, uni, None,
                                                    small, cfg, card)
        launches[uni_name] = got[wrappers[0]]
        rnd, free = mlp_pair(game, SMALL_MLP_HIDDEN)
        entries[mlp_name], got = fused_route_checks("fused_wide", wrappers[1], game, rnd, free,
                                                    small, cfg, card)
        launches[mlp_name] = got[wrappers[1]]

    # (c) the activations past shared memory: MLPNet (2048,) on
    # Connect-Four, the evaluator alone, order-free weights, one launch
    free_scratch = mlp_pair(c4, SCRATCH_MLP_HIDDEN)[1]
    plan = kernels.mlp_plan(SCRATCH_MLP_HIDDEN)
    if plan.act_block_bytes == 0:
        fail(f"fused_wide: MLPNet {SCRATCH_MLP_HIDDEN} keeps its activations in shared memory")
    kernels.reset_launch_counts()
    evaluator_vs_plain("fused_wide", bds, free_scratch.kernel_eval_factory(FlatOps()), "order-free",
                       card)
    got = dict(kernels.launch_counts())
    if got != launches_of(kernels, mlp_eval_stream=1):
        fail(f"fused_wide: the (2048,) evaluator launched {launched(got)}, want one mlp_eval_stream")
    print(f"[fused_wide] MLPNet {SCRATCH_MLP_HIDDEN}: the {plan.kind} plan, its activations in a "
          f"device scratch of {plan.act_block_bytes} bytes a block; one mlp_eval_stream launch",
          flush=True)

    # (d) Gomoku(2, 2) rounds at K = 20: the leaves past K = 9 in the
    # device scratch, uniform and MLPNet (32,)
    game = Gomoku(2, 2)
    tiny = random_positions(game, B, 1, SEED, dev)
    cfg = MCTSConfig(num_sims=SIMS, max_depth=GMK_MAX_DEPTH, parallel_sims=TINY_K)
    entries["fused_rounds_gomoku_2x2"], got = fused_route_checks(
        "fused_wide", "fused_rounds_gomoku", game, make_uniform_model(game).apply_fn, None, tiny,
        cfg, card)
    launches["fused_rounds_gomoku_2x2"] = got["fused_rounds_gomoku"]
    rnd, free = mlp_pair(game, TINY_MLP_HIDDEN)
    entries["fused_mlp_stream_rounds_2x2"], got = fused_route_checks(
        "fused_wide", "fused_mlp_stream_rounds", game, rnd, free, tiny, cfg, card)
    launches["fused_mlp_stream_rounds_2x2"] = got["fused_mlp_stream_rounds"]

    # (e) the two evaluator plans on the one MLP both take: MLPNet
    # (256, 256) on Connect-Four, timed in turns
    plans_in_turns(card, dev)
    return entries, launches


def plans_in_turns(card: str, dev) -> None:
    """Phase 14(e): ``fused_mlp`` (the resident plan) and
    ``fused_mlp_stream`` (the streamed plan) on MLPNet (256, 256) at the
    full preset's B=4096, 100 sims and the mlp preset's B=512, 50 sims, on
    the same roots and priors: the same counts (random weights within the
    gate), device times in turns (resident, streamed, streamed,
    resident)."""
    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.config import MCTSConfig
    from alphazero_tpu_torch.games import ConnectFour
    from alphazero_tpu_torch.games.connect_four import FlatOps
    from alphazero_tpu_torch.mcts.tree import INVALID_P
    from alphazero_tpu_torch.models import convert_mlp, make_apply_fn, random_mlp_variables
    from alphazero_tpu_torch.ops import root_prior

    game, flat = ConnectFour(), FlatOps()
    apply_fn = make_apply_fn(convert_mlp(random_mlp_variables(7, MLP_HIDDEN, seed=SEED)).to(dev))
    weights = apply_fn.kernel_eval_factory(flat)
    if kernels.mlp_plan(MLP_HIDDEN).kind == "streamed":
        fail(f"fused_wide: MLPNet {MLP_HIDDEN} is not on the resident/staged plan")
    for batch, sims in ((B, SIMS), (MLP_PRESET_B, MLP_PRESET_SIMS)):
        cfg = MCTSConfig(num_sims=sims, max_depth=MAX_DEPTH)
        roots = random_positions(game, batch, 30, SEED, dev)
        prior, valid = root_prior(game, apply_fn, cfg, roots, None)
        prior = torch.where(valid, prior, INVALID_P)
        bds = flat.from_state(roots).contiguous()
        run = {name: (lambda fn=fn: fn(bds, prior, weights, sims, cfg.nodes, cfg.max_depth,
                                       float(cfg.cpuct)))
               for name, fn in (("resident", kernels.fused_mlp),
                                ("streamed", kernels.fused_mlp_stream))}
        kernels.reset_launch_counts()
        c_res, c_str = run["resident"]()[0], run["streamed"]()[0]
        if dict(kernels.launch_counts()) != launches_of(kernels, fused_mlp=1, fused_mlp_stream=1):
            fail("fused_wide: the plans' searches did not launch one fused_mlp and one "
                 "fused_mlp_stream")
        same, dpi = search_agreement(f"fused_wide: the two plans at B={batch}", c_str, c_res)
        r1, s1 = device_ms(run["resident"]), device_ms(run["streamed"])
        s2, r2 = device_ms(run["streamed"]), device_ms(run["resident"])
        print(f"[fused_wide] MLPNet {MLP_HIDDEN}, B={batch}, {sims} sims, in turns: fused_mlp "
              f"(resident) [{r1:.4f}/{r2:.4f}] ms, fused_mlp_stream (streamed) [{s1:.4f}/{s2:.4f}] "
              f"ms of device time; streamed/resident {(s1 + s2) / (r1 + r2):.4f}; {same:.4f} of "
              f"games identical, max |dpi| {dpi:.4f} | {card}", flush=True)


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


def fused_mlp_args(game, apply_fn, weights, roots: torch.Tensor, cfg) -> tuple:
    """``kernels.fused_mlp``'s arguments for one search of ``roots`` with
    the kernel weights ``weights`` (``apply_fn``'s, or order-free ones)."""
    from alphazero_tpu_torch.games.connect_four import FlatOps
    from alphazero_tpu_torch.mcts.tree import INVALID_P
    from alphazero_tpu_torch.ops import root_prior

    prior, valid = root_prior(game, apply_fn, cfg, roots, None)
    return (FlatOps().from_state(roots).contiguous(), torch.where(valid, prior, INVALID_P),
            weights, cfg.num_sims, cfg.nodes, cfg.max_depth, float(cfg.cpuct))


def plain_fused_mlp(f_args, cfg):
    """``fused_mlp_search``, the fused MLP kernel's plain version, on the
    kernel's arguments ``f_args``: the plain search through its body with
    ``fused.mlp_eval`` of the same weights at its leaves. Returns a
    callable that gives its ``(N, W, done)`` planes."""
    from alphazero_tpu_torch.games.connect_four import FlatOps
    from alphazero_tpu_torch.mcts import SearchKernels, fused, hybrid

    bds, prior, weights = f_args[:3]
    planes = {}

    def merge_keeping_done(*args):
        planes["done"] = args[4]   # the done plane, which merge updates in place
        return hybrid.merge(*args)

    def plain():
        n, w = hybrid.run_search(FlatOps(), bds, prior, cfg,
                                 lambda bd, vm: fused.mlp_eval(bd, vm, weights),
                                 SearchKernels(hybrid.descend, merge_keeping_done, hybrid.refresh))
        return n, w, planes["done"]
    return plain


def conserved(label: str, game, roots: torch.Tensor, ck: torch.Tensor, sims: int) -> None:
    """Root counts ``ck`` of a search of ``roots``: the budget on every
    live root, nothing on a terminal one."""
    live = ~game.terminal(roots)[0]
    if not bool((ck.sum(dim=1)[live] == sims).all() and (ck.sum(dim=1)[~live] == 0).all()):
        fail(f"{label} counts do not sum to the simulation budget on live roots and 0 on "
             f"terminal ones")


def fused_mlp_vs_plain(tag: str, game, apply_fn, roots: torch.Tensor, cfg, card: str,
                       label: str) -> dict:
    """``kernels.fused_mlp`` with ``apply_fn``'s packed weights (random:
    the tensor cores add in another order than the plain version) against
    ``fused_mlp_search`` on ``roots``, terminal ones included: counts
    conserved, ``search_agreement``'s gate, both timed in turns (plain,
    kernel, kernel, plain), the bound of the work this run's data needs,
    and the library forward's time for ``cfg.num_sims`` calls on these
    roots' features. Returns the kernels line's ``fused_mlp`` entry."""
    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.games.connect_four import FlatOps
    from alphazero_tpu_torch.mcts import PLAIN, hybrid

    weights = apply_fn.kernel_eval_factory(FlatOps())
    batch, sims = roots.shape[0], cfg.num_sims
    f_args = fused_mlp_args(game, apply_fn, weights, roots, cfg)
    plain = plain_fused_mlp(f_args, cfg)
    (n_all, w_all, done), p1 = timed_once(plain)
    ck, wk = kernels.fused_mlp(*f_args)
    cp, wp = n_all[:, :, 0], w_all[:, :, 0]
    conserved(f"{tag}: fused_mlp", game, roots, ck, sims)
    same, dpi = search_agreement(f"{tag}: fused_mlp (random weights, {label})", ck, cp)
    # informative: the plain search with the kernel's own evaluator at its leaves
    n_e, _ = hybrid.run_search(FlatOps(), f_args[0], f_args[1], cfg,
                               lambda bd, vm: kernels.mlp_eval(bd, weights)[:2], PLAIN)
    same_e = float((ck == n_e[:, :, 0]).all(dim=1).float().mean())
    k1 = time_ms(lambda: kernels.fused_mlp(*f_args), FUSED_REPS)
    k2 = time_ms(lambda: kernels.fused_mlp(*f_args), FUSED_REPS)
    dev_ms = device_ms(lambda: kernels.fused_mlp(*f_args), reps=FUSED_REPS)
    _, p2 = timed_once(plain)
    # the work this run's data needs: every descent step's PUCT argmax and
    # backup (the sum of N over every edge), and one evaluation per
    # expansion into a child that is not terminal (every edge ever visited
    # installed one child; a terminal child's slot has done = 1, and its
    # evaluation is discarded)
    steps, installs = float(n_all.sum()), float((n_all > 0).sum())
    terminal = float(done[:, 1:].sum())
    expansions = installs - terminal
    A = game.num_actions
    hidden = weights.hidden
    widths = (84, *hidden)
    bf16_ops = expansions * 2 * sum(a * b for a, b in zip(widths, widths[1:]))
    f32_ops = (steps * (puct_ops(1, A) + 3)
               + expansions * (2 * sum(hidden)                      # bias adds, ReLU
                               + 2 * hidden[-1] * (A + 1) + (A + 1)  # the head
                               + 5 * A + 1))                         # softmax, tanh
    feats = game.to_features(roots).contiguous()
    fwd_ms = time_ms(lambda: apply_fn(feats), 20)
    entry = {
        "max_abs_err": max(float((ck - cp).abs().max()), float((wk - wp).abs().max())),
        "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
        **bound(sum(t.numel() * t.element_size() for t in weights.sections())
                + F32 * batch * (42 + A + 2 * A), f32_ops, bf16_ops),
        "library_ms": fwd_ms * sims,
    }
    n_term = int(game.terminal(roots)[0].sum())
    print(f"[{tag}] {label}, random weights: B={batch} ({batch - n_term} live, {n_term} "
          f"terminal roots), {sims} sims, max_depth {cfg.max_depth}: fused_mlp identical to "
          f"fused_mlp_search on {same:.4f} of games, max |dpi| {dpi:.4f} (gate >= "
          f"{ROUTE_SAME_GAMES}, <= {ROUTE_MAX_DPI}), max |dN|, |dW| {entry['max_abs_err']}; "
          f"identical to the plain search with kernels.mlp_eval at its leaves on {same_e:.4f} "
          f"(not gated); {installs / batch:.2f} installs per game, of which "
          f"{terminal / batch:.2f} terminal children, so {expansions / batch:.2f} evaluations "
          f"needed, and {steps / batch:.2f} descent steps; kernel {k1:.4f}/{k2:.4f} ms "
          f"({dev_ms:.4f} ms of device time), plain {p1:.4f}/{p2:.4f} ms, bound "
          f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}); library forward (F.linear, bf16) "
          f"{fwd_ms:.4f} ms a call, {entry['library_ms']:.4f} ms for {sims} | {card}", flush=True)
    return entry


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
    from alphazero_tpu_torch.models import (
        convert_mlp,
        make_apply_fn,
        order_free_mlp_variables,
        random_mlp_variables,
    )
    from alphazero_tpu_torch.ops import sample_draws
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
    plan = kernels.mlp_plan(MLP_HIDDEN)
    print(f"[mlp] MLPNet {MLP_HIDDEN}: {plan.kind} weights, "
          f"{plan.smem_bytes} bytes of dynamic shared memory a block", flush=True)

    # (a) the evaluator alone against its plain version
    evaluator_vs_plain("mlp", bds, free_w, "order-free", card)
    evaluator_vs_plain("mlp", bds, mlp_w, "random", card)

    # (b) the fused MLP kernel against its plain version on random roots
    f_free = fused_mlp_args(game, free_apply, free_w, roots, cfg_mlp)
    n_p, w_p, _ = plain_fused_mlp(f_free, cfg_mlp)()
    ck, wk = kernels.fused_mlp(*f_free)
    conserved("fused_mlp (order-free weights)", game, roots, ck, SIMS)
    if not (bit_equal(ck, n_p[:, :, 0]) and bit_equal(wk, w_p[:, :, 0])):
        diff = int(((ck != n_p[:, :, 0]) | (wk != w_p[:, :, 0])).any(dim=1).sum())
        fail(f"fused_mlp (order-free weights) differs from its plain version on {diff} of {B} "
             f"games (counts or root W)")
    print(f"[mlp] random roots, order-free weights: fused_mlp bit-equal to fused_mlp_search "
          f"(counts and root W) on all {B} games", flush=True)
    entry = fused_mlp_vs_plain("mlp", game, mlp_apply, roots, cfg_mlp, card, "random roots")

    # (b') a stack too large to stay resident runs staged: order-free
    # weights, bit-equal to its plain version
    staged_apply = make_apply_fn(
        convert_mlp(order_free_mlp_variables(A, MLP_STAGED_HIDDEN, seed=SEED)).to(dev))
    staged_w = staged_apply.kernel_eval_factory(flat)
    plan_s = kernels.mlp_plan(MLP_STAGED_HIDDEN)
    if plan_s.kind != "staged":
        fail(f"MLPNet {MLP_STAGED_HIDDEN} planned {plan_s.kind}: the staged path would not run")
    s_args = fused_mlp_args(game, staged_apply, staged_w, roots, cfg_mlp)
    n_s, w_s, _ = plain_fused_mlp(s_args, cfg_mlp)()
    (cs_, ws_), ks = timed_once(lambda: kernels.fused_mlp(*s_args))
    conserved(f"fused_mlp {MLP_STAGED_HIDDEN}", game, roots, cs_, SIMS)
    if not (bit_equal(cs_, n_s[:, :, 0]) and bit_equal(ws_, w_s[:, :, 0])):
        fail(f"staged fused_mlp {MLP_STAGED_HIDDEN} differs from its plain version")
    print(f"[mlp] MLPNet {MLP_STAGED_HIDDEN}, order-free weights: staged ({plan_s.smem_bytes} "
          f"bytes of dynamic shared memory), fused_mlp bit-equal to fused_mlp_search on all {B} games; "
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


def ptxas_lines(lib, names, gate=True) -> None:
    """ptxas's report of the named kernels: registers, stack, spills and
    static shared bytes. With ``gate``, fails on a stack frame or a
    spill; with ``gate="spills"``, on a spill only."""
    report = ptxas_report(lib.build_log, names)
    for name in names:
        got = report.get(name)
        print(f"[build] ptxas -v {name}: {got or 'not in the build log (a cached build)'}",
              flush=True)
        stack = gate is True and got and got.get("stack")
        if gate and got and (stack or got.get("spill_st") or got.get("spill_ld")):
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


def timed_sync(fn):
    """``fn()`` and its host-clock seconds, ending in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def train_step_vs_cpu(tag: str, state, tcfg, batch, card: str):
    """One learner step on the card against the same step of a CPU copy of
    the model on the same minibatch, within the bf16 bound of
    tests/test_torch_train.py: loss terms within rtol 2e-2, >= 95% of the
    parameter entries within half a learning rate (the two Adam steps agree
    in sign), running statistics within rtol 1e-3 plus 1e-4."""
    import copy

    from alphazero_tpu_torch.train import init_train_state, make_train_step

    lr = tcfg.learning_rate
    step = make_train_step(tcfg)
    cpu_model = copy.deepcopy(state.model).cpu()
    cpu_state = init_train_state(cpu_model, tcfg)
    (state, met), gpu_s = timed_sync(lambda: step(state, *batch))
    t0 = time.perf_counter()
    cpu_state, cmet = step(cpu_state, *(x.cpu() for x in batch))
    cpu_s = time.perf_counter() - t0
    rel = [abs(float(g) - float(c)) / max(abs(float(c)), 1e-30) for g, c in zip(met, cmet)]
    if max(rel) > 2e-2:
        fail(f"{tag}: train step 1 loss terms {[float(x) for x in met]} vs CPU "
             f"{[float(x) for x in cmet]}")
    gsd, csd = state.model.state_dict(), cpu_model.state_dict()
    names = {n for n, _ in cpu_model.named_parameters()}
    near = total = 0
    for k, c in csd.items():
        g = gsd[k].cpu()
        if k in names:
            near += int(((g - c).abs() <= lr / 2).sum())
            total += c.numel()
        elif k.endswith(("running_mean", "running_var")) and not torch.allclose(
                g, c, rtol=1e-3, atol=1e-4):
            fail(f"{tag}: {k} after step 1 differs from the CPU step's")
    if near < 0.95 * total:
        fail(f"{tag}: {total - near} of {total} parameter entries off the CPU step's by > lr/2")
    print(f"[{tag}] train step 1 on the card vs the CPU step: loss terms within "
          f"{max(rel):.3g} (rtol), {100 * near / total:.2f}% of {total} parameter entries within "
          f"lr/2, running statistics within 1e-3; card {1e3 * gpu_s:.3f} ms (first step), "
          f"CPU {1e3 * cpu_s:.1f} ms | {card}", flush=True)
    return state


def learner_step_stages(tag: str, state, tcfg, batch, card: str) -> None:
    """Where one learner step's launches come from (not gated): the step's
    three calls (``train.loss_terms``, the backward, the optimizer's step),
    each profiled alone on ``batch`` (its host launch calls, its device
    kernel events and the kernels that launch most often); and one
    BatchNorm (``nets._batch_norm`` at the tower's shape, training mode)
    forward and backward, of which the AZResNet has 13. The step is a real
    one: the weights move."""
    from alphazero_tpu_torch.models import nets
    from alphazero_tpu_torch.train import loss_terms

    held = {}

    def forward():
        held["loss"] = loss_terms(state.model, tcfg, *batch).loss

    def backward():
        state.optimizer.zero_grad(set_to_none=True)
        held["loss"].backward()

    # the conv output a BatchNorm takes: [batch, channels, 6, 7] in the model's dtype
    x = torch.randn(batch[0].shape[0], state.model.stem.out_channels, 6, 7,
                    device=batch[0].device, dtype=state.model.dtype, requires_grad=True)
    bn = state.model.stem_bn

    def bn_forward():
        held["bn"] = nets._batch_norm(x, bn, True)

    def bn_backward():
        held["bn"].backward(torch.ones_like(held["bn"]))

    for label, fn in (("forward and loss (loss_terms)", forward), ("backward", backward),
                      ("optimizer step (Adam)", state.optimizer.step),
                      ("one BatchNorm forward (train)", bn_forward),
                      ("one BatchNorm backward", bn_backward)):
        wall, busy, top, calls, _ = profile_step(fn)
        by_count = sorted(top, key=lambda k: -k[2])
        print(f"[{tag}] learner step, {label}: {calls} host launch calls, "
              f"{sum(k[2] for k in top)} device kernel events, {busy:.3f} ms busy of "
              f"{wall:.3f} ms wall (profiler on); most launched: "
              + "; ".join(f"{c}x {n.replace('void at::native::', '')[:90]}"
                          for n, _, c in by_count[:4]) + f" | {card}", flush=True)


def learner_phase(card: str) -> tuple:
    """Phase 16: the learner loop of the Connect-Four ``full`` preset and
    the ``mlp`` preset's fixed scan (see the module docstring). Returns the
    kernels line's ``fused_mlp`` entry, at the scan's shapes, and the
    loop's launches of each kernel it runs."""
    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.config import MCTSConfig, ReplayConfig, SelfPlayConfig, TrainConfig
    from alphazero_tpu_torch.games import ConnectFour
    from alphazero_tpu_torch.models import (
        convert_az_resnet,
        convert_mlp,
        make_apply_fn,
        pack_mlp_weights,
        random_az_resnet_variables,
        random_mlp_variables,
    )
    from alphazero_tpu_torch.ops import sample_draws
    from alphazero_tpu_torch.replay import replay_init, replay_insert, replay_sample, replay_total
    from alphazero_tpu_torch.selfplay import (
        make_actor_step_fn,
        make_recycling_selfplay_fn,
        make_selfplay_fn,
    )
    from alphazero_tpu_torch.train import init_train_state, make_train_phase, make_train_step

    dev = torch.device("cuda", 0)
    game = ConnectFour()
    A, M = game.num_actions, game.max_moves
    torch.cuda.reset_peak_memory_stats()
    model = convert_az_resnet(random_az_resnet_variables(A, 64, 5, seed=SEED),
                              dtype=torch.bfloat16).to(dev)
    cfg = MCTSConfig(num_sims=SIMS, max_depth=MAX_DEPTH, dirichlet_alpha=1.0)
    sp = SelfPlayConfig(batch_size=B, temp_threshold=TEMP_THRESHOLD, recycle=True)
    init, play = make_recycling_selfplay_fn(game, cfg, sp, device=dev)
    S = M   # recycle_steps' default
    gen = torch.Generator(device=dev).manual_seed(SEED)
    recorded = []

    def draws(t):
        d = sample_draws(gen, B, A, 1.0, dev)
        recorded.append(d)
        return d

    def call(carry, tag_n: int):
        """One recycling call with the launch counters set to 0 just before
        and read just after: ``(carry, traj, stats, launches)``."""
        kernels.reset_launch_counts()
        (out, sec) = timed_sync(lambda: play(model, carry, draws))
        got = dict(kernels.launch_counts())
        want = launches_of(kernels, descend=S * SIMS, merge=S * SIMS, refresh=S)
        if got != want:
            fail(f"learner: recycling call {tag_n} launches {got} != {want}")
        carry, traj, stats = out
        n_valid = int(traj.valid.sum())
        if traj.pi.shape != (S + M, B, A) or not torch.isfinite(traj.value).all():
            fail(f"learner: recycling call {tag_n} trajectory is not finite [S + M, B, A]")
        if not torch.allclose(traj.pi[M:].sum(-1), torch.ones(S, B, device=dev), atol=1e-5):
            fail(f"learner: recycling call {tag_n} pi rows do not sum to 1")
        vals = traj.value[traj.valid]
        if not bool(((vals == 1) | (vals == 0) | (vals == -1)).all()):
            fail(f"learner: recycling call {tag_n} valid values outside {{-1, 0, 1}}")
        print(f"[learner] recycling call {tag_n} (AZResNet-64x5 bf16, B={B}, {SIMS} sims, "
              f"{S} searches): {1e3 * sec:.3f} ms a call, {1e3 * sec / S:.3f} ms per move, "
              f"{S * B / sec:.1f} moves/s, {n_valid} valid samples ({n_valid / sec:.1f} samples/s), "
              f"{int(stats.done.sum())} games closed an episode | launches {launched(got)} | {card}",
              flush=True)
        return carry, traj, stats, got

    # ---- (a) one recycling call, and the actor step under its draws
    carry0 = init()
    carry1, traj1, stats1, launches = call(carry0, 1)
    _, actor_step = make_actor_step_fn(game, make_apply_fn(model), cfg, B, TEMP_THRESHOLD, device=dev)
    a_carry = (carry0.state, carry0.move_count)
    for t in range(S):
        if not bit_equal(traj1.features[M + t], game.to_features(a_carry[0])):
            fail(f"learner: recycling step {t}'s board differs from the actor step's")
        a_carry, a_pi = actor_step(a_carry, recorded[t])
        if not bit_equal(traj1.pi[M + t], a_pi):
            fail(f"learner: recycling step {t}'s pi differs from the actor step's")
    if not (torch.equal(a_carry[0], carry1.state) and torch.equal(a_carry[1], carry1.move_count)):
        fail("learner: the recycling call's final boards differ from the actor's")
    print(f"[learner] the recycling call's {S} pi rows and boards are bit-equal to "
          f"make_actor_step_fn's under the same draws ({B} games) | {card}", flush=True)

    # ---- (b) the 2^21-row ring
    ring_cfg = ReplayConfig(capacity=LEARNER_RING)
    # inserted twice (the second insert's time is the steady one: the
    # first loads the library kernels it launches), as is the CPU ring
    ring = replay_init(game, ring_cfg, device=dev)
    cpu_ring = replay_init(game, ring_cfg, device="cpu")
    cpu_traj = type(traj1)(*(x.cpu() for x in traj1))
    ins_s = []
    for _ in range(2):
        ring, sec = timed_sync(lambda: replay_insert(ring, game, traj1))
        ins_s.append(sec)
        cpu_ring = replay_insert(cpu_ring, game, cpu_traj)
    if not bit_equal(ring.data.cpu(), cpu_ring.data) or ring[1:] != cpu_ring[1:]:
        fail("learner: the card's ring inserts differ from the CPU inserts")
    print(f"[learner] two inserts into the {LEARNER_RING}-row ring "
          f"({ring.data.numel() * F32 / 1e6:.1f} MB): {replay_total(ring) // 2} rows each (2 "
          f"symmetries) in {1e3 * ins_s[0]:.3f} ms (first) and {1e3 * ins_s[1]:.3f} ms, "
          f"bit-equal to the CPU inserts | {card}", flush=True)

    # ---- (c) the learner: step 1 against the CPU, then 15 more
    tcfg = TrainConfig(batch_size=LEARNER_BATCH, steps_per_iteration=512)
    tgen = torch.Generator(device=dev).manual_seed(SEED)
    batch = replay_sample(ring, tcfg.batch_size, game, tgen)
    state = train_step_vs_cpu("learner", init_train_state(model, tcfg), tcfg, batch, card)
    rest = LEARNER_TRAIN_STEPS - 2   # the last one profiled
    phase = make_train_phase(tcfg, rest, game)
    (state, losses), tr_s = timed_sync(lambda: phase(state, ring, tgen))
    if not torch.isfinite(losses).all() or state.step != LEARNER_TRAIN_STEPS - 1:
        fail(f"learner: train phase losses {losses.tolist()}, step {state.step}")
    print(f"[learner] {rest} more train steps (batch {tcfg.batch_size}, Adam "
          f"{tcfg.learning_rate}, l2 {tcfg.l2_scale}): "
          f"{1e3 * tr_s / rest:.3f} ms per step; loss {losses[0].item():.4f} -> "
          f"{losses[-1].item():.4f} | {card}", flush=True)
    batch = replay_sample(ring, tcfg.batch_size, game, tgen)
    print_profiled_step("learner", lambda: make_train_step(tcfg)(state, *batch), card,
                        "AZResNet-64x5 train")
    learner_step_stages("learner", state, tcfg, batch, card)

    # ---- (d) a second call with the trained weights: the fragment resolves
    recorded.clear()
    carry2, traj2, stats2, got = call(carry1, 2)
    launches = {k: launches[k] + got[k] for k in launches}
    rows = torch.arange(M, device=dev)[:, None]
    owed = (rows < carry1.move_count[None, :]) & stats2.done[None, :]
    if not bool(traj2.valid[:M][owed].all()):
        fail("learner: a carried fragment row of a game that closed in call 2 is not valid")
    print(f"[learner] call 2 resolves all {int(owed.sum())} carried fragment rows of the "
          f"{int(stats2.done.sum())} games that closed | peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB | {card}", flush=True)

    # ---- (e) the mlp preset: the fixed scan on az_fused_mlp, 8 train steps
    mlp = convert_mlp(random_mlp_variables(A, MLP_HIDDEN, seed=SEED)).to(dev)
    mcfg = MCTSConfig(num_sims=MLP_PRESET_SIMS, max_depth=MAX_DEPTH)
    play_games = make_selfplay_fn(game, mcfg, SelfPlayConfig(batch_size=MLP_PRESET_B,
                                                             temp_threshold=TEMP_THRESHOLD), device=dev)
    mgen = torch.Generator(device=dev).manual_seed(SEED)

    def scan(tag_n: int):
        kernels.reset_launch_counts()
        (traj, stats), sec = timed_sync(lambda: play_games(
            mlp, lambda t: sample_draws(mgen, MLP_PRESET_B, A, None, dev)))
        got = dict(kernels.launch_counts())
        if got != launches_of(kernels, fused_mlp=M):
            fail(f"learner: mlp fixed scan {tag_n} launches {got}: want {M} fused_mlp")
        if not torch.allclose(traj.pi.sum(-1), torch.ones(M, MLP_PRESET_B, device=dev), atol=1e-5):
            fail(f"learner: mlp fixed scan {tag_n} pi rows do not sum to 1")
        n_valid = int(traj.valid.sum())
        print(f"[learner] mlp fixed scan {tag_n} (MLPNet {MLP_HIDDEN}, B={MLP_PRESET_B}, "
              f"{MLP_PRESET_SIMS} sims, T={M}): {1e3 * sec:.3f} ms a call, {1e3 * sec / M:.3f} ms "
              f"per step, {int(stats.num_moves.sum()) / sec:.1f} moves/s, {n_valid} valid samples "
              f"({n_valid / sec:.1f} samples/s), {int(stats.done.sum())} games done | launches "
              f"{launched(got)} | {card}", flush=True)
        return traj, got

    traj_m, got = scan(1)
    launches["fused_mlp"] = got["fused_mlp"]
    # fused_mlp against its plain version on the scan's own roots (each
    # step's boards from its features): at step 10, most games live, and
    # at the last step, most finished (frozen terminal boards searched with
    # the live ones). The kernels line takes the larger error of the two,
    # and the times and bound of step 10's, the heavier search
    mlp_apply = make_apply_fn(mlp)
    entries = []
    for t in (10, M - 1):
        roots = (traj_m.features[t][..., 0] - traj_m.features[t][..., 1]).to(torch.int8)
        if not bit_equal(game.to_features(roots), traj_m.features[t]):
            fail(f"learner: the mlp scan's step {t} boards do not round-trip through its features")
        entries.append(fused_mlp_vs_plain("learner", game, mlp_apply, roots, mcfg, card,
                                          f"mlp fixed scan's step {t} roots"))
    entry = {**entries[0], "max_abs_err": max(e["max_abs_err"] for e in entries)}

    mring = replay_insert(replay_init(game, ReplayConfig(capacity=MLP_RING), device=dev), game, traj_m)
    packed_before = [t.clone() for t in pack_mlp_weights(mlp).sections()]
    mcfg_train = TrainConfig(batch_size=MLP_BATCH, steps_per_iteration=128)
    mphase = make_train_phase(mcfg_train, MLP_TRAIN_STEPS, game)
    (_, mlosses), mtr_s = timed_sync(lambda: mphase(init_train_state(mlp, mcfg_train), mring, mgen))
    if not torch.isfinite(mlosses).all():
        fail(f"learner: mlp train losses {mlosses.tolist()}")
    changed = sum(not torch.equal(a, b) for a, b in zip(packed_before, pack_mlp_weights(mlp).sections()))
    if changed != len(packed_before):
        fail(f"learner: only {changed} of {len(packed_before)} packed MLP sections changed in training")
    _, got = scan(2)   # repacked from the trained weights
    launches["fused_mlp"] += got["fused_mlp"]
    print(f"[learner] mlp: {MLP_TRAIN_STEPS} train steps (batch {MLP_BATCH}) at "
          f"{1e3 * mtr_s / MLP_TRAIN_STEPS:.3f} ms per step, loss {mlosses[0].item():.4f} -> "
          f"{mlosses[-1].item():.4f}; every packed section changed and scan 2 ran on the repacked "
          f"weights | peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB | {card}",
          flush=True)
    print(f"[learner] launches of the loop: {launched(launches)} | {card}", flush=True)
    # only this path's kernels: the others keep their own phases' counts
    return {"fused_mlp": entry}, {k: launches[k] for k in ("descend", "merge", "refresh",
                                                           "fused_mlp")}


def bits_differ(a, b, where: str = "state"):
    """The first place where two nests of dicts, lists and tensors differ
    (tensors bit for bit, with dtype, shape and device), or None."""
    if isinstance(a, dict):
        if not isinstance(b, dict) or a.keys() != b.keys():
            return f"{where}: keys differ"
        for k in a:
            d = bits_differ(a[k], b[k], f"{where}/{k}")
            if d:
                return d
        return None
    if isinstance(a, (list, tuple)):
        if not isinstance(b, (list, tuple)) or len(a) != len(b):
            return f"{where}: lengths differ"
        for i, (x, y) in enumerate(zip(a, b)):
            d = bits_differ(x, y, f"{where}[{i}]")
            if d:
                return d
        return None
    if isinstance(a, torch.Tensor):
        if not isinstance(b, torch.Tensor) or (a.dtype, a.shape, a.device) != (b.dtype, b.shape, b.device):
            return f"{where}: dtype, shape or device differ"
        flat = (lambda t: t.reshape(-1).view(torch.uint8)) if a.is_floating_point() else (lambda t: t)
        return None if torch.equal(flat(a), flat(b)) else f"{where}: values differ"
    return None if a == b else f"{where}: {a!r} != {b!r}"


def coach_state(coach) -> dict:
    """What a resume restores: the incumbent (weights, BatchNorm
    statistics, Adam moments, step), the ring, the actor carry, the
    reanalyze position ring, the coach's generator, the counters, the Elo
    history and the match graph."""
    inc = coach.incumbent
    state = {"model": inc.model.state_dict(), "optimizer": inc.optimizer.state_dict(),
             "step": inc.step, "replay": coach.replay._asdict(), "rng": coach.rng.get_state(),
             "counters": [coach.iteration, coach.model_id],
             "elo": [coach.elo.ratings, coach.elo.history], "pool_matches": coach.pool_matches}
    if coach.actor_carry is not None:
        state["actor"] = coach.actor_carry._asdict()
    if coach.positions is not None:
        state["positions"] = coach.positions._asdict()
    return state


def check_record(tag: str, rec: dict, games: int, anchored: bool) -> None:
    """A coach record of a finished iteration: finite losses, the arena's
    games counted, anchored Elo and its SE where the pass ran."""
    if not (np.isfinite(rec["loss_first"]) and np.isfinite(rec["loss_last"])):
        fail(f"{tag}: iteration {rec['iteration']} losses are not finite: {rec}")
    if not 0 < rec["arena_wins"] + rec["arena_losses"] + rec["arena_draws"] <= games:
        fail(f"{tag}: iteration {rec['iteration']} arena counts {rec}")
    if anchored and not ("anchored_elo" in rec and np.isfinite(rec["anchored_elo"])
                         and rec["anchored_elo_se"] > 0):
        fail(f"{tag}: iteration {rec['iteration']} has no finite anchored Elo and SE: {rec}")


def print_record(tag: str, label: str, rec: dict, sec: float, got: dict, card: str) -> None:
    phases = ", ".join(f"{k} {v:.3f} s" for k, v in rec.items() if k.startswith("t_"))
    elo = (f"anchored Elo {rec['anchored_elo']} +- {rec['anchored_elo_se']} (anchor win rate "
           f"{rec['anchor_win_rate']})" if "anchored_elo" in rec else "no anchored pass")
    print(f"[{tag}] {label} iteration {rec['iteration']}: {sec:.3f} s | {phases} | gate "
          f"{rec['arena_wins']}-{rec['arena_losses']}-{rec['arena_draws']} accepted "
          f"{rec['accepted']} model_id {rec['model_id']} | {elo} | loss {rec['loss_first']:.4f} -> "
          f"{rec['loss_last']:.4f} | ring {rec['replay_size']} rows | {rec['selfplay_moves']} "
          f"self-play moves | launches {launched(got)} | peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB | {card}", flush=True)


def archive_probe(coach) -> dict:
    """What the coach's host example archive should hold: the valid rows
    (features, pi, value; step-major) of each trajectory its self-play
    returns, selected here on the device and copied to the host, and the
    host ms of each of the store's appends and saves."""
    probe = {"rows": [], "append_ms": [], "save_ms": []}
    play = coach._selfplay

    def recording(*args):
        out = play(*args)
        traj = out[1] if coach._recycle else out[0]
        valid = traj.valid.reshape(-1)
        n = valid.shape[0]
        probe["rows"].append([x.reshape(n, *shape)[valid].float().cpu().numpy()
                              for x, shape in ((traj.features, (-1,)), (traj.pi, (-1,)),
                                               (traj.value, ()))])
        return out

    coach._selfplay = recording
    store = coach.example_store
    if store is None:
        fail("the coach has no host example store (no g++ on PATH?)")
    for name in ("append", "save"):
        def timed(*args, fn=getattr(store, name), name=name):
            t0 = time.perf_counter()
            fn(*args)
            probe[f"{name}_ms"].append(1e3 * (time.perf_counter() - t0))
        setattr(store, name, timed)
    return probe


def check_archive(tag: str, probe: dict, ckdir: str, iteration: int, game, cfg, card: str) -> None:
    """``{iteration}.examples`` in ``ckdir`` loads through the port's
    ``ExampleStore`` and equals, bit for bit, the valid rows of the
    trajectories the probed coach archived, oldest first; prints its rows,
    bytes, and the append, save and load ms."""
    from alphazero_tpu_torch.native import ExampleStore

    path = os.path.join(ckdir, f"{iteration}.examples")
    if not os.path.exists(path):
        fail(f"{tag}: no {iteration}.examples in the checkpoint directory: "
             f"{sorted(os.listdir(ckdir))}")
    store = ExampleStore(cfg.replay.capacity, math.prod(game.feature_shape), game.num_actions)
    t0 = time.perf_counter()
    store.load(path)
    load_ms = 1e3 * (time.perf_counter() - t0)
    want = [np.concatenate(parts) for parts in zip(*probe["rows"])]
    n = len(store)
    if n != len(want[2]) or store.total != n:
        fail(f"{tag}: {iteration}.examples holds {n} rows (total {store.total}), the "
             f"trajectories {len(want[2])} valid samples")
    for name, got, w in zip(("features", "pi", "value"), store.read(0, n), want):
        if got.shape != w.shape or not np.array_equal(got.view(np.uint32), w.view(np.uint32)):
            fail(f"{tag}: {iteration}.examples {name} differ from the trajectories' valid rows")
    print(f"[{tag}] {iteration}.examples: {n} rows ({os.path.getsize(path)} bytes), bit-equal to "
          f"the valid rows of the archived trajectories; append "
          f"{', '.join(f'{t:.3f}' for t in probe['append_ms'])} ms, save "
          f"{', '.join(f'{t:.3f}' for t in probe['save_ms'])} ms (host), load {load_ms:.3f} ms "
          f"| {card}", flush=True)


def trace_shares(path: str) -> tuple:
    """From a chrome trace of ``profiler_trace``: ``(device busy ms, host
    launch calls, device kernel events, [(operation, device ms, count),
    ...] by time)``. Busy is the union of the
    device's kernel, copy and memset intervals; the card's trace can drop
    records, so it is a lower bound."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans, ops, calls, n_kernels = [], {}, 0, 0
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat == "cuda_runtime" and e.get("name", "").startswith(("cudaLaunch", "cuLaunch")):
            calls += 1
        if cat not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        n_kernels += cat == "kernel"
        spans.append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))))
        t, c = ops.get(e["name"], (0.0, 0))
        ops[e["name"]] = (t + float(e.get("dur", 0)) / 1e3, c + 1)
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(((k, t, c) for k, (t, c) in ops.items()), key=lambda x: -x[1])
    return busy / 1e3, calls, n_kernels, top


def traced_run(tag: str, label: str, fn, card: str) -> float:
    """``fn()`` under ``utils.timing.profiler_trace`` into a temporary
    directory; prints the block's wall ms, the device's busy and idle
    share, and its top operations, from the chrome trace. Returns the
    idle share."""
    import tempfile

    from alphazero_tpu_torch.utils.timing import profiler_trace

    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as log_dir:
        torch.cuda.synchronize()
        with profiler_trace(log_dir) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        t2 = time.perf_counter()
        busy, calls, n_kernels, top = trace_shares(prof.trace_path)
        nbytes = os.path.getsize(prof.trace_path)
        t3 = time.perf_counter()
    wall = 1e3 * (t1 - t0)
    print(f"[{tag}] traced {label}: {wall:.3f} ms wall (profiler on), device busy {busy:.3f} ms "
          f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%, {n_kernels} device "
          f"kernel events of {calls} host launch calls; chrome trace {nbytes / 2**20:.1f} MiB, "
          f"written in {t2 - t1:.1f} s, read in {t3 - t2:.1f} s | {card}", flush=True)
    for name, ms, count in top[:TRACE_TOP]:
        print(f"[{tag}]   {ms:9.3f} ms {count:7d}x {name[:100]}", flush=True)
    return 1 - busy / wall


def cut_coach_cfg(tag: str, label: str, cfg):
    """The default run's cut of a coach preset (phases 17-18): train
    steps to GAMES_CUT_STEPS, self-play sims to GAMES_CUT_SIMS, the arenas'
    sims (the gate, the anchored pass's net side) to GAMES_CUT_GATE_SIMS
    and the warmup anchored pass to one repeat, printed beside the
    preset's own values. The batch, the games and the model stay."""
    import dataclasses

    train, mcts, arena = cfg.train, cfg.mcts, cfg.arena
    cut = dataclasses.replace(
        cfg,
        train=dataclasses.replace(train, steps_per_iteration=min(train.steps_per_iteration,
                                                                 GAMES_CUT_STEPS)),
        mcts=dataclasses.replace(mcts, num_sims=min(mcts.num_sims, GAMES_CUT_SIMS)),
        arena=dataclasses.replace(arena, anchor_warmup_mult=1, num_sims=min(
            arena.num_sims or mcts.num_sims, GAMES_CUT_GATE_SIMS)))
    pairs = (("steps_per_iteration", train.steps_per_iteration, cut.train.steps_per_iteration),
             ("self-play sims", mcts.num_sims, cut.mcts.num_sims),
             ("arena sims", arena.num_sims or mcts.num_sims, cut.arena.num_sims),
             ("anchor_warmup_mult", arena.anchor_warmup_mult, 1))
    cuts = [f"{name} {was} -> {now}" for name, was, now in pairs if was != now]
    if cuts:
        print(f"[{tag}] {label}: cut {', '.join(cuts)} (the preset's own first); nothing else "
              f"cut", flush=True)
    return cut


def coach_phase(card: str, cut: bool, dev=None) -> dict:
    """Phase 17: the coach of the ``full`` and ``mlp`` presets through
    ``Coach.learn`` (see the module docstring), on ``dev`` (the card);
    with ``cut``, the full preset cut by ``cut_coach_cfg`` and the
    resumed iteration 2 run without its anchored pass (both printed
    beside the preset's own). Returns the launches of one iteration of
    each preset, the kernels line's."""
    import dataclasses
    import tempfile

    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.arena import combined_apply, make_arena_fn
    from alphazero_tpu_torch.checkpoint import restore_checkpoint
    from alphazero_tpu_torch.coach import Coach
    from alphazero_tpu_torch.examples.train_connect_four import preset
    from alphazero_tpu_torch.games import ConnectFour
    from alphazero_tpu_torch.games.connect_four import FlatOps
    from alphazero_tpu_torch.mcts import fused
    from alphazero_tpu_torch.mcts.tree import INVALID_P
    from alphazero_tpu_torch.models import (
        convert_az_resnet,
        make_apply_fn,
        make_uniform_model,
        random_az_resnet_variables,
    )
    from alphazero_tpu_torch.ops import root_prior

    dev = dev or torch.device("cuda", 0)
    game = ConnectFour()
    A = game.num_actions
    torch.cuda.reset_peak_memory_stats()
    launches = {}

    def learn_one(coach, tag: str, label: str, need, anchored: bool) -> tuple:
        kernels.reset_launch_counts()
        (recs, sec) = timed_sync(lambda: coach.learn(1))
        got = dict(kernels.launch_counts())
        idle = [k for k in need if got[k] == 0]
        if idle:
            fail(f"{tag}: {label} iteration launched no {idle}: {got}")
        check_record(tag, recs[0], coach.cfg.arena.num_games, anchored)
        print_record(tag, label, recs[0], sec, got, card)
        return recs[0], got

    # ---- (a) the full preset: iteration 1, checkpoint, resume, iteration 2
    with tempfile.TemporaryDirectory(prefix="chip_smoke_coach_") as ckdir:
        model, cfg = preset("full", SEED, ckdir)
        own = cfg
        if cut:
            cfg = cut_coach_cfg("coach", "full preset", cfg)
        coach = Coach(game, model, cfg, device=dev)
        probe = archive_probe(coach)
        full_need = ("descend", "merge", "refresh", "fused")
        rec1, got = learn_one(coach, "coach", "full preset", full_need, True)
        launches.update({k: got[k] for k in full_need})
        check_archive("coach", probe, ckdir, 0, game, cfg, card)
        if rec1["selfplay_moves"] != cfg.selfplay.batch_size * game.max_moves:
            fail(f"coach: iteration 1 self-play moves {rec1['selfplay_moves']}")
        nbytes = os.path.getsize(os.path.join(ckdir, "ckpt_000001"))
        # the same checkpoint saved again, then read back onto the card
        _, save_s = timed_sync(lambda: coach.save())
        (payload, _), restore_s = timed_sync(lambda: restore_checkpoint(ckdir, 1, coach._payload()))
        del payload
        other, _ = preset("full", SEED + 7)      # other initial weights: the resume must replace them
        # with ``cut``, the resumed coach's iteration 2 is past the warmup:
        # no anchored pass, whose protocol iteration 1 ran
        cfg2 = dataclasses.replace(cfg, arena=dataclasses.replace(cfg.arena, anchor_warmup=1)) \
            if cut else cfg
        resumed, resume_s = timed_sync(lambda: Coach(game, other, cfg2, device=dev))
        diff = bits_differ(coach_state(coach), coach_state(resumed))
        if diff:
            fail(f"coach: the resumed coach differs from the live one at {diff}")
        print(f"[coach] checkpoint 1: {nbytes} bytes ({nbytes / 2**20:.1f} MiB), save "
              f"{1e3 * save_s:.3f} ms, restore_checkpoint {1e3 * restore_s:.3f} ms, a new Coach "
              f"resuming from it {1e3 * resume_s:.3f} ms: bit-equal to the live coach (weights, "
              f"BatchNorm statistics, Adam moments, the {resumed.replay.size}-row ring, actor "
              f"carry, generator, counters, Elo history, {len(resumed.pool_matches)} matches) "
              f"| {card}", flush=True)
        del coach
        torch.cuda.empty_cache()
        if cut:
            print(f"[coach] full preset (resumed): iteration 2 cut to no anchored pass (the "
                  f"preset's own: warmup x{own.arena.anchor_warmup_mult} through iteration "
                  f"{own.arena.anchor_warmup})", flush=True)
        probe = archive_probe(resumed)
        rec2, got2 = learn_one(resumed, "coach", "full preset (resumed)",
                               full_need[:3] if cut else full_need, not cut)
        if rec2["iteration"] != 2:
            fail(f"coach: the resumed coach ran iteration {rec2['iteration']}")
        # the resumed coach's store starts empty: its file holds iteration 2
        check_archive("coach", probe, ckdir, 1, game, cfg, card)

    full_cfg = cfg

    # ---- (b) root counts through the kernels and the plain versions
    arena_cfg = dataclasses.replace(cfg.mcts, num_sims=cfg.arena.num_sims, dirichlet_alpha=None)
    games = cfg.arena.num_games
    roots = random_positions(game, games, 20, SEED, dev)
    second = convert_az_resnet(random_az_resnet_variables(A, 64, 5, seed=SEED + 1),
                               dtype=torch.bfloat16).to(dev)
    seats = torch.arange(games, device=dev) < (games + 1) // 2
    both = combined_apply(make_apply_fn(resumed.incumbent.model), make_apply_fn(second), seats)
    same_counts_through_kernels_and_plain(
        "coach", game, both, arena_cfg, roots, None,
        {"descend": arena_cfg.num_sims, "merge": arena_cfg.num_sims, "refresh": 1})
    uniform = make_uniform_model(game).apply_fn
    rung_cfg = dataclasses.replace(arena_cfg, num_sims=max(cfg.arena.anchor_ladder))
    kernels.reset_launch_counts()
    c_kernel, ms = timed_once(lambda: fused.make_fused_root_fn(game, uniform, rung_cfg)(roots))
    if kernels.launch_counts() != launches_of(kernels, fused=1):
        fail(f"coach: the rung search launches {kernels.launch_counts()}")
    live = ~game.terminal(roots)[0]
    if not bool((c_kernel.sum(dim=1)[live] == rung_cfg.num_sims).all()):
        fail("coach: the rung search's counts of live games do not sum to its budget")
    sub = roots[:COACH_SUBSET]
    prior, valid = root_prior(game, uniform, rung_cfg, sub)
    c_plain, plain_ms = timed_once(lambda: fused.fused_search(
        FlatOps().from_state(sub), torch.where(valid, prior, INVALID_P), rung_cfg, 0.0)[0])
    if not torch.equal(c_kernel[:COACH_SUBSET], c_plain):
        fail(f"coach: the {rung_cfg.num_sims}-sim rung search differs from the plain one on "
             f"{int((c_kernel[:COACH_SUBSET] != c_plain).any(dim=1).sum())} of {COACH_SUBSET} roots")
    print(f"[coach] one rung move's uniform side ({rung_cfg.num_sims} sims, nodes "
          f"{rung_cfg.nodes}, B={games}): one az_fused launch, {ms:.3f} ms; its first "
          f"{COACH_SUBSET} roots' counts identical to the plain fused search's ({plain_ms:.3f} ms "
          f"for those {COACH_SUBSET}) | {card}", flush=True)

    # ---- (d) one gate arena and one rung of the anchored pass, traced: the
    # coach's arenas (its gate's config; the anchored pass's protocol, the
    # first rung), at TRACE_CUT_SIMS in the default run
    sims = min(TRACE_CUT_SIMS, cfg.arena.num_sims) if cut else cfg.arena.num_sims
    if sims != cfg.arena.num_sims:
        print(f"[coach] traced arenas: sims cut {cfg.arena.num_sims} -> {sims} (the cut config's "
              f"gate first; the preset's own: {own.arena.num_sims})", flush=True)
    trace_cfg = dataclasses.replace(arena_cfg, num_sims=sims, parallel_sims=1)
    rung_sims = min(cfg.arena.anchor_ladder)
    inc = resumed.incumbent.model
    (k_gate, k_rung) = resumed._split(2)
    kernels.reset_launch_counts()
    gate_arena = make_arena_fn(game, trace_cfg, games, device=dev)
    traced_run("coach", f"gate arena ({games} games, {sims} sims, two AZResNet-64x5 on the "
               f"combined forward)", lambda: gate_arena(second, inc, resumed._ties(k_gate)), card)
    gate_got = dict(kernels.launch_counts())
    kernels.reset_launch_counts()
    rung_arena = make_arena_fn(game, trace_cfg, games,
                               mcts_cfg_inc=dataclasses.replace(trace_cfg, num_sims=rung_sims),
                               device=dev)
    traced_run("coach", f"anchored pass rung anchor@{rung_sims} (the net at {sims} sims, the "
               f"uniform rung at {rung_sims})",
               lambda: rung_arena(inc, resumed._uniform, resumed._ties(k_rung)), card)
    rung_got = dict(kernels.launch_counts())
    for label, got_t, need in (("gate", gate_got, full_need[:3]), ("rung", rung_got, full_need)):
        if any(got_t[k] == 0 for k in need):
            fail(f"coach: the traced {label} arena launched no {need}: {got_t}")
    print(f"[coach] traced launches: gate {launched(gate_got)}; rung {launched(rung_got)}",
          flush=True)
    del resumed, second
    torch.cuda.empty_cache()

    # ---- (c) the mlp preset: 2 iterations, the anchored pass at the second
    model, cfg = preset("mlp", SEED)
    coach = Coach(game, model, cfg, device=dev)
    learn_one(coach, "coach", "mlp preset", ("fused_mlp",), False)
    _, got = learn_one(coach, "coach", "mlp preset", ("fused_mlp", "fused"), True)
    launches["fused_mlp"] = got["fused_mlp"]
    print(f"[coach] launches of one full-preset iteration (iteration 1: warmup anchored pass x"
          f"{full_cfg.arena.anchor_warmup_mult} and the ladder's calibration): "
          f"{launched({k: launches[k] for k in full_need})}; of iteration 2"
          f"{' (no anchored pass)' if cut else ''}: {launched(got2)}; "
          f"fused_mlp of the mlp preset's iteration 2: {launches['fused_mlp']} | {card}", flush=True)
    return launches


def games_phase(card: str, cut: bool, dev=None) -> dict:
    """Phase 18: one ``Coach.learn`` iteration of the Othello, Gomoku 9
    and Hex ``full`` presets and of the Connect-Four ``convnet`` preset,
    as their training CLIs build them, on ``dev`` (the card); with
    ``cut``, each preset cut by ``cut_coach_cfg``. Othello is resumed from its checkpoint
    bit-equal to the live coach; one Othello gate move's counts through
    the kernels equal the plain versions'; AZConvNet's folded forward is
    held against its unfolded one. Returns the launches of the phase's
    iterations (summed over the games), the kernels line's for the
    games' kernels."""
    import dataclasses
    import tempfile

    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.arena import combined_apply
    from alphazero_tpu_torch.coach import Coach
    from alphazero_tpu_torch.examples import (
        train_connect_four,
        train_gomoku,
        train_hex,
        train_othello,
    )
    from alphazero_tpu_torch.games import ConnectFour, Gomoku, Hex, Othello
    from alphazero_tpu_torch.models import (
        convert_az_convnet,
        convert_az_resnet,
        make_apply_fn,
        random_az_convnet_variables,
        random_az_resnet_variables,
    )

    dev = dev or torch.device("cuda", 0)
    total = {}
    runs = (
        ("Othello full", Othello(), lambda seed, d: train_othello.preset("full", seed, d),
         ("descend_othello", "merge_dense", "refresh_dense")),
        ("Gomoku 9 full", Gomoku(9), lambda seed, d: train_gomoku.preset("full", seed, d, 9),
         ("descend_gomoku", "merge_dense", "refresh_dense")),
        ("Hex full", Hex(), lambda seed, d: train_hex.preset("full", seed, d),
         ("descend_hex", "merge_dense", "refresh_dense")),
        ("Connect-Four convnet", ConnectFour(),
         lambda seed, d: train_connect_four.preset("convnet", seed, d),
         ("descend", "merge", "refresh")),
    )
    for label, game, preset, need in runs:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_games_") as ckdir:
            model, cfg = preset(SEED, ckdir)
            if cut:
                cfg = cut_coach_cfg("games", label, cfg)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            coach = Coach(game, model, cfg, device=dev)
            kernels.reset_launch_counts()
            recs, sec = timed_sync(lambda: coach.learn(1))
            got = dict(kernels.launch_counts())
            idle = [k for k in need if got[k] == 0]
            if idle:
                fail(f"games: the {label} iteration launched no {idle}: {got}")
            rec = recs[0]
            # iteration 1 runs the anchored pass where the preset warms up
            warm = bool(cfg.arena.anchor_interval and (cfg.arena.anchor_warmup or 0) >= 1)
            check_record("games", rec, cfg.arena.num_games, warm)
            if rec["eval_folded"] is not True:
                fail(f"games: {label} searched an unfolded net: {rec}")
            print_record("games", label, rec, sec, got, card)
            nbytes = os.path.getsize(os.path.join(ckdir, "ckpt_000001"))
            print(f"[games] {label}: checkpoint 1 {nbytes} bytes ({nbytes / 2**20:.1f} MiB), "
                  f"ring {coach.replay.size} rows of {cfg.replay.capacity} ({game.num_symmetries} "
                  f"symmetries a sample) | {card}", flush=True)
            for k, v in got.items():
                total[k] = total.get(k, 0) + v
            if label == "Othello full":
                other, _ = preset(SEED + 7, None)   # other initial weights: the resume replaces them
                resumed, resume_s = timed_sync(lambda: Coach(game, other, cfg, device=dev))
                diff = bits_differ(coach_state(coach), coach_state(resumed))
                if diff:
                    fail(f"games: the resumed Othello coach differs from the live one at {diff}")
                print(f"[games] Othello: a new Coach resuming from checkpoint 1 in "
                      f"{1e3 * resume_s:.3f} ms: bit-equal to the live coach (weights, BatchNorm "
                      f"statistics, Adam moments, the {resumed.replay.size}-row ring, generator, "
                      f"counters, Elo history, {len(resumed.pool_matches)} matches) | {card}",
                      flush=True)
                # one gate-arena move at mixed seating: the incumbent against
                # another AZResNet of the preset's width on the combined forward
                A, games = game.num_actions, cfg.arena.num_games
                arena_cfg = dataclasses.replace(cfg.mcts, num_sims=cfg.arena.num_sims,
                                                dirichlet_alpha=None)
                roots = random_positions(game, games, 30, SEED, dev)
                second = convert_az_resnet(random_az_resnet_variables(
                    A, OTH_CHANNELS, OTH_BLOCKS, cells=64, seed=SEED + 1),
                    dtype=torch.bfloat16).to(dev)
                seats = torch.arange(games, device=dev) < (games + 1) // 2
                both = combined_apply(make_apply_fn(resumed.incumbent.model),
                                      make_apply_fn(second), seats)
                same_counts_through_kernels_and_plain(
                    "games", game, both, arena_cfg, roots, None,
                    {"descend_othello": arena_cfg.num_sims, "merge_dense": arena_cfg.num_sims,
                     "refresh_dense": 1})
                del resumed, second, both
            del coach

    # AZConvNet (the convnet preset's width): folded against unfolded
    game = ConnectFour()
    feats = game.to_features(random_positions(game, 1024, 30, SEED, dev))
    variables = random_az_convnet_variables(game.num_actions, 512, seed=SEED)
    for dtype, atol in ((torch.float32, CONVNET_F32_ATOL), (torch.bfloat16, CONVNET_BF16_ATOL)):
        net = convert_az_convnet(variables, dtype=dtype).to(dev)
        with torch.no_grad():
            ul, uv = net(feats)
        fl, fv = make_apply_fn(net)(feats)
        dl = float((fl - ul).abs().max())
        dv = float((fv - uv).abs().max())
        if not (torch.isfinite(fl).all() and torch.isfinite(fv).all()) or max(dl, dv) > atol:
            fail(f"games: AZConvNet-512 {dtype} folded vs unfolded |dlogits| {dl:.4g} "
                 f"|dvalue| {dv:.4g} > {atol}")
        fold_ms = time_ms(lambda: make_apply_fn(net)(feats), 5)
        print(f"[games] AZConvNet-512 {str(dtype)[6:]} folded vs unfolded forward (B=1024): "
              f"|dlogits| {dl:.4g}, |dvalue| {dv:.4g} <= {atol}; the folded forward with its "
              f"fold {fold_ms:.3f} ms | {card}", flush=True)
        del net
    print(f"[games] launches of the phase's four iterations: {launched(total)} | {card}",
          flush=True)
    return total


def dense_phase(card: str, dev=None) -> None:
    """Phase 19: the dense engine (see the module docstring), on ``dev``
    (the card). Its searches launch none of the hand-written kernels (the
    counters are set to 0 just before each and read just after), the
    hybrid searches they are held against exactly theirs."""
    import contextlib
    import dataclasses
    import io
    import tempfile

    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.checkpoint import save_checkpoint
    from alphazero_tpu_torch.examples import analyze
    from alphazero_tpu_torch.config import MCTSConfig, SelfPlayConfig
    from alphazero_tpu_torch.games import ConnectFour, Othello
    from alphazero_tpu_torch.mcts import hybrid, make_search_fn
    from alphazero_tpu_torch.models import (
        convert_az_resnet,
        convert_mlp,
        make_apply_fn,
        make_uniform_model,
        order_free_mlp_variables,
        random_az_resnet_variables,
    )
    from alphazero_tpu_torch.ops import sample_draws
    from alphazero_tpu_torch.selfplay import make_selfplay_fn

    dev = dev or torch.device("cuda", 0)
    c4, oth = ConnectFour(), Othello()
    marks = [("start", time.perf_counter())]

    def dense_vs_hybrid(tag: str, game, apply_fn, cfg, roots, noise, exact: bool, want: dict):
        """One search of ``roots`` on each engine, the launch counters at 0
        just before each: the dense engine launches no kernel, the hybrid
        one ``want``. Root counts identical (``exact``) or within the JAX
        package's Mosaic-vs-XLA bound; each engine timed twice, peak
        memory. Returns the dense engine's ``search``."""
        search = make_search_fn(game, apply_fn, cfg)
        hyb = hybrid.make_hybrid_root_fn(game, apply_fn, cfg)
        out = {}
        for name, run, expect in (("dense", lambda: search(roots, noise).root_counts(), {}),
                                  ("hybrid", lambda: hyb(roots, noise), want)):
            times = []
            for _ in range(2):
                torch.cuda.reset_peak_memory_stats()
                kernels.reset_launch_counts()
                counts, sec = timed_sync(run)
                got = dict(kernels.launch_counts())
                if got != launches_of(kernels, **expect):
                    fail(f"dense {tag} {name} search launches {launched(got)} != {expect}")
                times.append(1e3 * sec)
            out[name] = (counts, times, torch.cuda.max_memory_allocated())
        cd, ch = out["dense"][0], out["hybrid"][0]
        conserved(f"dense {tag}", game, roots, cd, cfg.num_sims)
        if exact:
            if not torch.equal(cd, ch):
                fail(f"dense {tag}: dense and hybrid counts differ on "
                     f"{int((cd != ch).any(dim=1).sum())} of {cd.shape[0]} games")
            verdict = f"identical counts on all {cd.shape[0]} games"
        else:
            same, dpi = search_agreement(f"dense {tag}", cd, ch)
            verdict = f"{same:.4f} of games identical, max |dpi| {dpi:.4f}"
        print(f"[dense] {tag}: B={roots.shape[0]}, {cfg.num_sims} sims, max_depth "
              f"{cfg.max_depth}: dense vs hybrid engine, {verdict}; ms a search dense "
              f"{out['dense'][1][0]:.1f}/{out['dense'][1][1]:.1f}, hybrid "
              f"{out['hybrid'][1][0]:.1f}/{out['hybrid'][1][1]:.1f}; peak memory dense "
              f"{out['dense'][2] / 2**30:.3f} GiB, hybrid {out['hybrid'][2] / 2**30:.3f} GiB | "
              f"{card}", flush=True)
        return search

    # ---- (a) Connect-Four, phase 3's roots -------------------------------
    cfg = MCTSConfig(num_sims=SIMS, max_depth=MAX_DEPTH, dirichlet_alpha=1.0)
    roots = random_positions(c4, B, 30, SEED, dev)
    noise = sample_draws(torch.Generator(device=dev).manual_seed(SEED), B, c4.num_actions, 1.0,
                         dev).dirichlet
    resnet = make_apply_fn(convert_az_resnet(random_az_resnet_variables(7, 64, 5, seed=SEED),
                                             dtype=torch.bfloat16).to(dev))
    order_free = make_apply_fn(convert_mlp(order_free_mlp_variables(7, MLP_HIDDEN, seed=SEED)).to(dev))
    marks.append(("(a) roots and models", time.perf_counter()))
    c4_want = {"descend": SIMS, "merge": SIMS, "refresh": 1}
    dense_vs_hybrid("C4 uniform", c4, make_uniform_model(c4).apply_fn, cfg, roots, noise, True,
                    c4_want)
    dense_vs_hybrid("C4 MLPNet (256, 256) order-free", c4, order_free, cfg, roots, noise, True,
                    c4_want)
    search = dense_vs_hybrid("C4 AZResNet-64x5 bf16", c4, resnet, cfg, roots, noise, False,
                             c4_want)
    marks.append(("(a) searches", time.perf_counter()))
    n_prof = DENSE_PROFILED_SIMS
    wall, busy, top, calls, syncs = profile_step(lambda: search(roots, noise, num_sims=n_prof))
    print(f"[dense] one profiled C4 AZResNet-64x5 search of {n_prof} sims: {wall:.3f} ms wall "
          f"(profiler on), device busy {busy:.3f} ms ({100 * busy / wall:.1f}%), idle "
          f"{100 * (1 - busy / wall):.1f}%, {calls} host launch calls "
          f"({calls / n_prof:.1f} a simulation), {syncs} host synchronisations "
          f"({syncs / n_prof:.2f} a simulation: one a descent level) | {card}", flush=True)
    for name, ms, count in top[:8]:
        print(f"[dense]   {ms:9.3f} ms {count:6d}x {name[:100]}", flush=True)

    marks.append(("(a) profiled search", time.perf_counter()))

    # ---- (b) Othello at phase 8c's cutoff depth --------------------------
    oth_cfg = MCTSConfig(num_sims=SIMS, max_depth=OTH_CUT_DEPTH, dirichlet_alpha=OTH_DIRICHLET)
    oth_roots = random_positions(oth, OTH_B, 40, SEED, dev)
    oth_noise = sample_draws(torch.Generator(device=dev).manual_seed(SEED), OTH_B,
                             oth.num_actions, OTH_DIRICHLET, dev).dirichlet
    dense_vs_hybrid("Othello uniform, depth cutoffs", oth, make_uniform_model(oth).apply_fn,
                    oth_cfg, oth_roots, oth_noise, True,
                    {"descend_othello": SIMS, "merge_dense": SIMS, "refresh_dense": 1})

    marks.append(("(b)", time.perf_counter()))

    # ---- (c) the forced arm: fixed-scan self-play with forced playouts ----
    f_cfg = MCTSConfig(num_sims=FORCED_SIMS, max_depth=MAX_DEPTH, dirichlet_alpha=1.0,
                       forced_playouts=FORCED_K)
    f_sp = SelfPlayConfig(batch_size=FORCED_B, temp_threshold=TEMP_THRESHOLD)
    model = convert_mlp(order_free_mlp_variables(7, MLP_HIDDEN, seed=SEED + 1))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    draws = [sample_draws(gen, FORCED_B, 7, 1.0, dev) for _ in range(c4.max_moves)]
    play = make_selfplay_fn(c4, f_cfg, f_sp, device=dev)
    kernels.reset_launch_counts()
    (traj, stats), sec = timed_sync(lambda: play(model.to(dev), lambda t: draws[t]))
    if kernels.launch_counts() != launches_of(kernels):
        fail(f"dense forced scan launched kernels {launched(kernels.launch_counts())}")
    valid = traj.valid
    sums = traj.pi[valid].sum(dim=-1)
    if not bool(((sums - 1.0).abs() <= 1e-5).all()) or not bool((traj.pi >= 0).all()):
        fail("dense forced scan: a valid row's pruned target does not sum to 1")
    moves = int(stats.num_moves.sum())
    print(f"[dense] forced arm (train_compare.py tpu preset): MLPNet (256, 256) order-free, "
          f"fixed scan B={FORCED_B}, {FORCED_SIMS} sims, max_depth {MAX_DEPTH}, k={FORCED_K}: "
          f"one call {1e3 * sec:.1f} ms, {moves} moves ({moves / sec:.1f} moves/s), "
          f"{int(valid.sum())} valid samples ({int(valid.sum()) / sec:.1f}/s), "
          f"{int(stats.done.sum())} of {FORCED_B} games done; pruned targets sum to 1 on every "
          f"valid row | {card}", flush=True)
    n = FORCED_CPU_B
    cpu_draws = [type(d)(*(None if x is None else x[:n].cpu() for x in d)) for d in draws]
    play_cpu = make_selfplay_fn(c4, f_cfg, dataclasses.replace(f_sp, batch_size=n), device="cpu")
    (c_traj, c_stats), c_sec = timed_sync(lambda: play_cpu(model.cpu(), lambda t: cpu_draws[t]))
    for name in ("features", "value", "valid"):
        if not torch.equal(getattr(traj, name)[:, :n].cpu(), getattr(c_traj, name)):
            fail(f"dense forced scan: the card's first {n} games' {name} differ from the CPU's")
    for name in stats._fields:
        if not torch.equal(getattr(stats, name)[:n].cpu(), getattr(c_stats, name)):
            fail(f"dense forced scan: the card's first {n} games' {name} differ from the CPU's")
    dpi = (traj.pi[:, :n].cpu() - c_traj.pi).abs()
    if float(dpi.max()) > 1e-6:
        fail(f"dense forced scan: pruned targets differ by {float(dpi.max())} from the CPU's")
    print(f"[dense] forced arm, its first {n} games on the CPU ({1e3 * c_sec:.1f} ms) with the same "
          f"draws: moves, features, values, valid rows and stats identical; pruned targets "
          f"bit-equal on {float((dpi == 0).float().mean()):.4f} of entries, max |d| "
          f"{float(dpi.max()):.3g} (exp, log and tanh may round apart on the two devices)",
          flush=True)

    marks.append(("(c)", time.perf_counter()))

    # ---- (d) the CLIs ------------------------------------------------------
    root_dir = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root_dir)

    def cli(args, label):
        t0 = time.perf_counter()
        args = [*args, *(["--cpu"] if dev.type == "cpu" else [])]
        r = subprocess.run([sys.executable, "-m", *args], cwd=root_dir, env=env,
                           stdin=subprocess.DEVNULL, capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            fail(f"{label} exited {r.returncode}: {r.stderr[-2000:]}")
        return r.stdout, time.perf_counter() - t0

    def report_analysis(moves: str, sims: int, out: str, how: str) -> None:
        """Gate and print one analysis: its best move takes an immediate win
        where the position has one."""
        best = int(out.rsplit("search best move: ", 1)[1].split()[0])
        wins = winning_moves([int(a) for a in moves.split()])
        if wins and best not in wins:
            fail(f"analyze --moves '{moves}': best move {best}, not one of the wins {wins}")
        net = next(ln for ln in out.splitlines() if ln.startswith("net ["))
        print(f"[dense] analyze --moves '{moves}' --sims {sims} --model resnet (a seeded "
              f"AZResNet-64x5 checkpoint): {how}; {net.split(']: ')[1]}; best move {best} "
              f"(immediate wins: {sorted(wins) or 'none'})", flush=True)

    def winning_moves(seq):
        s = c4.init(1, "cpu")
        for a in seq:
            s = c4.step(s, torch.tensor([a]))
        valid = c4.valid_moves(s)[0]
        return {a for a in range(7)
                if valid[a] and bool(c4.terminal(c4.step(s, torch.tensor([a])))[0][0])}

    with tempfile.TemporaryDirectory() as ckpt:
        save_checkpoint(ckpt, 1, {"incumbent": {"model": convert_az_resnet(
            random_az_resnet_variables(7, 64, 5, seed=SEED)).state_dict()}})
        out, sec = cli(["alphazero_tpu_torch.examples.analyze", "--game", "connect_four",
                        "--moves", "3 3 4", "--sims", str(ANALYZE_SIMS), "--model", "resnet",
                        "--checkpoint-dir", ckpt], "analyze --moves '3 3 4'")
        report_analysis("3 3 4", ANALYZE_SIMS, out, f"exit 0 in {sec:.1f} s (sims cut 800 -> "
                        f"{ANALYZE_SIMS})")
        # a position with an immediate win (columns 2 and 6), through the
        # same entry point in this process
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = analyze.main(["--moves", "3 0 4 0 5 0", "--sims", "200", "--model", "resnet",
                               "--checkpoint-dir", ckpt,
                               *(["--cpu"] if dev.type == "cpu" else [])])
        if rc != 0:
            fail(f"analyze --moves '3 0 4 0 5 0' returned {rc}")
        report_analysis("3 0 4 0 5 0", 200, buf.getvalue(),
                        f"main() returned 0 in {time.perf_counter() - t0:.1f} s")
    out, sec = cli(["alphazero_tpu_torch.examples.play_othello", "--sims", "200"],
                   "play_othello")
    if "engine plays" not in out or not out.rstrip().endswith("bye"):
        fail(f"play_othello did not move and end at EOF: {out[-500:]}")
    played = next(ln for ln in out.splitlines() if ln.startswith("engine plays"))
    print(f"[dense] play_othello --sims 200, stdin closed: exit 0 in {sec:.1f} s; {played}",
          flush=True)
    marks.append(("(d)", time.perf_counter()))
    print("[dense] phase 19: " + ", ".join(f"{name} {t - t0:.1f} s" for (_, t0), (name, t)
                                          in zip(marks, marks[1:]))
          + f"; {marks[-1][1] - marks[0][1]:.1f} s in all | {card}", flush=True)


def economy_phase(card: str, dev=None) -> dict:
    """Phase 20: the training economy (see the module docstring), on
    ``dev`` (the card): Gumbel search, the ``economy`` fixed scan,
    playout-cap randomization, a reanalyze pass, a cut ``economy`` coach
    iteration with reanalyze, and ``analyze --engine gumbel``. Gumbel search
    is plain PyTorch on the dense engine and launches no kernel; PCR's two
    sub-batch searches launch ``az_fused_mlp``, the PUCT reanalyze pass the
    hybrid kernels. Returns those launches (the counters at 0 just before
    each and read just after), which the kernels line adds."""
    import contextlib
    import dataclasses
    import io
    import tempfile

    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.checkpoint import save_checkpoint
    from alphazero_tpu_torch.coach import Coach
    from alphazero_tpu_torch.config import MCTSConfig, ReanalyzeConfig, SelfPlayConfig
    from alphazero_tpu_torch.examples import analyze
    from alphazero_tpu_torch.examples.train_connect_four import preset
    from alphazero_tpu_torch.games import ConnectFour
    from alphazero_tpu_torch.games.connect_four import FlatOps
    from alphazero_tpu_torch.mcts import PLAIN, hybrid, make_gumbel_search_fn
    from alphazero_tpu_torch.models import (
        convert_az_resnet,
        convert_mlp,
        make_apply_fn,
        order_free_mlp_variables,
        random_az_resnet_variables,
    )
    from alphazero_tpu_torch.ops import sample_draws
    from alphazero_tpu_torch.reanalyze import make_reanalyze_fn, position_init, position_insert
    from alphazero_tpu_torch.selfplay import _make_root_counts_fn, make_selfplay_fn

    dev = dev or torch.device("cuda", 0)
    c4 = ConnectFour()
    A = c4.num_actions
    marks = [("start", time.perf_counter())]
    out = {}

    def resnet():
        """AZResNet-64x5 in bf16, seeded random weights through the converter."""
        return convert_az_resnet(random_az_resnet_variables(A, 64, 5, seed=SEED),
                                 dtype=torch.bfloat16).to(dev)

    def no_launches(tag: str) -> None:
        if kernels.launch_counts() != launches_of(kernels):
            fail(f"economy {tag} launched kernels {launched(kernels.launch_counts())}")

    def gumbel_checks(tag: str, roots, res, sims: int) -> None:
        """Root visits sum to ``sims`` on live games, pi' rows to 1 where a
        move is legal, the action legal and most visited."""
        counts = res.tree.root_counts()
        conserved(f"economy {tag}", c4, roots, counts, sims)
        live = ~c4.terminal(roots)[0]
        valid = c4.valid_moves(roots)
        movable = valid.any(dim=1)
        if not bool(((res.improved_pi.sum(dim=1) - 1.0).abs()[movable] <= 1e-5).all()):
            fail(f"economy {tag}: an improved policy does not sum to 1")
        act = res.action[:, None]
        if not bool(valid.gather(1, act)[movable].all()):
            fail(f"economy {tag}: an action is illegal")
        if not bool((counts.gather(1, act)[:, 0] == counts.amax(dim=1))[live].all()):
            fail(f"economy {tag}: an action is not among the most visited")

    # ---- (a) Gumbel search at the economy preset's width -----------------
    cfg = MCTSConfig(num_sims=ECO_SIMS, max_depth=MAX_DEPTH, gumbel=True)
    roots = random_positions(c4, ECO_B, 30, SEED, dev)
    g = sample_draws(torch.Generator(device=dev).manual_seed(SEED), ECO_B, A, None, dev).gumbel
    net = make_apply_fn(resnet())
    gsearch = make_gumbel_search_fn(c4, net, cfg)
    times = []
    for _ in range(2):
        kernels.reset_launch_counts()
        res, sec = timed_sync(lambda: gsearch(roots, g))
        no_launches("Gumbel search")
        times.append(1e3 * sec)
    gumbel_checks("Gumbel search", roots, res, ECO_SIMS)
    marks.append(("(a) search", time.perf_counter()))
    n_prof = ECO_PROFILED_SIMS
    wall, busy, top, calls, syncs = profile_step(lambda: gsearch(roots, g, num_sims=n_prof))
    print(f"[economy] Gumbel search, AZResNet-64x5 bf16, B={ECO_B}, {ECO_SIMS} sims, max_depth "
          f"{MAX_DEPTH}: {times[0]:.1f}/{times[1]:.1f} ms a search ({times[1] / ECO_SIMS:.2f} ms "
          f"a simulation), no kernel launched; visits sum to {ECO_SIMS} on live roots, pi' rows "
          f"to 1, actions legal and most visited | one profiled search of {n_prof} sims: "
          f"{wall:.3f} ms wall (profiler on), device busy {busy:.3f} ms, idle "
          f"{100 * (1 - busy / wall):.1f}%, {calls / n_prof:.1f} host launch calls and "
          f"{syncs / n_prof:.2f} host synchronisations a simulation | {card}", flush=True)
    for name, ms, count in top[:6]:
        print(f"[economy]   {ms:9.3f} ms {count:6d}x {name[:100]}", flush=True)
    marks.append(("(a) profile", time.perf_counter()))
    mlp = convert_mlp(order_free_mlp_variables(A, MLP_HIDDEN, seed=SEED))
    cpu_net = make_apply_fn(mlp)
    res_d = make_gumbel_search_fn(c4, make_apply_fn(mlp.to(dev)), cfg)(roots, g)
    n = ECO_CPU_B
    res_c = make_gumbel_search_fn(c4, cpu_net, cfg)(roots[:n].cpu(), g[:n].cpu())
    gumbel_checks("order-free MLP search", roots, res_d, ECO_SIMS)
    if not (torch.equal(res_d.tree.root_counts()[:n].cpu(), res_c.tree.root_counts())
            and torch.equal(res_d.action[:n].cpu(), res_c.action)):
        fail(f"economy: the card's Gumbel search of the first {n} games differs from the CPU's")
    dpi = float((res_d.improved_pi[:n].cpu() - res_c.improved_pi).abs().max())
    print(f"[economy] Gumbel search, MLPNet {MLP_HIDDEN} order-free, B={ECO_B}, {ECO_SIMS} sims: "
          f"the first {n} games on the CPU give identical root counts and actions, pi' within "
          f"{dpi:.3g} | {card}", flush=True)
    del res, res_d, gsearch
    marks.append(("(a) CPU", time.perf_counter()))

    # ---- (b) one economy fixed-scan self-play call -----------------------
    _, eco = preset("economy", SEED)
    sp = dataclasses.replace(eco.selfplay, batch_size=ECO_B, max_moves=ECO_SCAN_MOVES)
    play = make_selfplay_fn(c4, eco.mcts, sp, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    model = resnet()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    (traj, stats), sec = timed_sync(
        lambda: play(model, lambda t: sample_draws(gen, ECO_B, A, None, dev)))
    no_launches("fixed scan")
    valid = traj.valid
    sums = traj.pi[valid].sum(dim=-1)
    if not bool(((sums - 1.0).abs() <= 1e-5).all()):
        fail("economy fixed scan: a valid row's improved policy does not sum to 1")
    values = traj.value[valid]
    if not bool(((values == 1) | (values == -1) | (values == 0)).all()):
        fail("economy fixed scan: a valid row's value is not +-1 or 0")
    moves = int(stats.num_moves.sum())
    steps = traj.pi.shape[0]
    print(f"[economy] the economy preset's fixed scan (Gumbel, {eco.mcts.num_sims} sims, "
          f"AZResNet-64x5 bf16), B={ECO_B}, {steps} steps: one call {sec:.3f} s "
          f"({1e3 * sec / steps:.1f} ms a step, {1e3 * sec / (steps * eco.mcts.num_sims):.2f} ms a "
          f"simulation), {moves} moves ({moves / sec:.1f} moves/s), {int(valid.sum())} valid "
          f"samples, {int(stats.done.sum())} of {ECO_B} games done; pi' rows sum to 1 and values "
          f"are +-1/0 on every valid row; no kernel launched; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB | {card}", flush=True)
    del traj, stats, play
    marks.append(("(b)", time.perf_counter()))

    # ---- (c) playout-cap randomization on the mlp preset -----------------
    _, mlp_cfg = preset("mlp", SEED)
    mcfg = dataclasses.replace(mlp_cfg.mcts, num_sims=PCR_SIMS)
    sp = dataclasses.replace(mlp_cfg.selfplay, batch_size=PCR_B, full_search_prob=PCR_P,
                             cheap_sims=PCR_CHEAP)
    n_full = int(round(PCR_P * PCR_B))
    play = make_selfplay_fn(c4, mcfg, sp, device=dev, record_states=True)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    draws = [sample_draws(gen, PCR_B, A, mcfg.dirichlet_alpha, dev, permute=True)
             for _ in range(c4.max_moves)]
    kernels.reset_launch_counts()
    (traj, stats, states), sec = timed_sync(lambda: play(mlp, lambda t: draws[t]))
    got = dict(kernels.launch_counts())
    steps = traj.pi.shape[0]
    if got != launches_of(kernels, fused_mlp=2 * steps):
        fail(f"economy PCR: launches {launched(got)}, want 2 fused_mlp a step and no other")
    out["fused_mlp"] = got["fused_mlp"]
    sums = traj.pi.sum(dim=-1)
    full = sums > 0.5
    if not bool(((sums[full] - 1.0).abs() <= 1e-5).all() and (traj.pi[~full] == 0).all()):
        fail("economy PCR: a row is neither a distribution nor all zero")
    per_step = full.sum(dim=1)
    live = torch.arange(steps, device=dev)[:, None] < stats.num_moves[None, :]
    live_rows = (full & live).sum(dim=1)
    all_live = live.all(dim=1)
    if not bool((per_step == n_full).all()) or not bool((live_rows <= n_full).all()) \
            or not bool((live_rows[all_live] == n_full).all()):
        fail(f"economy PCR: policy rows a step {per_step.tolist()} (among live games "
             f"{live_rows.tolist()}), want {n_full}")
    for t in range(steps):
        if not bool(full[t][draws[t].perm[:n_full]].all()):
            fail(f"economy PCR: step {t}'s policy rows are not its permutation's first {n_full}")
    vo = int((traj.valid & ~full).sum())
    print(f"[economy] PCR on the mlp preset (MLPNet {MLP_HIDDEN} order-free, B={PCR_B}, "
          f"{PCR_SIMS} sims, full_search_prob {PCR_P}, cheap_sims {PCR_CHEAP}): one call "
          f"{sec:.3f} s, {steps} steps; {got['fused_mlp']} az_fused_mlp launches (2 a step) and no "
          f"other kernel; exactly {n_full} policy rows a step, the permutation's first {n_full} "
          f"(among live games: {int(live_rows[0])} at step 0, {int(live_rows[all_live].numel())} "
          f"steps with every game live, {int(live_rows[-1])} at the last); {int(traj.valid.sum())} "
          f"valid samples, {vo} of them value-only | {card}", flush=True)
    # the two sub-batch searches of step PCR_CHECK_STEP, through the kernel
    # and through its plain version: counts and root W bit-equal
    weights = make_apply_fn(mlp).kernel_eval_factory(FlatOps())
    sub = states[PCR_CHECK_STEP][draws[PCR_CHECK_STEP].perm]
    cheap_cfg = dataclasses.replace(mcfg, num_sims=PCR_CHEAP, max_nodes=None, dirichlet_alpha=None)
    for label, roots_s, scfg in (("full", sub[:n_full], mcfg), ("cheap", sub[n_full:], cheap_cfg)):
        f_args = fused_mlp_args(c4, make_apply_fn(mlp), weights, roots_s, scfg)
        ck, wk = kernels.fused_mlp(*f_args)
        n_all, w_all, _ = plain_fused_mlp(f_args, scfg)()
        if not (bit_equal(ck, n_all[:, :, 0]) and bit_equal(wk, w_all[:, :, 0])):
            fail(f"economy PCR: the {label} sub-batch's az_fused_mlp differs from its plain version")
        print(f"[economy] PCR step {PCR_CHECK_STEP}'s {label} sub-batch (B={roots_s.shape[0]}, "
              f"{scfg.num_sims} sims, {scfg.nodes} nodes): az_fused_mlp bit-equal to "
              f"fused_mlp_search (counts and root W)", flush=True)
    del traj, stats, states, play, draws
    marks.append(("(c)", time.perf_counter()))

    # ---- (d) a reanalyze pass on the hybrid route ------------------------
    model = resnet()
    scan_cfg = MCTSConfig(num_sims=RZ_SCAN_SIMS, max_depth=MAX_DEPTH)
    play = make_selfplay_fn(c4, scan_cfg, SelfPlayConfig(batch_size=RZ_SCAN_B,
                                                         temp_threshold=TEMP_THRESHOLD),
                            device=dev, record_states=True)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    (traj, _, states), scan_s = timed_sync(
        lambda: play(model, lambda t: sample_draws(gen, RZ_SCAN_B, A, None, dev)))
    store = position_insert(position_init(c4, RZ_CAP, dev), states, traj.value, traj.valid, 0)
    rz_cfg = ReanalyzeConfig(batch_size=RZ_R, capacity=RZ_CAP, num_sims=RZ_SIMS)
    rz_mcts = MCTSConfig(num_sims=RZ_SIMS, max_depth=MAX_DEPTH, dirichlet_alpha=1.0)
    reanalyze = make_reanalyze_fn(c4, rz_mcts, rz_cfg)
    idx = torch.randint(0, max(store.size, 1), (RZ_R,), generator=gen, device=dev)
    kernels.reset_launch_counts()
    (rz_traj, num, age), sec = timed_sync(lambda: reanalyze(model, store, idx, iteration=1))
    got = dict(kernels.launch_counts())
    want = {"descend": RZ_SIMS, "merge": RZ_SIMS, "refresh": 1}
    if got != launches_of(kernels, **want):
        fail(f"economy reanalyze: launches {launched(got)} != {want}")
    out.update({k: got[k] for k in want})
    search_cfg = dataclasses.replace(rz_mcts, dirichlet_alpha=None)
    c_plain = hybrid.make_hybrid_root_fn(c4, make_apply_fn(model), search_cfg, kernels=PLAIN)(
        store.states[idx])
    pi_plain = c_plain / c_plain.sum(dim=-1, keepdim=True).clamp(min=1.0)
    if not torch.equal(rz_traj.pi[0], pi_plain):
        fail("economy reanalyze: the pass through the kernels differs from the plain versions")
    conserved("economy reanalyze", c4, store.states[idx], c_plain, RZ_SIMS)
    if num != RZ_R or age != 1.0 or not bool(rz_traj.valid.all()):
        fail(f"economy reanalyze: {num} rows refreshed, age {age}")
    print(f"[economy] reanalyze: {store.size} positions recorded (record_states) from a fixed scan "
          f"of the AZResNet-64x5 (B={RZ_SCAN_B}, {RZ_SCAN_SIMS} sims, {scan_s:.3f} s); a pass of "
          f"{RZ_R} re-searched at {RZ_SIMS} sims on the hybrid route: {sec:.3f} s, launches "
          f"{launched(got)}; the same pass through the plain versions gives identical counts "
          f"(the seed on fresh planes); {num} rows, mean age {age} | {card}", flush=True)
    del traj, states, store, rz_traj, play
    marks.append(("(d)", time.perf_counter()))

    # ---- (e) one cut economy coach iteration with reanalyze --------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_economy_") as ckdir:
        _, eco = preset("economy", SEED, ckdir)
        cfg = dataclasses.replace(
            eco,
            mcts=dataclasses.replace(eco.mcts, num_sims=ECO_COACH_SIMS),
            selfplay=dataclasses.replace(eco.selfplay, batch_size=ECO_COACH_B),
            train=dataclasses.replace(eco.train, steps_per_iteration=ECO_COACH_STEPS),
            arena=dataclasses.replace(eco.arena, num_games=ECO_COACH_GAMES,
                                      num_sims=ECO_COACH_GATE_SIMS, anchor_interval=None),
            reanalyze=ReanalyzeConfig(batch_size=ECO_COACH_RZ,
                                      capacity=eco.replay.capacity // c4.num_symmetries),
            checkpoint_interval=1)
        print(f"[economy] economy preset: cut self-play B {eco.selfplay.batch_size} -> "
              f"{ECO_COACH_B} at {eco.mcts.num_sims} -> {ECO_COACH_SIMS} sims, train steps "
              f"{eco.train.steps_per_iteration} -> {ECO_COACH_STEPS}, gate {eco.arena.num_games} "
              f"games at {eco.arena.num_sims} -> {ECO_COACH_GAMES} at {ECO_COACH_GATE_SIMS} sims, "
              f"no anchored pass (the preset's own first)", flush=True)
        F = math.prod(c4.feature_shape)
        ring_bytes = cfg.replay.capacity * (F + A + 1) * F32
        pos_bytes = cfg.reanalyze.capacity * (math.prod(c4.init(1, "cpu").shape[1:]) + 2 * 4)
        print(f"[economy] reckoned before the run: the economy replay ring {cfg.replay.capacity} "
              f"rows x {F + A + 1} f32 = {ring_bytes} bytes ({ring_bytes / 2**20:.1f} MiB), the "
              f"position ring {cfg.reanalyze.capacity} states x (42 int8 + value + stamp) = "
              f"{pos_bytes} bytes ({pos_bytes / 2**20:.1f} MiB)", flush=True)
        torch.cuda.reset_peak_memory_stats()
        coach = Coach(c4, resnet(), cfg, device=dev)
        kernels.reset_launch_counts()
        (recs, sec) = timed_sync(lambda: coach.learn(1))
        got = dict(kernels.launch_counts())
        rec = recs[0]
        check_record("economy", rec, cfg.arena.num_games, False)
        if got != launches_of(kernels):
            fail(f"economy coach: launches {launched(got)} (Gumbel self-play, reanalyze and gate "
                 f"run on the dense engine)")
        if rec["reanalyzed"] != ECO_COACH_RZ or rec["reanalyze_age_mean"] != 0.0:
            fail(f"economy coach: reanalyze record {rec}")
        print_record("economy", "economy preset (cut, reanalyze on)", rec, sec, got, card)
        nbytes = os.path.getsize(os.path.join(ckdir, "ckpt_000001"))
        resumed, resume_s = timed_sync(lambda: Coach(c4, resnet(), cfg, device=dev))
        diff = bits_differ(coach_state(coach), coach_state(resumed))
        if diff:
            fail(f"economy coach: the resumed coach differs from the live one at {diff}")
        print(f"[economy] checkpoint 1: {nbytes} bytes ({nbytes / 2**20:.1f} MiB) with the "
              f"{coach.replay.size}-row replay ring and the {coach.positions.size}-position ring; a "
              f"new Coach resuming from it in {resume_s:.3f} s is bit-equal on both rings, weights, "
              f"Adam moments, generator and counters | {card}", flush=True)
        del coach, resumed
        torch.cuda.empty_cache()
    marks.append(("(e)", time.perf_counter()))

    # ---- (f) analyze --engine gumbel in this process ---------------------
    with tempfile.TemporaryDirectory() as ckpt:
        save_checkpoint(ckpt, 1, {"incumbent": {"model": convert_az_resnet(
            random_az_resnet_variables(A, 64, 5, seed=SEED)).state_dict()}})
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = analyze.main(["--engine", "gumbel", "--moves", "3 0 4 0 5 0", "--sims", "200",
                               "--model", "resnet", "--checkpoint-dir", ckpt,
                               *(["--cpu"] if dev.type == "cpu" else [])])
        text = buf.getvalue()
        if rc != 0 or "gumbel recommendation (eval mode): " not in text:
            fail(f"analyze --engine gumbel returned {rc}: {text[-500:]}")
        rec_move = int(text.split("gumbel recommendation (eval mode): ", 1)[1].split()[0])
        if rec_move not in (2, 6):
            fail(f"analyze --engine gumbel recommends {rec_move}, not an immediate win (2, 6)")
        print(f"[economy] analyze --engine gumbel --moves '3 0 4 0 5 0' --sims 200 (a seeded "
              f"AZResNet-64x5 checkpoint), in this process: {time.perf_counter() - t0:.1f} s, "
              f"recommends {rec_move}, an immediate win", flush=True)
    marks.append(("(f)", time.perf_counter()))
    print("[economy] phase 20: " + ", ".join(f"{name} {t - t0:.1f} s" for (_, t0), (name, t)
                                            in zip(marks, marks[1:]))
          + f"; {marks[-1][1] - marks[0][1]:.1f} s in all | {card}", flush=True)
    return out


def tt_phase(card: str, dev=None) -> None:
    """Phase 21: the transposition-DAG engine (see the module docstring),
    on ``dev`` (the card). Plain PyTorch: the counters are set to 0 just
    before each of its searches and read just after, and must read 0."""
    import contextlib
    import io

    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.arena import make_arena_fn, tie_draws_from
    from alphazero_tpu_torch.config import MCTSConfig, SelfPlayConfig
    from alphazero_tpu_torch.examples import analyze
    from alphazero_tpu_torch.games import ConnectFour, Othello
    from alphazero_tpu_torch.mcts import make_search_fn, make_tt_search_fn
    from alphazero_tpu_torch.models import (
        convert_mlp,
        make_apply_fn,
        make_uniform_model,
        order_free_mlp_variables,
    )
    from alphazero_tpu_torch.ops import sample_draws
    from alphazero_tpu_torch.selfplay import make_selfplay_fn

    dev = dev or torch.device("cuda", 0)
    c4, oth = ConnectFour(), Othello()
    marks = [("start", time.perf_counter())]

    def tt(game, apply_fn, sims: int, depth: int):
        return make_tt_search_fn(game, apply_fn, MCTSConfig(num_sims=sims, max_depth=depth,
                                                            transposition=True))

    def no_launches(tag: str, run):
        """``run()`` with the counters at 0 just before and read just after:
        the engine launches no kernel. Returns its output and seconds."""
        kernels.reset_launch_counts()
        out, sec = timed_sync(run)
        if kernels.launch_counts() != launches_of(kernels):
            fail(f"tt {tag} launched kernels {launched(kernels.launch_counts())}")
        return out, sec

    def same_as_cpu(tag: str, game, apply_cpu, sims: int, depth: int, roots, tree, n: int):
        """The first ``n`` games searched again on the CPU: root counts and
        links identical. Returns the CPU's seconds."""
        cpu_tree, sec = no_launches(f"{tag} on the CPU",
                                    lambda: tt(game, apply_cpu, sims, depth)(roots[:n].cpu()))
        if not (torch.equal(tree.root_counts()[:n].cpu(), cpu_tree.root_counts())
                and torch.equal(tree.dedup[:n].cpu(), cpu_tree.dedup)):
            fail(f"tt {tag}: the card's first {n} games differ from the CPU's")
        return sec

    # ---- (a) the TPU goldens ---------------------------------------------
    uni_c4 = make_uniform_model(c4).apply_fn
    goldens = read_goldens("tpu_goldens.json")
    roots = fused_test_positions(c4, TT_GOLDEN_B, 6, 17, dev)
    tree, sec = no_launches("goldens", lambda: tt(c4, uni_c4, TT_GOLDEN_SIMS, MAX_DEPTH)(roots))
    counts = tree.root_counts()
    if not (counts[:8].cpu().tolist() == goldens["tt_c4_uniform_counts_head"]
            and tree.dedup[:16].cpu().tolist() == goldens["tt_c4_uniform_dedup_head"]
            and float(counts.sum(-1).max()) == TT_GOLDEN_SIMS):
        fail("tt goldens: tt_c4_uniform_counts_head / dedup_head not reproduced")
    print(f"[tt] tests/tpu_goldens.json tt_c4_uniform_counts_head and tt_c4_uniform_dedup_head "
          f"reproduced (B={TT_GOLDEN_B}, {TT_GOLDEN_SIMS} sims, max_depth {MAX_DEPTH}) in "
          f"{1e3 * sec:.1f} ms, no kernel launched", flush=True)
    marks.append(("(a)", time.perf_counter()))

    # ---- (b) a deep search at bench_tt's defaults -------------------------
    roots = random_positions(c4, TT_B, 30, SEED, dev)
    search = tt(c4, uni_c4, TT_SIMS, MAX_DEPTH)
    times = []
    for _ in range(2):
        torch.cuda.reset_peak_memory_stats()
        tree, sec = no_launches("deep search", lambda: search(roots))
        times.append(1e3 * sec)
    peak = torch.cuda.max_memory_allocated()
    conserved("tt deep search", c4, roots, tree.root_counts(), TT_SIMS)
    links = tree.dedup
    if not bool((links > 0).any()):
        fail("tt deep search: no transposition link made")
    cpu_s = same_as_cpu("deep search", c4, make_uniform_model(c4).apply_fn, TT_SIMS, MAX_DEPTH,
                        roots, tree, TT_CPU_B)
    dense = make_search_fn(c4, uni_c4, MCTSConfig(num_sims=TT_SIMS, max_depth=MAX_DEPTH))
    dense_ms = []
    for _ in range(2):
        _, sec = no_launches("dense search", lambda: dense(roots))
        dense_ms.append(1e3 * sec)
    print(f"[tt] deep search, C4 uniform, B={TT_B}, {TT_SIMS} sims, max_depth {MAX_DEPTH}: "
          f"{times[0]:.1f}/{times[1]:.1f} ms a search ({times[1] / TT_SIMS:.3f} ms a simulation), "
          f"no kernel launched; {int(links.sum())} links in all ({float(links.float().mean()):.1f} "
          f"a game, {int((links > 0).sum())} of {TT_B} games), {int(tree.count.sum())} nodes "
          f"materialised ({float(tree.count.float().mean()):.1f} a game); peak memory "
          f"{peak / 2**30:.3f} GiB; the first {TT_CPU_B} games on the CPU ({cpu_s:.1f} s): "
          f"identical counts and links | the dense engine on the same roots "
          f"{dense_ms[0]:.1f}/{dense_ms[1]:.1f} ms a search: the DAG costs "
          f"{times[1] / dense_ms[1]:.2f}x | {card}", flush=True)
    marks.append(("(b) searches", time.perf_counter()))
    n_prof = TT_PROFILED_SIMS
    wall, busy, top, calls, syncs = profile_step(lambda: search(roots, num_sims=n_prof))
    print(f"[tt] one profiled deep-search call of {n_prof} sims: {wall:.3f} ms wall (profiler "
          f"on), device busy {busy:.3f} ms, idle {100 * (1 - busy / wall):.1f}%, {calls} host "
          f"launch calls ({calls / n_prof:.1f} a simulation), {syncs} host synchronisations "
          f"({syncs / n_prof:.2f} a simulation: one a descent level) | {card}", flush=True)
    for name, ms, count in top[:6]:
        print(f"[tt]   {ms:9.3f} ms {count:6d}x {name[:100]}", flush=True)
    del tree, search, dense
    marks.append(("(b) profile", time.perf_counter()))

    # ---- (c) Othello -------------------------------------------------------
    uni_oth = make_uniform_model(oth).apply_fn
    roots = random_positions(oth, TT_OTH_B, 40, SEED, dev)
    tree, sec = no_launches("Othello", lambda: tt(oth, uni_oth, TT_OTH_SIMS, TT_OTH_DEPTH)(roots))
    conserved("tt Othello", oth, roots, tree.root_counts(), TT_OTH_SIMS)
    cpu_s = same_as_cpu("Othello", oth, make_uniform_model(oth).apply_fn, TT_OTH_SIMS,
                        TT_OTH_DEPTH, roots, tree, TT_OTH_CPU_B)
    print(f"[tt] Othello uniform, B={TT_OTH_B}, {TT_OTH_SIMS} sims, max_depth {TT_OTH_DEPTH}: "
          f"{1e3 * sec:.1f} ms a search ({1e3 * sec / TT_OTH_SIMS:.3f} ms a simulation), "
          f"{int(tree.dedup.sum())} links, no kernel launched; the first {TT_OTH_CPU_B} games on "
          f"the CPU ({cpu_s:.1f} s): identical counts and links | {card}", flush=True)
    del tree
    marks.append(("(c)", time.perf_counter()))

    # ---- (d) an order-free MLPNet --------------------------------------------
    variables = order_free_mlp_variables(c4.num_actions, MLP_HIDDEN, seed=SEED)
    cpu_net = make_apply_fn(convert_mlp(variables))
    mlp = convert_mlp(variables).to(dev)
    mlp_net = make_apply_fn(mlp)
    roots = random_positions(c4, TT_MLP_B, 30, SEED + 1, dev)
    tree, sec = no_launches("MLP", lambda: tt(c4, mlp_net, TT_MLP_SIMS, MAX_DEPTH)(roots))
    conserved("tt MLP", c4, roots, tree.root_counts(), TT_MLP_SIMS)
    cpu_s = same_as_cpu("MLP", c4, cpu_net, TT_MLP_SIMS, MAX_DEPTH, roots, tree, TT_MLP_CPU_B)
    print(f"[tt] MLPNet {MLP_HIDDEN} order-free, C4, B={TT_MLP_B}, {TT_MLP_SIMS} sims: "
          f"{1e3 * sec:.1f} ms a search ({1e3 * sec / TT_MLP_SIMS:.3f} ms a simulation), "
          f"{int(tree.dedup.sum())} links, no kernel launched; the first {TT_MLP_CPU_B} games on "
          f"the CPU ({cpu_s:.1f} s; cut from all {TT_MLP_B}): identical counts and "
          f"links | {card}", flush=True)
    del tree
    marks.append(("(d)", time.perf_counter()))

    # ---- (e) the routes: fixed scan, arena, analyze --engine tt ---------------
    scfg = MCTSConfig(num_sims=TT_SCAN_SIMS, max_depth=MAX_DEPTH, dirichlet_alpha=1.0,
                      transposition=True)
    play = make_selfplay_fn(c4, scfg, SelfPlayConfig(batch_size=TT_SCAN_B,
                                                    temp_threshold=TEMP_THRESHOLD), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    (traj, stats), sec = no_launches("fixed scan", lambda: play(
        make_uniform_model(c4), lambda t: sample_draws(gen, TT_SCAN_B, c4.num_actions, 1.0, dev)))
    valid = traj.valid
    if not bool(((traj.pi[valid].sum(dim=-1) - 1.0).abs() <= 1e-5).all()):
        fail("tt fixed scan: a valid row's target does not sum to 1")
    moves = int(stats.num_moves.sum())
    print(f"[tt] the transposition fixed scan, C4 uniform, B={TT_SCAN_B}, {TT_SCAN_SIMS} sims, "
          f"Dirichlet 1.0: one call {sec:.3f} s, {moves} moves ({moves / sec:.1f} moves/s), "
          f"{int(valid.sum())} valid samples, {int(stats.done.sum())} of {TT_SCAN_B} games done; "
          f"no kernel launched | {card}", flush=True)
    del traj, stats, play
    acfg = MCTSConfig(num_sims=TT_ARENA_SIMS, max_depth=MAX_DEPTH, transposition=True)
    ties = tie_draws_from(torch.Generator(device=dev).manual_seed(SEED), TT_ARENA_GAMES,
                          c4.num_actions, dev)
    result, sec = no_launches("arena", lambda: make_arena_fn(
        c4, acfg, TT_ARENA_GAMES, device=dev)(mlp, make_uniform_model(c4), ties))
    if result.cand_wins + result.inc_wins + result.draws + result.unfinished != TT_ARENA_GAMES \
            or result.unfinished:
        fail(f"tt arena: {result}")
    print(f"[tt] a transposition arena, MLPNet {MLP_HIDDEN} order-free against the uniform model, "
          f"{TT_ARENA_GAMES} games at {TT_ARENA_SIMS} sims: {tuple(result)} (wins, losses, draws, "
          f"unfinished) in {sec:.1f} s, no kernel launched | {card}", flush=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        (rc, sec) = no_launches("analyze", lambda: analyze.main(
            ["--engine", "tt", "--sims", "400", *(["--cpu"] if dev.type == "cpu" else [])]))
    text = buf.getvalue()
    if rc != 0 or "transposition links made: " not in text:
        fail(f"analyze --engine tt returned {rc}: {text[-500:]}")
    made = int(text.split("transposition links made: ", 1)[1].split()[0])
    best = text.rsplit("search best move: ", 1)[1].strip()
    if made <= 0:
        fail("analyze --engine tt --sims 400 made no transposition link")
    print(f"[tt] analyze --engine tt --sims 400 from the initial position, in this process: "
          f"{sec:.1f} s, {made} transposition links, search best move {best}", flush=True)
    marks.append(("(e)", time.perf_counter()))
    print("[tt] phase 21: " + ", ".join(f"{name} {t - t0:.1f} s" for (_, t0), (name, t)
                                       in zip(marks, marks[1:]))
          + f"; {marks[-1][1] - marks[0][1]:.1f} s in all | {card}", flush=True)


def par_setup(flags, order_free: bool = False):
    """``(game, model, cfg)`` of the multi-process CLI's flags and one
    iteration, through its ``build_game_and_model`` and ``build_cfg``; an
    MLPNet with ``order_free`` takes ``order_free_mlp_variables``."""
    from alphazero_tpu_torch.examples import train_multihost as tm
    from alphazero_tpu_torch.models import convert_mlp, order_free_mlp_variables

    args = tm.parse_args(["--coordinator", "unused", "--num-processes", "1", "--process-id", "0",
                          *flags, "--iterations", "1"])
    game, model = tm.build_game_and_model(args)
    if order_free:
        model = convert_mlp(order_free_mlp_variables(game.num_actions, model.hidden, seed=SEED),
                            torch.bfloat16)
    return game, model, tm.build_cfg(args)


def par_same_record(tag: str, got: dict, want: dict, losses: bool = True) -> float:
    """A mesh coach's record against the one-process one: the integers
    equal and, with ``losses``, the losses within PAR_LOSS_ATOL. Returns
    the larger of the two losses' differences."""
    for k in PAR_INTS:
        if got[k] != want[k]:
            fail(f"{tag}: {k} {got[k]} where the one-process coach has {want[k]}")
    diff = max(abs(got[k] - want[k]) for k in ("loss_first", "loss_last"))
    if losses and not diff <= PAR_LOSS_ATOL:
        fail(f"{tag}: the losses {got['loss_first']}, {got['loss_last']} where the one-process "
             f"coach has {want['loss_first']}, {want['loss_last']}")
    return diff


def par_phases(rec: dict) -> str:
    return ", ".join(f"{k[2:]} {v:.3f} s" for k, v in rec.items() if k.startswith("t_"))


PAR_KERNELS = ("fused_mlp", "descend", "merge", "refresh")


def par_learner(game, cfg, hidden, ring, mesh, dev):
    """Phase 22(b)/(c)'s learner witness: the train phase of ``cfg`` (64
    steps of 256 rows) on the coach's ``ring`` from one generator seed,
    the order-free MLPNet's hidden layers in f32 and in bf16, over
    ``mesh`` and, on rank 0, in one process. Returns (rank 0) the largest
    |dloss| over the steps by dtype: f32 shows the sharded learner's sums,
    bf16 adds each rank's bf16 rounding of its weight gradients."""
    from alphazero_tpu_torch.models import convert_mlp, order_free_mlp_variables
    from alphazero_tpu_torch.train import init_train_state, make_train_phase

    out = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        losses = []
        for m in (mesh, None) if mesh.rank == 0 else (mesh,):
            model = convert_mlp(order_free_mlp_variables(game.num_actions, hidden, seed=SEED),
                                dt).to(dev)
            phase = make_train_phase(cfg.train, cfg.train.steps_per_iteration, game, m)
            _, got = phase(init_train_state(model, cfg.train), ring,
                           torch.Generator(device=dev).manual_seed(SEED))
            losses.append(got)
        if mesh.rank == 0:
            out[name] = float((losses[0] - losses[1]).abs().max())
    return out


def parallel_rank(argv) -> int:
    """One rank of phase 22(b) and (c), spawned by ``parallel_phase``: the
    order-free MLPNet coach iteration on the mesh, then one sharded
    AZResNet-64x5 search of phase 3's roots; rank 0 prints one JSON line
    (the record, every rank's launches and seconds, the search's agreement
    with the unsharded search)."""
    import argparse

    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.coach import Coach
    from alphazero_tpu_torch.config import MCTSConfig
    from alphazero_tpu_torch.games import ConnectFour
    from alphazero_tpu_torch.mcts import hybrid
    from alphazero_tpu_torch.models import (
        convert_az_resnet,
        make_apply_fn,
        random_az_resnet_variables,
    )
    from alphazero_tpu_torch.ops import sample_draws
    from alphazero_tpu_torch.parallel import batch_sharding, distributed, make_mesh

    ap = argparse.ArgumentParser()
    for flag in ("--coordinator", "--platform", "--backend", "--go"):
        ap.add_argument(flag)
    for flag in ("--num-processes", "--process-id"):
        ap.add_argument(flag, type=int)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = distributed.initialize(args.coordinator, args.num_processes, args.process_id,
                                 platform=args.platform, backend=args.backend)
    try:
        mesh = make_mesh()
        kernels.library()
        game, model, cfg = par_setup(PAR_MLP, order_free=True)
        coach = Coach(game, model, cfg, mesh=mesh)
        while args.go is not None and not os.path.exists(args.go):
            time.sleep(0.05)
        distributed.barrier(mesh)
        kernels.reset_launch_counts()
        rec, sec = timed_sync(coach.run_iteration)
        mlp_counts = dict(kernels.launch_counts())
        learner, learner_s = timed_sync(lambda: par_learner(game, cfg, model.hidden,
                                                            coach.replay, mesh, dev))

        A = game.num_actions
        apply_fn = make_apply_fn(convert_az_resnet(random_az_resnet_variables(
            A, 64, 5, seed=SEED), dtype=torch.bfloat16).to(dev))
        cfg_full = MCTSConfig(num_sims=SIMS, max_depth=MAX_DEPTH, dirichlet_alpha=1.0)
        roots = random_positions(game, B, 30, SEED, dev)
        noise = sample_draws(torch.Generator(device=dev).manual_seed(SEED), B, A, 1.0,
                             dev).dirichlet
        rows = batch_sharding(mesh, B, "search batch")
        search = hybrid.make_hybrid_root_fn(game, apply_fn, cfg_full)
        kernels.reset_launch_counts()
        counts, search_s = timed_sync(lambda: search(roots[rows], noise[rows]))
        search_counts = dict(kernels.launch_counts())
        counts = distributed.all_gather(counts, mesh)
        mine = {k: mlp_counts[k] + search_counts[k] for k in PAR_KERNELS}
        every = distributed.all_gather(torch.tensor(
            [[mine[k] for k in PAR_KERNELS] + [sec, search_s]], dtype=torch.float64, device=dev),
            mesh).tolist()
        out = {"record": rec, "launches": {k: [int(r[i]) for r in every]
                                           for i, k in enumerate(PAR_KERNELS)},
               "coach_s": [r[-2] for r in every], "search_s": [r[-1] for r in every]}
        if mesh.rank == 0:
            whole, whole_s = timed_sync(lambda: search(roots, noise))
            live = ~game.terminal(roots)[0]
            if not bool((counts.sum(dim=1)[live] == SIMS).all()):
                fail("parallel: the sharded search's live counts do not sum to the budget")
            same, dpi = search_agreement("parallel: the sharded ResNet search", counts, whole)
            out["search"] = {"same": same, "dpi": dpi, "whole_s": whole_s,
                             "equal": bool(torch.equal(counts, whole))}
            out["learner"] = {**learner, "seconds": learner_s}
            print(json.dumps(out), flush=True)
        distributed.barrier(mesh)
    finally:
        distributed.shutdown()
    return 0


def par_spawn(backend: str, go=None) -> list:
    """Phase 22(b)/(c)'s two ranks over ``backend`` (``parallel_rank``):
    rank 0's records. With ``go``, the ranks start up and then wait for
    that file before their checks, so their start-up overlaps (a)."""
    from alphazero_tpu_torch.parallel.distributed import launch_local_multihost

    return launch_local_multihost(
        [] if go is None else ["--go", go], num_processes=2, timeout=PAR_TIMEOUT,
        platform=None, backend=backend, entry=[os.path.abspath(__file__), "--parallel-rank"])


def par_pair(card: str, tag: str, backend: str, want: dict, pending=None) -> dict:
    """Phase 22(b)/(c)'s two ranks over ``backend`` (spawned here, or the
    future ``pending`` of ranks started earlier): the MLPNet iteration
    against the one-process record ``want``, the sharded search's gate
    (in the ranks), each rank's launches and seconds printed. Returns the
    launches, by kernel and rank."""
    t0 = time.perf_counter()
    (out,) = par_spawn(backend) if pending is None else pending.result()
    sec = time.perf_counter() - t0
    rec = out["record"]
    check_record(tag, rec, 64, False)
    # the integers; the losses are printed, not gated: each rank rounds its
    # bf16 weight gradients before the ranks' sum (the learner witness
    # below holds the same steps in f32 to PAR_LOSS_ATOL)
    diff = par_same_record(f"{tag}: the two-rank MLPNet iteration", rec, want, losses=False)
    lrn = out["learner"]
    if not lrn["f32"] <= PAR_LOSS_ATOL:
        fail(f"{tag}: the two-rank f32 learner's losses are {lrn['f32']} from the one-process "
             f"learner's (bf16: {lrn['bf16']})")
    for k in PAR_KERNELS:
        if 0 in out["launches"][k]:
            fail(f"{tag}: a rank launched no {k}: {out['launches']}")
    srch = out["search"]
    print(f"[parallel] ({tag}) two ranks over {backend}, "
          f"{'spawned and done' if pending is None else 'started during (a), done'} in "
          f"{sec:.3f} s: the order-free "
          f"MLPNet (256, 256) iteration (B=1024, 100 sims) equal to the one-process one in "
          f"the integers (losses {rec['loss_first']:.6f} -> {rec['loss_last']:.6f}, "
          f"{want['loss_first']:.6f} -> {want['loss_last']:.6f} in one process: {diff:.3g} "
          f"apart), "
          f"{'/'.join(f'{s:.3f}' for s in out['coach_s'])} s an iteration by rank | "
          f"{par_phases(rec)} | the learner on that ring (64 steps of 256, one seed) against "
          f"one process: max |dloss| {lrn['f32']:.3g} with f32 hidden layers (<= "
          f"{PAR_LOSS_ATOL}), {lrn['bf16']:.3g} with bf16 ({lrn['seconds']:.3f} s) "
          f"| the sharded AZResNet-64x5 search of phase 3's roots (B={B}, {SIMS} sims, "
          f"{B // 2} a rank): {srch['same']:.4f} of games identical to the unsharded search "
          f"({'all counts equal' if srch['equal'] else 'not all equal'}), max |dpi| "
          f"{srch['dpi']:.4f}; {'/'.join(f'{1e3 * s:.3f}' for s in out['search_s'])} ms by rank "
          f"against {1e3 * srch['whole_s']:.3f} ms unsharded | launches by rank "
          f"{out['launches']} | {card}", flush=True)
    return out["launches"]


def par_iteration(card: str, tag: str, flags, need, mesh, label: str) -> dict:
    """One coach iteration of the CLI's ``flags`` (the MLPNet order-free)
    on ``mesh`` or in one process, on cuda:0: its record, printed."""
    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.coach import Coach

    game, model, cfg = par_setup(flags, order_free=tag == "mlp")
    coach = Coach(game, model, cfg, mesh=mesh, device=torch.device("cuda", 0))
    kernels.reset_launch_counts()
    rec, sec = timed_sync(coach.run_iteration)
    counts = dict(kernels.launch_counts())
    if any(counts[k] == 0 for k in need):
        fail(f"parallel: the {tag} iteration ({label}) launched {counts}")
    check_record("parallel", rec, cfg.arena.num_games, False)
    print(f"[parallel] (a) {tag} coach iteration, {label}: {sec:.3f} s | {par_phases(rec)} | "
          f"gate {rec['arena_wins']}-{rec['arena_losses']}-{rec['arena_draws']} | loss "
          f"{rec['loss_first']:.6f} -> {rec['loss_last']:.6f} | ring {rec['replay_size']} rows "
          f"| launches {launched(counts)} | {card}", flush=True)
    del coach, model
    torch.cuda.empty_cache()
    return rec


def parallel_phase(card: str, cards_only: bool = False) -> dict:
    """Phase 22 (see the module docstring). Returns each rank's launches
    of (b), by kernel. ``cards_only`` runs the one-process MLPNet
    iteration, (c) and (d) alone (``--parallel-cards``: a machine of
    several cards)."""
    import concurrent.futures
    import shutil
    import socket
    import tempfile

    from alphazero_tpu_torch.models import AZResNet
    from alphazero_tpu_torch.parallel import distributed, make_mesh
    from alphazero_tpu_torch.parallel.distributed import launch_local_multihost

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    if cards_only:
        want = par_iteration(card, "mlp", PAR_MLP, ("fused_mlp",), None, "one process")
        return par_cards(card, want, t_phase)

    # (b)'s ranks start up now and wait for `go`, written once (a) is done
    go = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_go_"), "go")
    pool = concurrent.futures.ThreadPoolExecutor(1)
    pending = pool.submit(par_spawn, "gloo", go)

    # ---- (a) a world of one under NCCL -----------------------------------
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    if distributed.initialize(f"localhost:{port}", 1, 0, backend="nccl") != dev:
        fail("parallel: the world of one is not on cuda:0")
    records = {}
    try:
        mesh = make_mesh()
        x = torch.randn(B, 7, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
        for name, got in (("all_reduce", distributed.all_reduce(x, mesh)),
                          ("all_gather", distributed.all_gather(x, mesh, dim=1)),
                          ("broadcast", distributed.broadcast(x, mesh)),
                          ("all_gather bool", distributed.all_gather(x > 0, mesh)),
                          ("max", distributed.all_reduce(x, mesh, op="max"))):
            if not torch.equal(got, x > 0 if "bool" in name else x) or not got.is_cuda:
                fail(f"parallel: NCCL {name} of a world of one is not the identity")
        distributed.barrier(mesh)
        torch.manual_seed(SEED)
        net = AZResNet(7, channels=64, blocks=5, dtype=torch.float32).to(dev)
        feats = torch.rand(PAR_BN_B, 6, 7, 2, device=dev)
        start = {k: v.clone() for k, v in net.state_dict().items()}
        outs = []
        for m in (None, mesh):
            net.load_state_dict(start)
            probe = feats.clone().requires_grad_(True)
            net.zero_grad()
            logits, v = net(probe, train=True, bn_mesh=m)
            (logits.square().mean() + v.mean()).backward()
            outs.append([logits, v, probe.grad] + [p.grad for p in net.parameters()]
                        + [b.clone() for b in net.buffers()])
        # the forward and the running statistics bit for bit; the gradients
        # within PAR_GRAD_RTOL of each tensor's largest entry: the global
        # moments' autograd nodes change the order in which the engine sums
        # a tensor's incoming gradients
        n_grads = 3 + len(list(net.parameters()))
        fwd = [i for i, (a, b) in enumerate(zip(*outs)) if (i < 2 or i >= n_grads)
               and not bit_equal(a.float(), b.float())]
        if fwd:
            fail(f"parallel: the global-statistics BatchNorm of a world of one differs at {fwd}")
        rel = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                  for a, b in list(zip(*outs))[2:n_grads])
        same = sum(bit_equal(a, b) for a, b in list(zip(*outs))[2:n_grads])
        if not rel <= PAR_GRAD_RTOL:
            fail(f"parallel: the global-statistics BatchNorm's gradients differ by {rel} of "
                 f"their tensors' largest entries")
        print(f"[parallel] (a) NCCL world of one on {dev}: all_reduce (sum, max), all_gather "
              f"(f32, bool), broadcast, barrier on CUDA tensors the identity; the "
              f"global-statistics BatchNorm of AZResNet-64x5 in f32 (B={PAR_BN_B}): logits, "
              f"value and running statistics bit-equal to the mesh-less ones, the input and "
              f"parameter gradients {same} of {n_grads - 2} tensors bit-equal, the rest within "
              f"{rel:.3g} of each tensor's largest entry | {card}", flush=True)
        for tag, flags, need in (("mlp", PAR_MLP, ("fused_mlp",)),
                                 ("resnet", PAR_RESNET_CUT, ("descend", "merge", "refresh"))):
            got = {label: par_iteration(card, tag, flags, need, m, label)
                   for label, m in (("one process", None), ("world of one", mesh))}
            diff = par_same_record(f"parallel: the {tag} world of one", got["world of one"],
                                   got["one process"])
            print(f"[parallel] (a) {tag}: the world-of-one iteration equals the one-process "
                  f"one (integers; losses {diff:.3g} apart)", flush=True)
            records[tag] = got["one process"]
    finally:
        distributed.shutdown()
        open(go, "w").close()

    # ---- (b) two ranks sharing the card over gloo --------------------------
    per_rank = par_pair(card, "b", "gloo", records["mlp"], pending)
    pool.shutdown()
    shutil.rmtree(os.path.dirname(go))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_multihost_") as ckdir:
        flags = [*PAR_CLI, "--checkpoint-dir", ckdir]
        for iters, want in ((1, [1]), (1, [2])):
            recs, sec = timed_sync(lambda: launch_local_multihost(
                [*flags, "--iterations", iters], num_processes=2, timeout=PAR_TIMEOUT,
                platform=None, backend="gloo"))
            if [r["iteration"] for r in recs] != want:
                fail(f"parallel: the CLI pair printed iterations {[r['iteration'] for r in recs]}")
            for r in recs:
                check_record("parallel", r, 64, False)
                print(f"[parallel] (b) CLI pair over gloo ({' '.join(PAR_CLI)}), iteration "
                      f"{r['iteration']}: {par_phases(r)} | gate {r['arena_wins']}-"
                      f"{r['arena_losses']}-{r['arena_draws']} accepted {r['accepted']} | loss "
                      f"{r['loss_first']:.4f} -> {r['loss_last']:.4f} | ring {r['replay_size']} "
                      f"rows | {card}", flush=True)
            print(f"[parallel] (b) the CLI pair {'resumed and ran' if want == [2] else 'ran'} "
                  f"{len(recs)} iteration(s) in {sec:.3f} s (spawn included) | {card}",
                  flush=True)

    par_cards(card, records["mlp"], t_phase)
    return per_rank


def par_cards(card: str, want: dict, t_phase: float) -> dict:
    """Phase 22(c) and (d); returns (c)'s launches by kernel and rank."""
    per_rank = {}
    # ---- (c) two ranks over NCCL, one card each -----------------------------
    if torch.cuda.device_count() >= 2:
        per_rank = par_pair(card, "c", "nccl", want)
    else:
        print(f"[parallel] (c) did not run: {torch.cuda.device_count()} card on this machine, "
              f"and two ranks over NCCL need a card each | {card}", flush=True)

    # ---- (d) bench_scaling at its defaults (its main here; its ranks spawned)
    import contextlib
    import io

    from alphazero_tpu_torch import bench_scaling

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc, sec = timed_sync(lambda: bench_scaling.main([]))
    if rc != 0:
        fail(f"parallel: bench_scaling returned {rc}:\n{out.getvalue()}")
    lines = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.startswith("{")]
    summary = lines[-1]
    if (len(lines) != len([n for n in (1, 2, 4, 8) if n <= torch.cuda.device_count()]) + 1
            or summary["meaningful"] != (len(lines) > 2) or summary["backend"] != "cuda"):
        fail(f"parallel: bench_scaling printed {lines}")
    for ln in lines:
        print(f"[parallel] (d) bench_scaling: {json.dumps(ln)} | {card}", flush=True)
    print(f"[parallel] (d) bench_scaling took {sec:.3f} s; phase 22 "
          f"{time.perf_counter() - t_phase:.3f} s | {card}", flush=True)
    return per_rank


def wide_gomoku_checks(tag: str, game, apply_fn, batch: int, card: str, dev,
                       entries: dict = WIDE_ENTRIES,
                       what: str = "12-word boards; 24 actions a lane",
                       searches: bool = True) -> tuple:
    """Phase 23(a)-(c) (and 24(a)-(b)) on ``game`` (a board above 512
    cells): ``descend_gomoku`` and ``merge_dense`` and ``refresh_dense`` at
    the game's instances (``what``), then their round variants at
    K=ROUND_K, bit-equal to plain on planes of a plain search of ``batch``
    random roots (the seeds on its fresh planes) and timed in turns; then,
    with ``searches``, one K=1 and one K=ROUND_K search of the roots through
    the kernels and through the plain versions: equal root counts, and
    exactly one launch of each kernel a simulation (a round) and one seed.
    Returns ``(result entries, launches)`` keyed by ``entries``' names
    (no launches without ``searches``)."""
    import dataclasses

    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.config import MCTSConfig
    from alphazero_tpu_torch.mcts import hybrid
    from alphazero_tpu_torch.ops import sample_draws

    A = game.num_actions
    cfg = MCTSConfig(num_sims=SIMS, max_depth=GMK_MAX_DEPTH, dirichlet_alpha=GMK_DIRICHLET)
    roots = random_positions(game, batch, WIDE_MOVES, SEED, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    noise = sample_draws(gen, batch, A, GMK_DIRICHLET, dev).dirichlet

    # (a) K=1: the descend and the dense merge and seed
    d_args, m_args, r_args = capture_search_args(game, apply_fn, cfg, roots, noise)
    results = {}
    results["descend_gomoku"], edges, _ = descend_vs_plain("descend_gomoku", kernels.descend_gomoku,
                                                           d_args)
    dense, planes_bytes, dense_fns = dense_vs_plain(kernels, m_args, r_args)
    results.update(dense)
    print(f"[{tag}] B={batch} C={cfg.nodes} A={A}: descend_gomoku, merge_dense and refresh_dense "
          f"({what}) bit-equal to plain ({edges / batch:.2f} path edges per game; stat planes "
          f"{planes_bytes / 1e6:.1f} MB)", flush=True)
    time_in_turns(results, {"descend_gomoku": (lambda: kernels.descend_gomoku(*d_args),
                                               lambda: hybrid.descend(*d_args)), **dense_fns},
                  tag, card, f" at A={A}")

    # (b) their round variants at K=ROUND_K
    cfg4 = dataclasses.replace(cfg, parallel_sims=ROUND_K)
    results.update(rounds_vs_plain(game, *capture_round_args(game, apply_fn, cfg4, roots, noise),
                                   card))

    if not searches:
        return {name: results[base] for name, base in entries.items()}, {}

    # (c) whole searches through the kernels and the plain versions
    rounds = SIMS // ROUND_K
    got = dict(same_counts_through_kernels_and_plain(
        tag, game, apply_fn, cfg, roots, noise,
        {"descend_gomoku": SIMS, "merge_dense": SIMS, "refresh_dense": 1}))
    got4 = same_counts_through_kernels_and_plain(
        tag, game, apply_fn, cfg4, roots, noise,
        {"descend_round_gomoku": rounds, "merge_round_dense": rounds, "refresh2_dense": 1})
    got.update({k: v for k, v in got4.items() if v})
    launches = {name: got[base] for name, base in entries.items()}
    print(f"[{tag}] launches of the K=1 and K={ROUND_K} searches (B={batch}, A={A}): "
          f"{launches} | {card}", flush=True)
    return {name: results[base] for name, base in entries.items()}, launches


def gomoku_full_net(game, dev):
    """The Gomoku ``full`` preset's AZResNet-64x5 for ``game``, bf16,
    seeded random weights."""
    from alphazero_tpu_torch.models import convert_az_resnet, make_apply_fn, random_az_resnet_variables

    A = game.num_actions
    return make_apply_fn(convert_az_resnet(random_az_resnet_variables(
        A, GMK_CHANNELS, GMK_BLOCKS, cells=A, seed=SEED), dtype=torch.bfloat16).to(dev))


def gomoku_cli_iteration(tag: str, size: int, card: str, dev) -> None:
    """``train_gomoku --size SIZE --preset smoke`` in this process, cut to
    WIDE_CLI_ITERATIONS iterations: exit 0, the Gomoku descend and the
    dense merge and seed launched, ``0.examples`` written."""
    import tempfile

    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.examples import train_gomoku

    argv = ["--size", str(size), "--preset", "smoke", "--seed", str(SEED),
            "--iterations", str(WIDE_CLI_ITERATIONS), *(["--cpu"] if dev.type == "cpu" else [])]
    print(f"[{tag}] train_gomoku {' '.join(argv)}: iterations cut 2 -> "
          f"{WIDE_CLI_ITERATIONS} (the preset's own first)", flush=True)
    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{tag}_") as ckdir:
        kernels.reset_launch_counts()
        rc, sec = timed_sync(lambda: train_gomoku.main([*argv, "--checkpoint-dir", ckdir]))
        got = dict(kernels.launch_counts())
        if rc != 0:
            fail(f"{tag}: train_gomoku {' '.join(argv)} exited {rc}")
        if any(got[k] == 0 for k in ("descend_gomoku", "merge_dense", "refresh_dense")):
            fail(f"{tag}: the CLI's iteration launched {got}")
        if not os.path.exists(os.path.join(ckdir, "0.examples")):
            fail(f"{tag}: the CLI wrote no 0.examples: {sorted(os.listdir(ckdir))}")
    print(f"[{tag}] the CLI exited 0 in {sec:.3f} s | launches {launched(got)} | {card}",
          flush=True)


def gomoku23_phase(card: str, dev=None) -> tuple:
    """Phase 23: Gomoku boards above 512 cells on the hybrid kernels' wider
    instances (see the module docstring), on ``dev`` (the card). Returns
    the kernels line's entries of those instances (Gomoku 23 at full
    width) and their launches."""
    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.games import Gomoku

    dev = dev or torch.device("cuda", 0)
    ptxas_lines(kernels.library(), WIDE_KERNELS, gate=False)
    g23, g27 = Gomoku(WIDE_SIZE), Gomoku(WIDEST_SIZE)
    entries, launches = wide_gomoku_checks("gomoku23", g23, gomoku_full_net(g23, dev), GMK_B, card,
                                           dev)
    # (d) the same at A=729, edge 27, the instances' widest board, at a small batch
    wide_gomoku_checks("gomoku27", g27, gomoku_full_net(g27, dev), WIDEST_B, card, dev)
    # (e) the training CLI at --size 23, the smoke preset
    gomoku_cli_iteration("gomoku23", WIDE_SIZE, card, dev)
    return entries, launches


def counts_round_checks(tag: str, game, apply_fn, cfg, roots, noise, checks: dict, card: str,
                        dev) -> tuple:
    """Phase 24(d)-(f): the round kernels of ``checks`` ({entry name:
    "descend" or "merge"}) bit-equal to plain on the last round of a plain
    search at ``cfg`` (``cfg.num_sims // cfg.parallel_sims`` rounds of
    ``cfg.parallel_sims``), timed in turns (the plain versions, Python loops
    over the K descents, 3 times a turn); then one search through the
    kernels and the plain versions: equal root counts and one launch of
    each round kernel a round. Returns ``(result entries, launches)``,
    an entry's launches its wrapper's in that search."""
    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.mcts import hybrid

    K = cfg.parallel_sims
    rounds = cfg.num_sims // K
    B, A = roots.shape[0], game.num_actions
    d_args, m_args, _ = capture_round_args(game, apply_fn, cfg, roots, noise, rounds=rounds)
    C = d_args[0].shape[1]
    scratch = kernels.library().lib.az_descend_round_scratch(B, C, K)
    results, fns, bases = {}, {}, {}
    dense = "_dense" if A > hybrid.UNROLLED_MAX_A else ""
    for name, which in checks.items():
        if which == "descend":
            bases[name], kernel, results[name], second, dups = descend_round_vs_plain(d_args)
            fns[name] = (lambda k=kernel: k(*d_args), lambda: hybrid.descend_round(*d_args))
            counts = (f"32-bit counters in a global scratch of {scratch}" if scratch
                      else "byte counters in shared memory")
            print(f"[{tag}] {bases[name]} bit-equal to plain at K={K}, C={C} ({second:.0f} runner-up "
                  f"takes, {dups:.0f} duplicates; {counts})", flush=True)
        else:
            bases[name] = f"merge_round{dense}"
            results[name], fns[name] = merge_vs_plain(bases[name], getattr(kernels, bases[name]),
                                                      hybrid.merge_round, m_args)
            print(f"[{tag}] {bases[name]} bit-equal to plain at K={K}, A={A}, C={C}", flush=True)
    time_in_turns(results, fns, tag, card, f" at K={K}, C={C}", p_reps=3)
    d_name = kernels._DESCEND_ROUND_ENTRIES[kernels.descend_entry(game.flat_ops())][3:]
    got = same_counts_through_kernels_and_plain(
        tag, game, apply_fn, cfg, roots, noise,
        {d_name: rounds, f"merge_round{dense}": rounds, f"refresh2{dense}": 1})
    return results, {name: got[base] for name, base in bases.items()}


def wider_phase(card: str, dev=None) -> tuple:
    """Phase 24: the configurations past the hybrid kernels' older
    instances (see the module docstring), on ``dev`` (the card). Returns
    the kernels line's entries of the instances they take and their
    launches."""
    import dataclasses

    from alphazero_tpu_torch import kernels
    from alphazero_tpu_torch.config import MCTSConfig
    from alphazero_tpu_torch.games import ConnectFour, Gomoku, Othello
    from alphazero_tpu_torch.models import convert_az_resnet, make_apply_fn, random_az_resnet_variables
    from alphazero_tpu_torch.ops import sample_draws

    dev = dev or torch.device("cuda", 0)
    ptxas_lines(kernels.library(), WIDER_KERNELS)
    t_part = time.perf_counter()

    def part(label: str) -> None:   # each part's seconds
        nonlocal t_part
        now = time.perf_counter()
        print(f"[wider] {label}: {now - t_part:.1f} s", flush=True)
        t_part = now

    what = "the board in the leaf row; streamed merges and seeds"
    g32, g45 = Gomoku(WIDER_SIZE), Gomoku(WIDER_CHECK_SIZE)
    # (a) Gomoku 32 at the full preset's width
    entries, launches = wide_gomoku_checks("gomoku32", g32, gomoku_full_net(g32, dev), GMK_B, card,
                                           dev, WIDER_ENTRIES, what)
    part("(a) gomoku32")
    # (b) Gomoku 45 at a small batch: the kernels against their plain versions
    wide_gomoku_checks("gomoku45", g45, gomoku_full_net(g45, dev), WIDER_B, card, dev,
                       WIDER_ENTRIES, what, searches=False)
    part("(b) gomoku45")
    # (c) the training CLI at --size 32, the smoke preset
    gomoku_cli_iteration("gomoku32", WIDER_SIZE, card, dev)
    part("(c) train_gomoku --size 32")

    # (d) the Othello full preset (AZResNet-128x5) at K past 16 and past 32
    oth = Othello()
    oth_net = make_apply_fn(convert_az_resnet(random_az_resnet_variables(
        oth.num_actions, OTH_CHANNELS, OTH_BLOCKS, cells=64, seed=SEED),
        dtype=torch.bfloat16).to(dev))
    roots = random_positions(oth, OTH_B, 20, SEED, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    noise = sample_draws(gen, OTH_B, oth.num_actions, OTH_DIRICHLET, dev).dirichlet
    for K in WIDE_KS:
        cfg = MCTSConfig(num_sims=SIMS, max_depth=OTH_MAX_DEPTH, dirichlet_alpha=OTH_DIRICHLET,
                         parallel_sims=K)
        got, got_launches = counts_round_checks(f"othello K={K}", oth, oth_net, cfg, roots, noise,
                                                {"merge_round_dense_stream_k100": "merge"}, card, dev)
        if K == WIDE_KS[-1]:
            entries.update(got)
            launches.update(got_launches)
    part(f"(d) othello K={WIDE_KS}")

    # (e)-(f) Connect-Four's full preset (AZResNet-64x5): K=256, C=29057
    c4 = ConnectFour()
    c4_net = make_apply_fn(convert_az_resnet(random_az_resnet_variables(
        c4.num_actions, channels=64, blocks=5, seed=SEED), dtype=torch.bfloat16).to(dev))
    roots = random_positions(c4, COUNTS_B, 30, SEED, dev)
    noise = sample_draws(gen, COUNTS_B, c4.num_actions, 1.0, dev).dirichlet
    cfg = MCTSConfig(num_sims=2 * COUNTS_K, max_depth=MAX_DEPTH, dirichlet_alpha=1.0,
                     parallel_sims=COUNTS_K)
    for cfg_, checks in (
            (cfg, {"descend_round_wide": "descend", "merge_round_wide": "merge"}),
            (dataclasses.replace(cfg, num_sims=SIMS, max_nodes=COUNTS_C, parallel_sims=ROUND_K),
             {"descend_round_wide_global": "descend"})):
        got, got_launches = counts_round_checks(f"c4 K={cfg_.parallel_sims}", c4, c4_net, cfg_,
                                                roots, noise, checks, card, dev)
        entries.update(got)
        launches.update(got_launches)
        part(f"(e)-(f) c4 K={cfg_.parallel_sims}, C={cfg_.nodes}")
    print(f"[wider] launches of the searches behind the kernels line's entries: {launches} | "
          f"{card}", flush=True)
    return entries, launches


def build_report(lib) -> None:
    """Phase 2's lines: the build, ptxas's register report, and the
    registers, stack and static shared bytes of the kernels it names (the
    fused, A <= 8 merge, descend, seed and tower kernels gated: none may
    have a stack frame or spill)."""
    from alphazero_tpu_torch import kernels

    print(f"[build] nvcc {' '.join(kernels.NVCC_FLAGS[:2])} -> {os.path.relpath(lib.path)} "
          f"({len(kernels.SOURCES)} sources compiled in parallel, linked into one library; "
          f"{lib.build_seconds:.3f} s)", flush=True)
    for ln in lib.build_log.splitlines():
        if ln.startswith("[") or "entry function" in ln or "registers" in ln or "spill" in ln:
            print(f"[build] {ln.strip()}", flush=True)
    mlp_kernels = FUSED_C4_KERNELS
    # the dense merges' instances (J actions a lane), by a piece of their
    # mangled names
    instances = {f"merge{r}_dense_kernel<{j}>": f"merge{r}_dense_kernelILi{j}E"
                 for r in ("", "_round") for j in (4, 8, 16, 24)}
    report = ptxas_report(lib.build_log, (*mlp_kernels, *instances.values()))
    for name in (*mlp_kernels, *instances):
        print(f"[build] ptxas -v {name}: "
              f"{report.get(instances.get(name, name), 'not in the build log (a cached build)')}",
              flush=True)
    ptxas_lines(lib, (*FUSED_KERNELS, *MERGE_KERNELS, *DESCEND_KERNELS, *SEED_KERNELS,
                      *TOWER_KERNELS))


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
    if sys.argv[1:2] == ["--parallel-rank"]:
        return parallel_rank(sys.argv[2:])
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
    if sys.argv[1:] == ["--learner"]:
        kernels.library()
        learner_phase(card)
        return 0
    if sys.argv[1:] == ["--coach"]:
        kernels.library()
        coach_phase(card, cut=False)
        return 0
    if sys.argv[1:] == ["--games"]:
        kernels.library()
        games_phase(card, cut=False)
        return 0
    if sys.argv[1:] == ["--dense"]:
        kernels.library()
        dense_phase(card)
        return 0
    if sys.argv[1:] == ["--economy"]:
        kernels.library()
        economy_phase(card)
        return 0
    if sys.argv[1:] == ["--tt"]:
        tt_phase(card)
        return 0
    if sys.argv[1:] in (["--parallel"], ["--parallel-cards"]):
        kernels.library()
        parallel_phase(card, cards_only=sys.argv[1:] == ["--parallel-cards"])
        return 0
    if sys.argv[1:] == ["--gomoku23"]:
        gomoku23_phase(card)
        return 0
    if sys.argv[1:] == ["--wide"]:
        build_report(kernels.library())
        wider_phase(card)
        return 0
    if sys.argv[1:] == ["--fused-wide"]:
        build_report(kernels.library())
        fused_wide_phase(card)
        return 0

    # each phase's seconds, printed as it ends
    t_start = t_last = time.perf_counter()

    def tick(label: str) -> None:
        nonlocal t_last
        now = time.perf_counter()
        print(f"[time] {label}: {now - t_last:.1f} s (script {now - t_start:.1f} s)", flush=True)
        t_last = now

    # ---- 2. build ------------------------------------------------------
    lib = kernels.library()
    build_report(lib)

    tick("phases 1-2")

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
    tick("phases 3-6")

    # ---- 7. the MLP: the fused kernel with the in-kernel evaluator ------
    phase_results, phase_launches, ms_mlp = mlp_phase(card, roots)
    results.update(phase_results)
    launches.update(phase_launches)
    tick("phase 7")

    # ---- 8-11. Othello, Gomoku and Hex on the hybrid engine; rounds ----
    for number, phase in zip(range(8, 12), (othello_phase, gomoku_phase, hex_phase, rounds_phase)):
        phase_results, phase_launches = phase(card)
        results.update(phase_results)
        launches.update(phase_launches)
        tick(f"phase {number}")

    # ---- 12. the fused engine's K>1 rounds ------------------------------
    phase_results, phase_launches = fused_rounds_phase(card, {"uniform": ms_u, "mlp": ms_mlp})
    results.update(phase_results)
    launches.update(phase_launches)
    tick("phase 12")

    # ---- 13. the fused int8 tower --------------------------------------
    phase_results, phase_launches = int8_tower_phase(card)
    results.update(phase_results)
    launches.update(phase_launches)
    tick("phase 13")

    # ---- 14. the fused engine at any MLP width, on Gomoku of <= 16 cells -
    phase_results, phase_launches = fused_wide_phase(card)
    results.update(phase_results)
    launches.update(phase_launches)
    tick("phase 14")

    # ---- 15. Gomoku 19 --------------------------------------------------
    gomoku19_phase(card)
    tick("phase 15")

    # ---- 16. the learner loop -------------------------------------------
    # its launches of descend, merge, refresh and fused_mlp replace those of
    # phases 5 and 7 in the kernels line, and its fused_mlp entry, at the
    # mlp scan's shapes, phase 7's: this slice's path
    phase_results, phase_launches = learner_phase(card)
    results.update(phase_results)
    launches.update(phase_launches)
    tick("phase 16")

    # ---- 17. the coach ----------------------------------------------------
    # one iteration of each preset: its launches of descend, merge, refresh,
    # fused and fused_mlp replace phase 16's in the kernels line
    launches.update(coach_phase(card, cut=True))
    tick("phase 17")

    # ---- 18. the coach on Othello, Gomoku, Hex and AZConvNet -------------
    # its launches of the games' descends and of the dense merge and seed
    # replace phases 8-10's in the kernels line
    games = games_phase(card, cut=True)
    launches.update({k: games[k] for k in ("descend_othello", "descend_gomoku", "descend_hex",
                                           "merge_dense", "refresh_dense")})
    tick("phase 18")

    # ---- 19. the dense engine, forced playouts, the play and analyze CLIs -
    # plain PyTorch: it adds no kernel, and its searches launch none
    dense_phase(card)
    tick("phase 19")

    # ---- 20. the training economy: Gumbel search, PCR, reanalyze ----------
    # Gumbel search launches no kernel; PCR's az_fused_mlp launches and the
    # reanalyze pass's hybrid ones add to the kernels line's
    for k, v in economy_phase(card).items():
        launches[k] += v
    tick("phase 20")

    # ---- 21. the transposition-DAG engine through its routes --------------
    # plain PyTorch: it adds no kernel, and its searches launch none
    tt_phase(card)
    tick("phase 21")

    # ---- 22. the data-parallel path over torch.distributed ----------------
    # each rank's launches in (b) add to the kernels line's
    per_rank = parallel_phase(card)
    for k, counts in per_rank.items():
        launches[k] += sum(counts)
    tick("phase 22")

    # ---- 23. Gomoku boards above 512 cells --------------------------------
    # the wider kernel instances' entries: Gomoku 23 at full width
    phase_results, phase_launches = gomoku23_phase(card)
    results.update(phase_results)
    launches.update(phase_launches)
    tick("phase 23")

    # ---- 24. Gomoku above 768 cells, rounds above K = 16 --------------------
    # the leaf-row, streamed and wide instances' entries: Gomoku 32 at full
    # width, the Othello full preset at K=100, Connect-Four at K=256 and
    # C=29057
    phase_results, phase_launches = wider_phase(card)
    results.update(phase_results)
    launches.update(phase_launches)
    tick("phase 24")

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
            # phase 22(b): each rank's launches of the two-rank runs
            **({"parallel_launches_per_rank": per_rank[name]} if name in per_rank else {}),
        }
        for name in ("descend", "merge", "refresh", "fused", "fused_mlp",
                     "descend_othello", "merge_dense", "refresh_dense", "descend_gomoku",
                     "descend_hex", "descend_round", "descend_round_othello",
                     "descend_round_gomoku", "descend_round_hex", "merge_round",
                     "merge_round_dense", "refresh2", "refresh2_dense", "fused_rounds",
                     "fused_mlp_rounds", "int8_tower", *WIDE_ENTRIES, *WIDER_ENTRIES,
                     *COUNTS_ENTRIES, *FUSED_WIDE_ENTRIES)
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
