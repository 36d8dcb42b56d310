#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``alphazero_tpu_torch``).

Drives the port's two self-play paths — the steady-state Connect-Four actor
on the hybrid engine with an AZResNet-64x5, and on the fused kernel with the
uniform model — on one CUDA card, in phases:

1. card:   the card's name and power limit (``nvidia-smi``);
2. build:  the hand-written kernels (``csrc/hybrid.cu``, ``csrc/fused.cu``)
           compiled with nvcc for sm_90a, one process per source, and linked
           into one library, with the build seconds and ptxas's register
           report;
3. kernels vs plain: each kernel against its plain PyTorch version at the
           main path's shapes (B=4096, C=101, A=7), on tree planes taken
           from a few simulations of the plain search on random positions;
           outputs must be bit-equal; both timed with CUDA events;
4. goldens: the uniform model through the CUDA path reproduces
           ``tests/golden_counts.json`` for Connect-Four exactly;
5. slice:  AZResNet-64x5 (seeded random weights through the flax->torch
           converter) in bf16 with the ``full`` preset's search (B=4096,
           100 sims, Dirichlet 1.0): actor steps with the launch counters
           reset just before and read just after, visit counts summing to
           the simulation budget, pi rows summing to 1, and one search
           through the plain versions giving identical counts;
6. fused:  the fused kernel against its plain version on random roots
           (B=4096, 100 sims, uval 0.5: bit-equal counts and root W, both
           timed), the goldens through the fused engine in one launch, then
           the uniform actor at the headline bench's size (B=65536, 100 sims,
           max_depth 48): one fused launch per step and no hybrid launch,
           ms/step, env-steps/s and peak memory; the kernel against its plain
           version again on the actor's own roots at that size (bit-equal,
           both timed: the numbers of the kernels line); a few steps of the
           same actor through the hybrid route and one search through both
           routes with identical counts.

Each kernel's line in the JSON carries its bound: the larger of the bytes
the function must move (each input read once, each output written once; a
data-dependent walk counts the cells this run's data reaches) over
3.35 TB/s, and its f32 operations over 67 TFLOP/s (the H100 SXM's data-sheet
rates at 700 W).

The second-to-last line is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``. Any failed phase raises and the
script exits non-zero without that line. Run from the repository root:

    python3 chip_smoke.py
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
HYBRID_STEPS = 3       # uniform actor steps through the hybrid route
FUSED_REPS = 5

SOURCE = {
    "descend": "alphazero_tpu_torch/csrc/hybrid.cu",
    "merge": "alphazero_tpu_torch/csrc/hybrid.cu",
    "refresh": "alphazero_tpu_torch/csrc/hybrid.cu",
    "fused": "alphazero_tpu_torch/csrc/fused.cu",
}
REPLACES = {
    "descend": "alphazero_tpu/mcts/hybrid.py:242",   # descend_kernel
    "merge": "alphazero_tpu/mcts/hybrid.py:363",     # merge_kernel (+ _refresh)
    "refresh": "alphazero_tpu/mcts/hybrid.py:120",   # _refresh, seeding at :815
    "fused": "alphazero_tpu/mcts/fused.py:156",      # kernel, K=1 sim_body :282
}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_OPS_PER_S = 67e12       # H100 SXM data sheet, f32 outside the tensor cores
F32 = 4


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the f32 rate, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
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

    # ---- 2. build ------------------------------------------------------
    lib = kernels.library()
    print(f"[build] nvcc {' '.join(kernels.NVCC_FLAGS[:2])} -> {os.path.relpath(lib.path)} "
          f"({len(kernels.SOURCES)} sources compiled in parallel, linked into one library; "
          f"{lib.build_seconds:.3f} s)", flush=True)
    for ln in lib.build_log.splitlines():
        if ln.startswith("[") or "registers" in ln or "spill" in ln:
            print(f"[build] {ln.strip()}", flush=True)

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

    warm_sims = 24
    cfg_cap = MCTSConfig(num_sims=warm_sims, max_nodes=C, max_depth=MAX_DEPTH, dirichlet_alpha=1.0)
    roots = random_positions(game, B, 30, SEED, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    noise = sample_draws(gen, B, A, 1.0, dev).dirichlet
    hybrid.make_hybrid_root_fn(
        game, apply_fn, cfg_cap, kernels=SearchKernels(capture_descend, capture_merge, hybrid.refresh)
    )(roots, noise)
    d_args, m_args = captured["descend"], captured["merge"]
    if d_args[0].shape != (B, C) or m_args[0].shape != (B, A, C):
        fail(f"captured planes have shapes {d_args[0].shape}, {m_args[0].shape}")

    results = {}
    kernels.reset_launch_counts()
    out_k = kernels.descend(*d_args)
    out_p = hybrid.descend(*d_args)
    names = ("bd", "patha", "psgn", "meta")
    err = max(float((k - p).abs().max()) for k, p in zip(out_k, out_p))
    for nm, k, p in zip(names, out_k, out_p):
        if not bit_equal(k, p):
            fail(f"descend output {nm} differs from the plain version")
    results["descend"] = {"max_abs_err": err}
    # reads: the board, each path node's besta/bestc, the root's done and a
    # leaf's tval; writes: the leaf board, the patha/psgn rows and meta
    edges = float((out_p[1] > 0).sum())
    leaves = float((out_p[3][:, 1] + out_p[3][:, 4]).sum())
    results["descend"].update(bound(
        F32 * (B * 42 + 2 * edges + B + leaves + B * 42 + 2 * B * C + B * 8), 0.0
    ))

    planes_k = [t.clone() for t in m_args[:6]]
    planes_p = [t.clone() for t in m_args[:6]]
    best_k = kernels.merge(*planes_k, *m_args[6:])
    best_p = hybrid.merge(*planes_p, *m_args[6:])
    outs_k, outs_p = planes_k + list(best_k), planes_p + list(best_p)
    names = ("n", "w", "p", "code", "done", "tval", "besta", "bestc")
    err = max(float((k - p).abs().max()) for k, p in zip(outs_k, outs_p))
    for nm, k, p in zip(names, outs_k, outs_p):
        if not bit_equal(k, p):
            fail(f"merge output {nm} differs from the plain version")
    results["merge"] = {"max_abs_err": err}
    # reads: the four stat planes, patha/psgn, pm, meta2; writes: the best
    # planes and the cells that change (path n/w, install rows, links)
    m_edges = float((m_args[7] > 0).sum())
    installs = float(m_args[9][:, hybrid.M2_EXPOK].sum())
    results["merge"].update(bound(
        F32 * (4 * B * A * C + 2 * B * C + B * A + B * 8
               + 2 * B * C + 2 * m_edges + installs * (4 * A + 3)),
        puct_ops(B * C, A) + 3 * m_edges,
    ))

    ref_k = kernels.refresh(*m_args[:4], m_args[-1])
    ref_p = hybrid.refresh(*m_args[:4], m_args[-1])
    err = max(float((k - p).abs().max()) for k, p in zip(ref_k, ref_p))
    if not all(bit_equal(k, p) for k, p in zip(ref_k, ref_p)):
        fail("refresh differs from the plain version")
    results["refresh"] = {"max_abs_err": err}
    results["refresh"].update(bound(F32 * (4 * B * A * C + 2 * B * C), puct_ops(B * C, A)))
    print(f"[kernels] B={B} C={C} A={A}: descend, merge, refresh bit-equal to plain "
          f"(mean path length {float((out_p[1] > 0).sum()) / B:.2f} edges/game)", flush=True)

    # timing, in turns: plain, kernel, kernel, plain
    scratch = [t.clone() for t in m_args[:6]]
    fns = {
        "descend": (lambda: kernels.descend(*d_args), lambda: hybrid.descend(*d_args)),
        "merge": (
            lambda: kernels.merge(*scratch, *m_args[6:]),
            lambda: hybrid.merge(*scratch, *m_args[6:]),
        ),
        "refresh": (
            lambda: kernels.refresh(*m_args[:4], m_args[-1]),
            lambda: hybrid.refresh(*m_args[:4], m_args[-1]),
        ),
    }
    for name, (k_fn, p_fn) in fns.items():
        p1 = time_ms(p_fn, 20)
        k1 = time_ms(k_fn, 50)
        k2 = time_ms(k_fn, 50)
        p2 = time_ms(p_fn, 20)
        results[name]["ms"] = (k1 + k2) / 2
        results[name]["plain_ms"] = (p1 + p2) / 2
        print(f"[kernels] {name}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms "
              f"| {card}", flush=True)

    feats = game.to_features(roots).contiguous()
    nn_ms = time_ms(lambda: apply_fn(feats), 20)
    print(f"[nn] AZResNet-64x5 bf16 folded forward, B={B}: {nn_ms:.4f} ms per sim | {card}",
          flush=True)

    # ---- 4. goldens ----------------------------------------------------
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                           "golden_counts.json")) as f:
        golden = json.load(f)["connect_four"]
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
    want = {"descend": TIMED_STEPS * SIMS, "merge": TIMED_STEPS * SIMS, "refresh": TIMED_STEPS,
            "fused": 0}
    if launches != want:
        fail(f"launch counts {launches} != {want}")
    ms_move = 1e3 * sum(step_s) / len(step_s)
    ms_median = 1e3 * sorted(step_s)[len(step_s) // 2]
    print(f"[slice] AZResNet-64x5 bf16, B={B}, {SIMS} sims, dirichlet 1.0: "
          f"{ms_move:.3f} ms/move mean, {ms_median:.3f} upper median "
          f"({', '.join(f'{1e3 * s:.3f}' for s in step_s)}), "
          f"{B / (ms_move / 1e3):.1f} env-steps/s | launches {launches} | {card}", flush=True)

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
        # the work depends on the data: every descent step is one PUCT
        # argmax and one backup; a search's steps are the sum of N over
        # every edge
        steps = float(n_all.sum())
        out = {"max_abs_err": max(float((ck - cp).abs().max()), float((wk - wp).abs().max())),
               "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
               **bound(F32 * nb * (42 + A + 2 * A), steps * (puct_ops(1, A) + 3))}
        print(f"[fused] {label}: B={nb}, {SIMS} sims, max_depth {MAX_DEPTH}, uval {value}: "
              f"az_fused bit-equal to fused_search (counts and root W; {steps / nb:.2f} descent "
              f"steps per game); kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, "
              f"bound {out['bound_ms']:.4f} ms ({out['bound_by']}) | {card}", flush=True)
        return out

    fused_vs_plain(fused_inputs(roots, 0.5), "random roots")

    kernels.reset_launch_counts()
    counts = fused.make_fused_root_fn(game, uniform.apply_fn, MCTSConfig(num_sims=50, max_depth=64))(
        torch.cat(states)
    )
    if kernels.launch_counts() != {"descend": 0, "merge": 0, "refresh": 0, "fused": 1}:
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
    if uni_launches != {"descend": 0, "merge": 0, "refresh": 0, "fused": TIMED_STEPS}:
        fail(f"uniform actor launches {uni_launches}: want one fused launch per step, no hybrid")
    if not torch.allclose(pi.sum(dim=1), torch.ones(UNIFORM_B, device=dev), atol=1e-5):
        fail("uniform actor pi rows do not sum to 1")
    peak = torch.cuda.max_memory_allocated()
    ms_u = 1e3 * sum(step_s) / len(step_s)
    print(f"[uniform] fused route, B={UNIFORM_B}, {SIMS} sims, max_depth {MAX_DEPTH}: "
          f"{ms_u:.3f} ms/step mean, {1e3 * sorted(step_s)[len(step_s) // 2]:.3f} upper median "
          f"({', '.join(f'{1e3 * t:.3f}' for t in step_s)}), {UNIFORM_B / (ms_u / 1e3):.1f} "
          f"env-steps/s | launches {uni_launches} | peak memory {peak / 2**30:.3f} GiB | {card}",
          flush=True)
    state_u, _ = carry_u
    # the main path's kernel, held against its plain version on the actor's
    # own roots at the actor's shape and uniform value
    results["fused"] = fused_vs_plain(fused_inputs(state_u, uval), "the uniform actor's roots")

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
          f"env-steps/s | launches {hyb_launches} | fused is {ms_h / ms_u:.1f}x faster | {card}",
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
            "library_ms": None,   # no single PyTorch call computes these functions
        }
        for name in ("descend", "merge", "refresh", "fused")
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
