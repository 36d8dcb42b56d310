#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``alphazero_tpu_torch``).

Drives the port's main path — the steady-state Connect-Four self-play actor
on the hybrid engine with an AZResNet-64x5 — on one CUDA card, in phases:

1. card:   the card's name and power limit (``nvidia-smi``);
2. build:  the hand-written kernels (``csrc/hybrid.cu``) built with nvcc for
           sm_90a, with the build seconds and ptxas's register report;
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
           through the plain versions giving identical counts.

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

SOURCE = "alphazero_tpu_torch/csrc/hybrid.cu"
REPLACES = {
    "descend": "alphazero_tpu/mcts/hybrid.py:242",   # descend_kernel
    "merge": "alphazero_tpu/mcts/hybrid.py:363",     # merge_kernel (+ _refresh)
    "refresh": "alphazero_tpu/mcts/hybrid.py:120",   # _refresh, seeding at :815
}


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
    from alphazero_tpu_torch.mcts import PLAIN, SearchKernels, hybrid
    from alphazero_tpu_torch.models import (
        convert_az_resnet,
        make_apply_fn,
        make_uniform_model,
        random_az_resnet_variables,
    )
    from alphazero_tpu_torch.ops import sample_draws
    from alphazero_tpu_torch.selfplay import make_actor_step_fn

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
    regs = [ln.strip() for ln in lib.build_log.splitlines() if "registers" in ln or "spill" in ln]
    print(f"[build] nvcc {' '.join(kernels.NVCC_FLAGS[:2])} -> {os.path.relpath(lib.path)} "
          f"in {lib.build_seconds:.3f} s", flush=True)
    for ln in regs:
        print(f"[build] {ln}", flush=True)

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

    ref_k = kernels.refresh(*m_args[:4], m_args[-1])
    ref_p = hybrid.refresh(*m_args[:4], m_args[-1])
    err = max(float((k - p).abs().max()) for k, p in zip(ref_k, ref_p))
    if not all(bit_equal(k, p) for k, p in zip(ref_k, ref_p)):
        fail("refresh differs from the plain version")
    results["refresh"] = {"max_abs_err": err}
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
    launches = kernels.launch_counts()
    want = {"descend": TIMED_STEPS * SIMS, "merge": TIMED_STEPS * SIMS, "refresh": TIMED_STEPS}
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

    print(card)
    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": results[name]["max_abs_err"],
            "ms": results[name]["ms"],
            "plain_ms": results[name]["plain_ms"],
        }
        for name in ("descend", "merge", "refresh")
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
