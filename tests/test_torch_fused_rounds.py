"""The fused engine's K>1 leaf-parallel rounds (K2; on the CPU the plain
versions of ``az_fused_rounds`` and ``az_fused_mlp_rounds``) against the
JAX fused kernel in the Pallas interpreter, as tests/test_fused.py runs
it: the uniform model at a non-dyadic value, whose root W sums show the
order of the round's additions, with exactly equal counts; MLPNet within
the JAX package's Mosaic-vs-XLA bound (tests/test_torch_mlp.py: >= 75% of
games identical, max |dpi| <= 0.25), against the JAX fused kernel and
against the port's hybrid route. Also the ladder's routing, the JAX
package's two ``ValueError``s, the wrappers' routing, and the port of
``bench_k.py``'s head-to-head. Each JAX reference compiles for 5-35 s in
the interpreter, so this file runs on one worker."""

import dataclasses
import importlib
import json
import sys

import jax
import numpy as np
import pytest
import torch

from alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
from alphazero_tpu.games import ConnectFour as JaxConnectFour
from alphazero_tpu.mcts.fused import make_fused_root_fn as jax_fused_root_fn
from alphazero_tpu.models import MLPNet as JaxMLPNet
from alphazero_tpu.models import make_flax_apply_fn
from alphazero_tpu.models import make_uniform_model as jax_uniform
from alphazero_tpu_torch import bench_k, kernels
from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.games import ConnectFour
from alphazero_tpu_torch.games.connect_four import FlatOps
from alphazero_tpu_torch.mcts import (
    fused_mlp_rounds_search,
    fused_rounds_search,
    make_fused_root_fn,
    make_hybrid_root_fn,
)
from alphazero_tpu_torch.models import (
    convert_az_resnet,
    convert_mlp,
    make_apply_fn,
    make_uniform_model,
    random_az_resnet_variables,
    random_mlp_variables,
)
from alphazero_tpu_torch.ops import sample_draws
from alphazero_tpu_torch.selfplay import _make_root_counts_fn, make_actor_step_fn
from tests.torch_parity import jax_state, random_boards, torch_state

SAME_GAMES = 0.75
MAX_DPI = 0.25

JG = JaxConnectFour()
TG = ConnectFour()
FLAT = FlatOps()


def _assert_close_searches(a: np.ndarray, b: np.ndarray) -> None:
    assert (a.sum(axis=1) == b.sum(axis=1)).all()   # sims conserved
    same = (a == b).all(axis=1).mean()
    assert same >= SAME_GAMES, f"only {same:.0%} of games identical"
    pa = a / np.maximum(a.sum(1, keepdims=True), 1)
    pb = b / np.maximum(b.sum(1, keepdims=True), 1)
    assert np.abs(pa - pb).max() <= MAX_DPI


def _mlp(hidden, seed):
    variables = random_mlp_variables(7, hidden, seed=seed)
    return variables, make_apply_fn(convert_mlp(variables))


def test_uniform_nondyadic_value_matches_jax_fused_rounds():
    """uval 0.3 at K=4: every backed-up value is 0.3 or a terminal +-1, so
    W sums round, and the root counts depend on the order of the round's
    additions; they must equal the JAX fused kernel's."""
    cfg = JaxMCTSConfig(num_sims=24, max_depth=48, parallel_sims=4)
    boards = random_boards(8, 12, seed=3)
    ref = np.asarray(jax_fused_root_fn(JG, jax_uniform(JG, 0.3).apply_fn, cfg, block_size=4)(
        {}, jax_state(boards), None))
    port_cfg = MCTSConfig(**dataclasses.asdict(cfg))
    got = make_fused_root_fn(TG, make_uniform_model(TG, 0.3).apply_fn, port_cfg)(torch_state(boards))
    np.testing.assert_array_equal(ref, got.numpy())
    assert (got.sum(1) == 24).all()
    # the plain version's root W is the sum of 0.3s and +-1s, not an integer
    valid = TG.valid_moves(torch_state(boards))
    p = torch.where(valid, 1.0 / valid.sum(1, keepdim=True).float(), -1e30)
    counts, rootw = fused_rounds_search(FLAT.from_state(torch_state(boards)), p, port_cfg, 0.3)
    assert torch.equal(counts, got) and (rootw != rootw.round()).any()


def test_mlp_rounds_close_to_jax_fused_kernel():
    """MLPNet (32, 32) at K=2, 16 boards, 24 sims: the port's fused rounds
    against the JAX fused kernel's with its in-kernel MLP, blocks of 4."""
    cfg = JaxMCTSConfig(num_sims=24, max_depth=48, parallel_sims=2)
    variables, apply_fn = _mlp((32, 32), seed=0)
    boards = random_boards(16, 5, seed=2)
    jax_apply = make_flax_apply_fn(JaxMLPNet(num_actions=7, hidden=(32, 32)))
    ref = np.asarray(jax_fused_root_fn(JG, jax_apply, cfg, block_size=4)(variables, jax_state(boards), None))
    got = make_fused_root_fn(TG, apply_fn, MCTSConfig(**dataclasses.asdict(cfg)))(torch_state(boards)).numpy()
    assert got.sum(axis=1).max() == 24
    _assert_close_searches(ref, got)


def test_mlp_rounds_close_to_hybrid_route():
    """MLPNet (32, 32) at K=4: the fused rounds (the in-kernel evaluator's
    arithmetic) against the hybrid engine's rounds (the library forward)."""
    cfg = MCTSConfig(num_sims=24, max_depth=48, parallel_sims=4)
    _, apply_fn = _mlp((32, 32), seed=1)
    state = torch_state(random_boards(16, 8, seed=3))
    fused = make_fused_root_fn(TG, apply_fn, cfg)(state).numpy()
    hybrid = make_hybrid_root_fn(TG, apply_fn, cfg)(state).numpy()
    assert fused.sum(axis=1).max() == 24
    _assert_close_searches(fused, hybrid)


def test_ladder_sends_k_rounds_of_uniform_and_mlp_to_the_fused_engine():
    """At ``parallel_sims=4`` the uniform model and MLPNet take the fused
    engine's rounds and the AZResNet the hybrid engine's; the actor steps
    through them conserve the simulations."""
    cfg = MCTSConfig(num_sims=8, max_depth=48, parallel_sims=4)
    routes = {
        "mlp": _mlp((16,), seed=0)[1],
        "uniform": make_uniform_model(TG).apply_fn,
        "resnet": make_apply_fn(convert_az_resnet(random_az_resnet_variables(7, 8, 1, seed=0),
                                                  dtype=torch.float32)),
    }
    engines = {k: _make_root_counts_fn(TG, fn, cfg).__qualname__.split(".")[0] for k, fn in routes.items()}
    assert engines == {"mlp": "make_fused_root_fn", "uniform": "make_fused_root_fn",
                       "resnet": "make_hybrid_root_fn"}
    gen = torch.Generator().manual_seed(0)
    for name in ("mlp", "uniform"):
        root_counts = _make_root_counts_fn(TG, routes[name], cfg)
        init, step = make_actor_step_fn(TG, routes[name], cfg, 6, 4, device="cpu")
        carry = init()
        for _ in range(3):
            draws = sample_draws(gen, 6, 7, None, "cpu")
            assert (root_counts(carry[0]).sum(1) == 8).all()
            carry, pi = step(carry, draws)
            torch.testing.assert_close(pi.sum(1), torch.ones(6))


@pytest.mark.parametrize("apply_fn", [make_uniform_model(TG).apply_fn, _mlp((16,), seed=0)[1]],
                         ids=["uniform", "mlp"])
def test_value_errors_where_the_reference_raises(apply_fn):
    """``num_sims % K`` and ``(K+1)^A >= 2^24`` raise ``ValueError`` with the
    JAX package's wording for both evaluators; K=9, the largest K at A=7,
    builds, as the JAX package's does."""
    with pytest.raises(ValueError, match="must be divisible by parallel_sims=4"):
        make_fused_root_fn(TG, apply_fn, MCTSConfig(num_sims=10, parallel_sims=4))
    with pytest.raises(ValueError, match=r"parallel_sims=10 too large for 7 actions \(needs \(K\+1\)\^A < 2\^24\)"):
        make_fused_root_fn(TG, apply_fn, MCTSConfig(num_sims=20, parallel_sims=10))
    assert make_fused_root_fn(TG, apply_fn, MCTSConfig(num_sims=18, parallel_sims=9)) is not None
    assert jax_fused_root_fn(JG, jax_uniform(JG).apply_fn, JaxMCTSConfig(num_sims=18, parallel_sims=9),
                             block_size=4) is not None
    with pytest.raises(ValueError, match="too large"):
        jax_fused_root_fn(JG, jax_uniform(JG).apply_fn, JaxMCTSConfig(num_sims=20, parallel_sims=10),
                          block_size=4)


def test_round_wrappers_route_cpu_to_plain_and_refuse_other_devices():
    boards = FLAT.from_state(torch_state(random_boards(4, 5, seed=1)))
    p = torch.where(FLAT.valid(boards), 1.0 / 7, -1e30)
    w = _mlp((32, 32), seed=3)[1].kernel_eval_factory(FLAT)
    cfg = MCTSConfig(num_sims=8, max_depth=48, parallel_sims=2)
    kernels.reset_launch_counts()
    got = kernels.fused_rounds(boards, p, 8, 9, 48, 1.0, 0.3, 2)
    assert all(torch.equal(g, r) for g, r in zip(got, fused_rounds_search(boards, p, cfg, 0.3)))
    got = kernels.fused_mlp_rounds(boards, p, w, 8, 9, 48, 1.0, 2)
    assert all(torch.equal(g, r) for g, r in zip(got, fused_mlp_rounds_search(boards, p, cfg, w)))
    assert kernels.launch_counts()["fused_rounds"] == kernels.launch_counts()["fused_mlp_rounds"] == 0
    with pytest.raises(ValueError, match="no kernel for device"):
        kernels.fused_rounds(boards.to("meta"), p.to("meta"), 8, 9, 48, 1.0, 0.0, 2)
    with pytest.raises(ValueError, match="several devices"):
        kernels.fused_mlp_rounds(boards, p.to("meta"), w, 8, 9, 48, 1.0, 2)
    with pytest.raises(ValueError, match="descents per round"):
        kernels.fused_rounds(boards, p, 20, 21, 48, 1.0, 0.0, kernels.FUSED_MAX_K + 1)
    with pytest.raises(ValueError, match="divisible"):
        kernels.fused_mlp_rounds(boards, p, w, 9, 10, 48, 1.0, 2)
    assert kernels.launch_counts()["fused_rounds"] == kernels.launch_counts()["fused_mlp_rounds"] == 0


def test_head_to_head_plays_every_game_to_its_end():
    """``bench_k.head_to_head`` on the CPU (the plain versions) at 8 games,
    8 sims, K=2: every game ends and is counted once, and the same
    generator seed replays the same games."""
    out = [bench_k.head_to_head(TG, 2, 8, 8, 48, torch.Generator().manual_seed(51), temp_moves=4,
                                device="cpu") for _ in range(2)]
    assert out[0] == out[1]
    assert sum(out[0]) == 8 and min(out[0]) >= 0


@pytest.mark.parametrize("counts", [(600, 300, 124), (0, 1024, 0), (512, 512, 0), (3, 1, 2044)],
                         ids=["k_ahead", "k_swept", "even", "mostly_draws"])
def test_elo_summary_equals_the_reference_formula(counts, monkeypatch, tmp_path, capsys):
    """``bench_k.elo_summary`` against the reference script's own output on
    fixed win/loss/draw counts (its ``head_to_head`` replaced by the counts,
    its compilation cache pointed at a temporary directory)."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    cache_dir = jax.config.jax_compilation_cache_dir
    try:
        ref_mod = importlib.import_module("bench_k")
    finally:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    monkeypatch.setattr(ref_mod, "head_to_head", lambda *a, **k: counts)
    monkeypatch.setattr(sys, "argv", ["bench_k.py", "--seeds", "1"])
    with np.errstate(divide="ignore"):   # the reference's log10(0) at a score of 0
        ref_mod.main()
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = bench_k.elo_summary(*counts)
    assert {k: ref[k] for k in got} == got
