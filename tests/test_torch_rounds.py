"""The port's K>1 leaf-parallel rounds (``MCTSConfig.parallel_sims``) on
both engines (on the CPU the plain versions of the round kernels: the
hybrid engine's ``run_rounds`` and the fused engine's
``fused_rounds_search``) against the JAX package's own rounds on
Connect-Four: the JAX hybrid engine's (its round kernels in the Pallas
interpreter, which any ``block_size`` selects off the TPU) and the JAX
fused kernel's K2 rounds, which the JAX package cross-validates against
each other bit for bit (tests/test_hybrid.py). Root counts must be equal.
The wrappers' routing and the self-play actor at ``parallel_sims=4`` are
here too.

Each JAX reference compiles for 5-10 s in the interpreter, so the
positions of ``tests/torch_round_goldens.json`` serve both configurations
and their JAX counts are computed once. Non-uniform models are in
tests/test_torch_rounds_models.py, Othello, Gomoku and Hex in
tests/test_torch_rounds_games.py, the goldens' derivation in
tests/test_torch_rounds_goldens.py: each file runs on one worker.
"""

import dataclasses
import functools
import json
import os
import random

import numpy as np
import pytest
import torch

from alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
from alphazero_tpu.games import ConnectFour as JaxConnectFour
from alphazero_tpu.mcts.fused import make_fused_root_fn as jax_fused_root_fn
from alphazero_tpu.mcts.hybrid import make_hybrid_root_fn as jax_hybrid_root_fn
from alphazero_tpu.models import make_uniform_model as jax_uniform
from alphazero_tpu_torch import kernels
from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.games import ConnectFour, FlatOps, GomokuFlatOps, HexFlatOps, OthelloFlatOps
from alphazero_tpu_torch.mcts import PLAIN, hybrid, make_fused_root_fn, make_hybrid_root_fn
from alphazero_tpu_torch.models import (
    convert_az_resnet,
    make_apply_fn,
    make_uniform_model,
    random_az_resnet_variables,
)
from alphazero_tpu_torch.ops import sample_draws
from alphazero_tpu_torch.selfplay import _make_root_counts_fn, make_actor_step_fn
from tests.torch_parity import boards_from_seqs, jax_state, random_boards, torch_state

HERE = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(HERE, "torch_round_goldens.json")) as f:
    GOLDENS = json.load(f)
JG = JaxConnectFour()
TG = ConnectFour()
C4_GOLDEN = GOLDENS["connect_four"]
C4_CFG = JaxMCTSConfig(num_sims=C4_GOLDEN["num_sims"], max_depth=C4_GOLDEN["max_depth"],
                       parallel_sims=C4_GOLDEN["parallel_sims"])
C4_BOARDS = boards_from_seqs(C4_GOLDEN["seqs"])


def _port_counts(apply_fn, cfg, boards, game=TG, noise=None, engine="hybrid"):
    make = make_hybrid_root_fn if engine == "hybrid" else make_fused_root_fn
    fn = make(game, apply_fn, MCTSConfig(**dataclasses.asdict(cfg)))
    return fn(torch_state(boards), noise).numpy()


def _jax_counts(engine, jax_apply, cfg, boards, params=None):
    make = jax_hybrid_root_fn if engine == "hybrid" else jax_fused_root_fn
    fn = make(JG, jax_apply, cfg, block_size=len(boards))
    assert fn is not None
    return np.asarray(fn({} if params is None else params, jax_state(boards)))


@functools.lru_cache(maxsize=None)
def _jax_golden_positions(engine, cfg):
    """The JAX engine's uniform counts on the golden Connect-Four
    positions, computed once per (engine, config)."""
    return _jax_counts(engine, jax_uniform(JG).apply_fn, cfg, C4_BOARDS)


@pytest.mark.parametrize(
    "cfg",
    [C4_CFG, dataclasses.replace(C4_CFG, max_nodes=10)],        # slots run out inside a round
    ids=["K4_24sims", "K4_24sims_max_nodes10"],
)
def test_connect_four_rounds_match_jax_hybrid_and_fused_rounds(cfg):
    """Both of the port's engines against both JAX engines."""
    uni = make_uniform_model(TG).apply_fn
    for engine in ("hybrid", "fused"):
        got = _port_counts(uni, cfg, C4_BOARDS, engine=engine)
        np.testing.assert_array_equal(got, _jax_golden_positions("hybrid", cfg), err_msg=engine)
        np.testing.assert_array_equal(got, _jax_golden_positions("fused", cfg), err_msg=engine)
        assert (got.sum(1) == cfg.num_sims).all()


def _fuzz_configs(trials=4):
    """Seeded random (sims, cpuct, capacity, depth, K) configurations, as
    tests/test_hybrid.py's fuzz draws them, with K > 1 only."""
    rnd = random.Random(1234)
    out = []
    for trial in range(trials):
        K = rnd.choice([2, 3, 4])
        sims = K * rnd.randint(3, 8)
        cfg = JaxMCTSConfig(
            num_sims=sims,
            cpuct=rnd.choice([0.5, 1.0, 2.5]),
            max_depth=rnd.choice([4, 16, 48]),
            max_nodes=rnd.choice([None, max(4, sims // 2)]),
            parallel_sims=K,
        )
        out.append((trial, cfg, rnd.randint(0, 16)))
    return out


FUZZ = _fuzz_configs()


@pytest.mark.parametrize("trial,cfg,moves", FUZZ,
                         ids=[f"trial{t}_K{cfg.parallel_sims}" for t, cfg, _ in FUZZ])
def test_fuzz_rounds_match_jax_fused_rounds(trial, cfg, moves):
    """Both of the port's engines against the JAX fused kernel's rounds."""
    boards = random_boards(8, moves, seed=trial)
    want = _jax_counts("fused", jax_uniform(JG).apply_fn, cfg, boards)
    for engine in ("hybrid", "fused"):
        np.testing.assert_array_equal(
            _port_counts(make_uniform_model(TG).apply_fn, cfg, boards, engine=engine), want,
            err_msg=f"{engine}, trial {trial}: {cfg}",
        )


def test_round_wrappers_route_cpu_to_plain_and_refuse_other_devices():
    B, A, C, K = 2, 7, 6, 3
    torch.manual_seed(0)
    n, w, p = torch.zeros(B, A, C), torch.zeros(B, A, C), torch.rand(B, A, C)
    code = torch.full((B, A, C), -1.0)
    kernels.reset_launch_counts()
    for got, want in zip(kernels.refresh2(n, w, p, code, 1.0), PLAIN.refresh2(n, w, p, code, 1.0)):
        assert torch.equal(got, want)
    best4 = kernels.refresh2(n, w, p, code, 1.0)
    done, tval, boards = torch.zeros(B, C), torch.zeros(B, C), torch.zeros(B, 42)
    rec = kernels.descend_round(*best4, done, tval, boards, 48, FlatOps(), K)
    for got, want in zip(rec, PLAIN.descend_round(*best4, done, tval, boards, 48, FlatOps(), K)):
        assert torch.equal(got, want)
    assert [tuple(t.shape) for t in rec] == [(K, B, 42), (K, B, C), (K, B, C), (K, B, 8)]
    assert all(v == 0 for v in kernels.launch_counts().values())
    with pytest.raises(ValueError, match="no kernel for device"):
        kernels.refresh2(*(t.to("meta") for t in (n, w, p, code)), 1.0)
    with pytest.raises(ValueError, match="several devices"):
        kernels.merge_round(n, w, p, code, done, tval, torch.zeros(K, B, A), rec[1], rec[2],
                            torch.zeros(K, B, 8).to("meta"), *best4, 1, 1.0)
    assert all(v == 0 for v in kernels.launch_counts().values())


@pytest.mark.parametrize(
    "ops,entry",
    [
        (FlatOps(), "az_descend_round"),
        (OthelloFlatOps(), "az_descend_round_othello"),
        (GomokuFlatOps(7), "az_descend_round_gomoku"),     # 49 cells, as Hex
        (GomokuFlatOps(8), "az_descend_round_gomoku"),     # 64 cells, as Othello
        (GomokuFlatOps(19), "az_descend_round_gomoku"),    # 361 cells: 6 words a side
        (HexFlatOps(), "az_descend_round_hex"),
    ],
    ids=["connect_four", "othello", "gomoku7", "gomoku8", "gomoku19", "hex"],
)
def test_descend_round_routes_by_the_flat_ops_type(ops, entry):
    """The round descend instance is the K=1 descend's game, picked by the
    flat ops' type; every other instance refuses the boards before it
    launches, and K past the merge's limit is refused."""
    assert kernels._DESCEND_ROUND_ENTRIES[kernels.descend_entry(ops)] == entry
    B, C = 2, 3
    planes = [torch.zeros(B, C) for _ in range(6)]
    boards = torch.zeros(B, ops.size)
    for other in set(kernels._DESCEND_ROUND_ENTRIES.values()) - {entry}:
        with pytest.raises(ValueError, match="does not step"):
            kernels._descend_round(other, *planes, boards, 8, ops, 4)
    with pytest.raises(NotImplementedError, match="Round kernels for K above 16"):
        kernels._descend_round(entry, *planes, boards, 8, ops, kernels.MAX_ROUND_K + 1)


def test_rounds_need_round_kernels_and_divisible_sims():
    uni = make_uniform_model(TG).apply_fn
    with pytest.raises(ValueError, match="divisible"):
        make_hybrid_root_fn(TG, uni, MCTSConfig(num_sims=10, parallel_sims=4))
    three = hybrid.SearchKernels(hybrid.descend, hybrid.merge, hybrid.refresh)
    fn = make_hybrid_root_fn(TG, uni, MCTSConfig(num_sims=8, parallel_sims=4), kernels=three)
    with pytest.raises(ValueError, match="round entry points"):
        fn(torch_state(C4_BOARDS[:2]))


def test_actor_steps_at_parallel_sims():
    """The self-play actor with ``parallel_sims=4`` and an AZResNet takes
    the hybrid engine's rounds (the uniform model and MLPNet take the fused
    engine's, tests/test_torch_fused_rounds.py): every step's search
    conserves the simulations and its pi rows sum to 1."""
    resnet = make_apply_fn(convert_az_resnet(random_az_resnet_variables(7, 8, 1, seed=4),
                                             dtype=torch.float32))
    cfg = MCTSConfig(num_sims=8, max_depth=48, parallel_sims=4, dirichlet_alpha=1.0)
    root_counts = _make_root_counts_fn(TG, resnet, cfg)
    assert root_counts.__qualname__.startswith("make_hybrid_root_fn.")
    init, step = make_actor_step_fn(TG, resnet, cfg, 6, 4, device="cpu")
    carry = init()
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        draws = sample_draws(gen, 6, 7, 1.0, "cpu")
        counts = root_counts(carry[0], draws.dirichlet)
        assert (counts.sum(1) == 8).all()
        carry, pi = step(carry, draws)
        torch.testing.assert_close(pi.sum(1), torch.ones(6))
