"""The port's fused engine (``mcts/fused.py``; the plain version of the
``az_fused`` kernel on the CPU) gives root visit counts EQUAL to the JAX
fused kernel, run in the Pallas interpreter as tests/test_fused.py runs it,
and reproduces the frozen goldens; the self-play ladder picks it for the
uniform model and the hybrid engine for the ResNet (the MLP's fused route
is tests/test_torch_mlp.py's)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
from alphazero_tpu.games import ConnectFour as JaxConnectFour
from alphazero_tpu.mcts.fused import make_fused_root_fn as jax_fused_root_fn
from alphazero_tpu.models import make_uniform_model as jax_uniform
from alphazero_tpu_torch import kernels
from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.games import ConnectFour
from alphazero_tpu_torch.mcts import fused_search, make_fused_root_fn, make_hybrid_root_fn
from alphazero_tpu_torch.models import (
    convert_az_resnet,
    convert_mlp,
    make_apply_fn,
    make_uniform_model,
    random_az_resnet_variables,
    random_mlp_variables,
)
from alphazero_tpu_torch.selfplay import _make_root_counts_fn
from tests.torch_parity import DRAW_BOARD, boards_from_seqs, jax_state, random_boards, torch_state

JG = JaxConnectFour()
TG = ConnectFour()


def _check_vs_jax_fused(cfg, boards, value=0.0, key=None):
    """Root counts of the JAX fused kernel (interpret mode, blocks of 4
    games) and of the port's fused engine on the same boards and noise."""
    ref = np.asarray(
        jax_fused_root_fn(JG, jax_uniform(JG, value).apply_fn, cfg, block_size=4)(
            {}, jax_state(boards), key
        )
    )
    noise = None
    if key is not None:
        noise = torch.as_tensor(np.array(
            jax.random.dirichlet(key, jnp.full((7,), cfg.dirichlet_alpha), (len(boards),))
        ))
    root_counts = make_fused_root_fn(
        TG, make_uniform_model(TG, value).apply_fn, MCTSConfig(**dataclasses.asdict(cfg))
    )
    got = root_counts(torch_state(boards), noise).numpy()
    np.testing.assert_array_equal(ref, got)
    return got


@pytest.mark.parametrize(
    "cfg,moves,value",
    [
        (JaxMCTSConfig(num_sims=20, max_depth=48), 14, 0.0),                 # late positions
        (JaxMCTSConfig(num_sims=16, max_depth=3), 6, 0.0),                   # depth cutoffs
        (JaxMCTSConfig(num_sims=20, max_depth=48, max_nodes=8), 4, 0.0),     # slots run out
        (JaxMCTSConfig(num_sims=16, max_depth=48, cpuct=2.5), 24, 0.5),      # W signs
    ],
    ids=["late_positions", "max_depth3", "max_nodes8", "uval0.5"],
)
def test_matches_jax_fused_kernel(cfg, moves, value):
    got = _check_vs_jax_fused(cfg, random_boards(8, moves, seed=moves), value)
    assert got.sum() > 0


def test_injected_dirichlet_matches_jax_fused_kernel():
    cfg = JaxMCTSConfig(num_sims=16, max_depth=48, dirichlet_alpha=0.7, dirichlet_frac=0.25)
    _check_vs_jax_fused(cfg, random_boards(8, 2, seed=7), key=jax.random.key(11))


def test_terminal_roots_match_jax_fused_kernel():
    """Finished games (wins, a full-board draw) are not searched; live
    endgames next to them are."""
    boards = np.concatenate([random_boards(7, 40, seed=5), DRAW_BOARD[None]])
    done = TG.terminal(torch_state(boards))[0].numpy()
    assert done.any() and not done.all()
    got = _check_vs_jax_fused(JaxMCTSConfig(num_sims=12, max_depth=48), boards, value=0.5)
    assert (got.sum(1)[done] == 0).all() and (got.sum(1)[~done] == 12).all()


def test_frozen_goldens():
    with open(os.path.join(os.path.dirname(__file__), "golden_counts.json")) as f:
        spec = json.load(f)["connect_four"]
    root_counts = make_fused_root_fn(
        TG, make_uniform_model(TG).apply_fn, MCTSConfig(num_sims=50, max_depth=64)
    )
    got = root_counts(torch_state(boards_from_seqs(spec["seqs"])))
    np.testing.assert_array_equal(got.numpy().astype(int), np.asarray(spec["counts"]))


def test_same_counts_as_the_hybrid_engine():
    """The plain version's prior vm / max(n_valid, 1) equals the hybrid
    engine's masked softmax of the uniform model's zero logits, so the two
    engines give the same counts; root W is nonzero for live roots at a
    nonzero value."""
    cfg = MCTSConfig(num_sims=24, max_depth=48)
    boards = torch_state(random_boards(16, 10, seed=2))
    uni = make_uniform_model(TG, 0.5).apply_fn
    h = make_hybrid_root_fn(TG, uni, cfg)(boards)
    assert torch.equal(make_fused_root_fn(TG, uni, cfg)(boards), h)
    valid = TG.valid_moves(boards)
    p = torch.where(valid, 1.0 / valid.sum(1, keepdim=True).float(), -1e30)
    counts, rootw = fused_search(TG.flat_ops().from_state(boards), p, cfg, 0.5)
    assert torch.equal(counts, h)
    live = ~TG.terminal(boards)[0]
    assert live.any() and (rootw.sum(1)[live] != 0).all()


def test_ladder_picks_fused_for_uniform_and_hybrid_for_resnet():
    cfg = MCTSConfig(num_sims=8)
    uniform = _make_root_counts_fn(TG, make_uniform_model(TG).apply_fn, cfg)
    assert uniform.__qualname__.startswith("make_fused_root_fn.")
    resnet = make_apply_fn(convert_az_resnet(random_az_resnet_variables(7, 8, 1, seed=0),
                                             dtype=torch.float32))
    assert _make_root_counts_fn(TG, resnet, cfg).__qualname__.startswith("make_hybrid_root_fn.")


def test_declines_and_raises_as_the_reference():
    uni = make_uniform_model(TG).apply_fn
    # K>1 rounds (K2) build up to the reference's (K+1)^A < 2^24: K=9 at A=7
    assert make_fused_root_fn(TG, uni, MCTSConfig(num_sims=8, parallel_sims=4)) is not None
    assert _make_root_counts_fn(TG, uni, MCTSConfig(num_sims=8, parallel_sims=4)).__qualname__.startswith(
        "make_fused_root_fn.")
    with pytest.raises(ValueError, match="too large"):
        make_fused_root_fn(TG, uni, MCTSConfig(num_sims=20, parallel_sims=10))

    mlp_apply = make_apply_fn(convert_mlp(random_mlp_variables(7, (16,), seed=0)))
    assert make_fused_root_fn(TG, mlp_apply, MCTSConfig()) is not None   # K3, the in-kernel MLP
    nn_apply = make_apply_fn(convert_az_resnet(random_az_resnet_variables(7, 8, 1, seed=0),
                                               dtype=torch.float32))
    assert make_fused_root_fn(TG, nn_apply, MCTSConfig()) is None

    class Wide(ConnectFour):
        num_actions = 17

    class Heuristic(ConnectFour):
        heuristic_is_zero = False

    class NoFlatOps(ConnectFour):
        flat_ops = None

    for game in (Wide(), Heuristic(), NoFlatOps()):
        assert make_fused_root_fn(game, uni, MCTSConfig()) is None

    class Other(ConnectFour):
        name = "other"

    # a game whose step the port's fused kernels lack: declined, so the
    # ladder runs the hybrid engine, as the JAX ladder does past its fused
    # kernel
    assert make_fused_root_fn(Other(), uni, MCTSConfig()) is None
    assert _make_root_counts_fn(Other(), uni, MCTSConfig()).__qualname__.startswith(
        "make_hybrid_root_fn.")


def test_wrapper_routes_cpu_to_plain_and_refuses_other_devices():
    boards = TG.flat_ops().from_state(torch_state(random_boards(4, 5, seed=1)))
    p = torch.full((4, 7), 1.0 / 7)
    kernels.reset_launch_counts()
    got = kernels.fused(boards, p, 8, 9, 48, 1.0, 0.0)
    want = fused_search(boards, p, MCTSConfig(num_sims=8, max_depth=48), 0.0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert kernels.launch_counts()["fused"] == 0
    with pytest.raises(ValueError, match="no kernel for device"):
        kernels.fused(boards.to("meta"), p.to("meta"), 8, 9, 48, 1.0, 0.0)
    with pytest.raises(ValueError, match="several devices"):
        kernels.fused(boards, p.to("meta"), 8, 9, 48, 1.0, 0.0)
    assert kernels.launch_counts()["fused"] == 0
