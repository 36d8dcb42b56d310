"""Gomoku in the port: the game ops and flat ops equal the JAX package's
exactly at edges 7, 9 and 15 (every action, occupied cells included), the
port's hybrid engine (the plain versions of its kernels on the CPU) gives
root visit counts EQUAL to the jitted JAX XLA engine and reproduces the
frozen TPU goldens, and AZResNet and MLPNet at 81 and 225 cells agree with
flax within the stated tolerance.

Tolerances: f32 forwards atol 1e-4 on logits and value (convs and matmuls
sum in different orders); the bf16 MLP forward atol 1e-3 (as in
tests/test_torch_othello_models.py). Everything else is exact.

The JAX side is jitted once per configuration and edge, so each serves
several inputs."""

import dataclasses
import json
import os
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
from alphazero_tpu.games import Gomoku as JaxGomoku
from alphazero_tpu.games import gomoku as jax_gomoku
from alphazero_tpu.mcts.search import make_search_fn
from alphazero_tpu.models import AZResNet as JaxAZResNet
from alphazero_tpu.models import MLPNet as JaxMLPNet
from alphazero_tpu.models import make_uniform_model as jax_uniform
from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.games import Game, Gomoku
from alphazero_tpu_torch.games import gomoku as port_gomoku
from alphazero_tpu_torch.mcts import make_hybrid_root_fn
from alphazero_tpu_torch.models import (
    convert_az_resnet,
    convert_mlp,
    make_apply_fn,
    make_uniform_model,
    random_az_resnet_variables,
    random_mlp_variables,
)
from tests.test_fused import _random_positions
from tests.torch_parity import fused_test_positions, gomoku_jax_state, random_play_boards, torch_state

SIZES = (7, 9, 15)
F32_ATOL = 1e-4
MLP_ATOL = 1e-3


@lru_cache(maxsize=None)
def _games(size: int):
    """(JAX game, port game, JAX flat ops, port flat ops) at edge ``size``."""
    jg, tg = JaxGomoku(size), Gomoku(size)
    return jg, tg, jg.flat_ops(), tg.flat_ops()


@lru_cache(maxsize=None)
def _jax_vmapped(size: int, name: str):
    return jax.jit(jax.vmap(getattr(_games(size)[0], name)))


@lru_cache(maxsize=None)
def _positions(size: int) -> np.ndarray:
    """Openings, middle games, finished games and boards played past the
    end (several lines, both colours' fives, full boards at edge 7)."""
    tg = _games(size)[1]
    cells = size * size
    parts = [
        random_play_boards(tg, 3, 0, seed=0),
        random_play_boards(tg, 6, 8, seed=1),
        random_play_boards(tg, 6, cells // 2, seed=2),
        random_play_boards(tg, 6, cells, seed=3),
        random_play_boards(tg, 6, cells, seed=4, freeze_done=False),
    ]
    return np.concatenate(parts)


def _line_boards(size: int) -> np.ndarray:
    """Hand-built boards: a five of each colour in each of the four
    directions (at an edge and inside), a six, a broken five (no win), and
    a full board with no five (an exact-0 draw)."""
    out = []
    starts = {"h": [(0, 0), (size - 1, size - 5)], "v": [(0, size - 1), (size - 5, 2)],
              "d": [(0, 0), (size - 5, size - 5)], "a": [(4, 0), (size - 1, size - 5)]}
    steps = {"h": (0, 1), "v": (1, 0), "d": (1, 1), "a": (-1, 1)}
    for player in (1, -1):
        for key, cells in starts.items():
            for r0, c0 in cells:
                b = np.zeros((size, size), np.int8)
                for i in range(5):
                    b[r0 + i * steps[key][0], c0 + i * steps[key][1]] = player
                b[size // 2, size // 2] = b[size // 2, size // 2] or -player   # a stray stone
                out.append(b)
    six = np.zeros((size, size), np.int8)
    six[1, :6] = 1
    broken = np.zeros((size, size), np.int8)
    broken[2, [0, 1, 2, 3, 5]] = -1
    r, c = np.indices((size, size))
    draw = np.where((c // 2 + r) % 2 == 0, 1, -1).astype(np.int8)
    return np.stack(out + [six, broken, draw])


@pytest.mark.parametrize("size", SIZES)
def test_protocol_static_fields_and_constants(size):
    jg, tg, jops, tops = _games(size)
    assert isinstance(tg, Game)
    for name in ("name", "num_actions", "feature_shape", "max_moves", "num_symmetries",
                 "heuristic_is_zero", "size", "win"):
        assert getattr(tg, name) == getattr(jg, name)
    assert (port_gomoku.SIZE, port_gomoku.WIN) == (jax_gomoku.SIZE, jax_gomoku.WIN)
    assert Gomoku().name == "gomoku" and Gomoku(15).name == "gomoku15"
    for name in ("board_size", "win", "size", "num_actions", "aux_lanes"):
        assert getattr(tops, name) == getattr(jops, name)
    aux = tops.aux("cpu")
    np.testing.assert_array_equal(np.asarray(jops.aux()), aux.numpy())
    assert int((aux.sum(0) > 0).sum()) == {7: 60, 9: 140, 15: 572}[size]   # win lines
    assert tg.init(3, "cpu").dtype == torch.int8 and tg.init(3, "cpu").shape == (3, size, size)
    with pytest.raises(ValueError):
        Gomoku(4)


@pytest.mark.parametrize("size", SIZES)
def test_step_matches_every_action_including_occupied(size):
    """Gomoku.step and GomokuFlatOps.step (the kernel helper's plain
    version) against both JAX steps, for every action on every position:
    empty cells and occupied ones of both colours (overwritten with +1)."""
    jg, tg, jops, tops = _games(size)
    boards = _positions(size)[::3]
    A = size * size
    tiled = np.repeat(boards, A, axis=0)
    acts = np.tile(np.arange(A), len(boards))
    ref = np.asarray(_jax_vmapped(size, "step")(gomoku_jax_state(tiled), jnp.asarray(acts)).board)
    got = tg.step(torch_state(tiled), torch.as_tensor(acts))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(ref, got.numpy())

    flat = tops.from_state(torch_state(tiled))
    a_col = torch.as_tensor(acts, dtype=torch.float32)[:, None]
    ref_flat = np.asarray(jax.jit(jops.step)(jnp.asarray(flat.numpy()), jnp.asarray(a_col.numpy())))
    got_flat = tops.step(flat, a_col)
    np.testing.assert_array_equal(ref_flat, got_flat.numpy())          # -0.0 == 0.0
    np.testing.assert_array_equal(ref.reshape(-1, A), got_flat.numpy())
    occupied = tiled.reshape(-1, A)[np.arange(len(acts)), acts]
    assert (occupied == 1).any() and (occupied == -1).any()          # overwrites were checked


@pytest.mark.parametrize("size", SIZES)
def test_terminal_valid_features_match(size):
    """Random boards and hand-built ones (fives of both colours in all four
    directions, a six, a broken five, a full-board draw): terminal, valid
    moves and features of the game ops and the flat ops equal JAX's."""
    jg, tg, jops, tops = _games(size)
    boards = np.concatenate([_positions(size), _line_boards(size)])
    js, ts = gomoku_jax_state(boards), torch_state(boards)
    jd, jv = _jax_vmapped(size, "terminal")(js)
    td, tv = tg.terminal(ts)
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    lines = _line_boards(size)
    n_lines = len(lines)
    assert (tv[-n_lines:-n_lines + 8] == 1).all() and (tv[-n_lines + 8:-3] == -1).all()   # the fives
    assert tv[-3] == 1 and not td[-2] and td[-1] and tv[-1] == 0                      # six, broken, draw
    assert (lines[-1] != 0).all()
    np.testing.assert_array_equal(np.asarray(_jax_vmapped(size, "valid_moves")(js)), tg.valid_moves(ts).numpy())
    np.testing.assert_array_equal(np.asarray(_jax_vmapped(size, "to_features")(js)), tg.to_features(ts).numpy())
    np.testing.assert_array_equal(np.zeros(len(boards), np.float32), tg.eval_heuristic(ts).numpy())

    jflat = jops.from_state(js)
    tflat = tops.from_state(ts)
    np.testing.assert_array_equal(np.asarray(jflat), tflat.numpy())
    jfd, jfv = jax.jit(jops.terminal)(jflat, jops.aux())
    aux = tops.aux("cpu")
    tfd, tfv = tops.terminal(tflat, aux)
    np.testing.assert_array_equal(np.asarray(jfd), tfd.numpy())
    np.testing.assert_array_equal(np.asarray(jfv), tfv.numpy())
    np.testing.assert_array_equal(tfd.numpy()[:, 0], td.numpy())
    vm, vd, vv = tops.valid_terminal(tflat, aux)
    assert torch.equal(vd, tfd) and torch.equal(vv, tfv)
    np.testing.assert_array_equal(np.asarray(jops.valid(jflat)), vm.numpy())
    np.testing.assert_array_equal(np.asarray(jops.to_features(jflat)), tops.to_features(tflat).numpy())


@pytest.mark.parametrize("size", SIZES)
def test_symmetries_match(size):
    jg, tg = _games(size)[:2]
    boards = _positions(size)[:8]
    rng = np.random.default_rng(size)
    pi = rng.dirichlet(np.ones(size * size), len(boards)).astype(np.float32)
    feats = np.array(_jax_vmapped(size, "to_features")(gomoku_jax_state(boards)))
    jf, jp = jax.vmap(jg.symmetries)(jnp.asarray(feats), jnp.asarray(pi))
    tf, tp = tg.symmetries(torch.as_tensor(feats), torch.as_tensor(pi))
    assert tf.shape == (8, 8, size, size, 2) and tp.shape == (8, 8, size * size)
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())


SEARCH_CFG = JaxMCTSConfig(num_sims=16, max_depth=48)


@lru_cache(maxsize=None)
def _jax_xla_counts_fn(size: int):
    """The JAX XLA engine with the uniform model at SEARCH_CFG, jitted once
    per edge."""
    jg = _games(size)[0]
    search = make_search_fn(jg, jax_uniform(jg).apply_fn, SEARCH_CFG)
    return jax.jit(lambda state: search({}, state).root_counts())


def _port_counts(size: int, cfg, boards: np.ndarray) -> np.ndarray:
    tg = _games(size)[1]
    root_counts = make_hybrid_root_fn(tg, make_uniform_model(tg).apply_fn, MCTSConfig(**dataclasses.asdict(cfg)))
    return root_counts(torch_state(boards)).numpy()


@pytest.mark.parametrize("size,moves", [(7, 0), (7, 14), (9, 6), (9, 30)])
def test_uniform_matches_xla_engine(size, moves):
    """Uniform searches (B=4, 16 sims) of the port's plain hybrid engine
    equal the jitted JAX XLA engine's, from openings to near-full boards
    with terminal children."""
    boards = random_play_boards(_games(size)[1], 4, moves, seed=size + moves)
    ref = np.asarray(_jax_xla_counts_fn(size)(gomoku_jax_state(boards)))
    got = _port_counts(size, SEARCH_CFG, boards)
    np.testing.assert_array_equal(ref, got)
    live = ~_games(size)[1].terminal(torch_state(boards))[0].numpy()
    assert (got.sum(1)[live] == SEARCH_CFG.num_sims).all()


def _tpu_goldens() -> dict:
    with open(os.path.join(os.path.dirname(__file__), "tpu_goldens.json")) as f:
        return json.load(f)


def test_reproduces_tpu_goldens():
    """``hybrid_gomoku_uniform_counts_head`` (9x9, the initial position, 16
    sims, max_depth 32) and ``hybrid_gomoku15_uniform_counts_head`` (15x15,
    the first 4 positions of tests/test_fused.py's generator at 9 moves,
    seed 31; 16 sims, max_depth 64), exactly."""
    goldens = _tpu_goldens()
    start = np.zeros((4, 9, 9), np.int8)
    got = _port_counts(9, JaxMCTSConfig(num_sims=16, max_depth=32), start)
    np.testing.assert_array_equal(got, np.asarray(goldens["hybrid_gomoku_uniform_counts_head"]))
    boards = fused_test_positions(_games(15)[1], 256, 9, seed=31)[:4]
    got = _port_counts(15, JaxMCTSConfig(num_sims=16, max_depth=64), boards)
    np.testing.assert_array_equal(got, np.asarray(goldens["hybrid_gomoku15_uniform_counts_head"]))


def test_position_replica_matches_the_jax_generator():
    """The numpy replica of tests/test_fused.py's ``_random_positions``
    gives its boards at the Gomoku-15 golden's settings."""
    ref = np.asarray(_random_positions(_games(15)[0], 256, 9, seed=31).board)
    np.testing.assert_array_equal(ref, fused_test_positions(_games(15)[1], 256, 9, seed=31))


def _feats(size: int, batch: int, moves: int, seed: int) -> np.ndarray:
    boards = random_play_boards(_games(size)[1], batch, moves, seed=seed)
    return np.stack([(boards == 1), (boards == -1)], axis=-1).astype(np.float32)


@pytest.mark.parametrize("size", [9, 15])
def test_az_resnet_forward_matches_flax(size):
    """AZResNet-16x1 on S x S boards with S*S actions, f32: the folded
    eval and the training-shaped module against flax."""
    A = size * size
    variables = random_az_resnet_variables(A, 16, 1, cells=A, seed=size)
    feats = _feats(size, 4, 12, seed=5)
    jax_model = JaxAZResNet(num_actions=A, channels=16, blocks=1, dtype=jnp.float32)
    model = convert_az_resnet(variables, dtype=torch.float32)
    apply_fn = make_apply_fn(model)
    with torch.no_grad():
        pairs = [
            (jax_model.folded_apply(variables, jnp.asarray(feats)), apply_fn(torch.as_tensor(feats))),
            (jax_model.apply(variables, jnp.asarray(feats), train=False), model(torch.as_tensor(feats))),
        ]
    for (jl, jv), (tl, tv) in pairs:
        assert tl.shape == (4, A) and tv.shape == (4,)
        np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=F32_ATOL, rtol=0)
        np.testing.assert_allclose(np.asarray(jv), tv.numpy(), atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("size", [9, 15])
def test_mlp_forward_matches_flax(size):
    A = size * size
    variables = random_mlp_variables(A, (32, 32), cells=A, seed=size)
    feats = _feats(size, 16, 10, seed=6)
    jl, jv = JaxMLPNet(num_actions=A, hidden=(32, 32)).apply(variables, jnp.asarray(feats))
    model = convert_mlp(variables)
    assert model.cells == A
    with torch.no_grad():
        tl, tv = make_apply_fn(model)(torch.as_tensor(feats))
    assert tl.shape == (16, A) and tv.shape == (16,)
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=MLP_ATOL, rtol=0)
    np.testing.assert_allclose(np.asarray(jv), tv.numpy(), atol=MLP_ATOL, rtol=0)
