"""Hex in the port: the game ops equal the JAX package's exactly, and the
port's canonical flat ops (no parity lane) equal the canonical boards of
the JAX flat ops (``HexFlatOps._canonical`` of its stored boards) for
every action, occupied cells included, through sequences of steps of both
parities; the flood-fill terminal on random, snake and full boards; the
port's hybrid engine (plain versions on the CPU) gives root visit counts
EQUAL to the jitted JAX XLA engine and reproduces the frozen TPU golden;
AZResNet and MLPNet at 49 cells agree with flax within the stated
tolerance (f32 atol 1e-4, bf16 MLP atol 1e-3, as in
tests/test_torch_othello_models.py)."""

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
from alphazero_tpu.games import Hex as JaxHex
from alphazero_tpu.games import hex as jax_hex
from alphazero_tpu.mcts.search import make_search_fn
from alphazero_tpu.models import AZResNet as JaxAZResNet
from alphazero_tpu.models import MLPNet as JaxMLPNet
from alphazero_tpu.models import make_uniform_model as jax_uniform
from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.games import Game, Hex
from alphazero_tpu_torch.games import hex as port_hex
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
from tests.torch_parity import fused_test_positions, hex_jax_state, random_play_boards, torch_state

F32_ATOL = 1e-4
MLP_ATOL = 1e-3

JG = JaxHex()
TG = Hex()
JOPS = JG.flat_ops()
TOPS = TG.flat_ops()


@lru_cache(maxsize=None)
def _jax_vmapped(name: str):
    return jax.jit(jax.vmap(getattr(JG, name)))


def _snake(gap: bool = False) -> np.ndarray:
    """+1 stones whose only top-to-bottom chain winds through full rows 1,
    3 and 5 joined at alternate ends (20 edges from (0, 6) to (6, 0), so
    the flood fill takes 20 steps and reachability needs 5 squarings);
    ``gap`` takes out one corridor cell, leaving no chain."""
    b = np.zeros((7, 7), np.int8)
    b[0, 6] = b[2, 0] = b[4, 6] = b[6, 0] = 1
    b[1, :] = b[3, :] = b[5, :] = 1
    if gap:
        b[3, 3] = 0
    return b


@lru_cache(maxsize=None)
def _positions() -> np.ndarray:
    """Openings, middle games, finished games, full boards (played past the
    end), snake chains of both colours with and without a gap."""
    snakes = [_snake(), _snake(gap=True)]
    snakes += [-s.T for s in snakes]           # the -1 stones joining columns
    parts = [
        random_play_boards(TG, 3, 0, seed=0),
        random_play_boards(TG, 6, 8, seed=1),
        random_play_boards(TG, 6, 24, seed=2),
        random_play_boards(TG, 6, 49, seed=3),
        random_play_boards(TG, 6, 49, seed=4, freeze_done=False),
        np.stack(snakes),
    ]
    return np.concatenate(parts)


def test_protocol_static_fields_and_constants():
    assert isinstance(TG, Game)
    for name in ("name", "num_actions", "feature_shape", "max_moves", "num_symmetries",
                 "heuristic_is_zero"):
        assert getattr(TG, name) == getattr(JG, name)
    assert port_hex.SIZE == jax_hex.SIZE and port_hex._NEIGHBORS == jax_hex._NEIGHBORS
    assert (TOPS.size, TOPS.num_actions) == (49, JOPS.num_actions) and JOPS.size == 50
    np.testing.assert_array_equal(np.asarray(JG.init().board)[None].repeat(3, 0), TG.init(3, "cpu").numpy())
    aux = TOPS.aux("cpu")
    assert torch.equal(aux, aux.T) and int(aux.sum()) == 49 + 2 * (2 * 6 * 7 + 6 * 6)   # 120 edges


def _jax_canonical(stored: np.ndarray) -> np.ndarray:
    return np.asarray(JOPS._canonical(jnp.asarray(stored)).board).reshape(-1, 49)


def test_step_matches_every_action_including_occupied():
    """Hex.step against the JAX step, and HexFlatOps.step (the kernel
    helper's plain version) against the canonical boards of the JAX flat
    step, for all 49 actions on every position: empty and occupied cells,
    stored boards of parity 0 and of parity 1."""
    boards = _positions()[::2]
    n = len(boards)
    tiled = np.repeat(boards, 49, axis=0)
    acts = np.tile(np.arange(49), n)
    ref = np.asarray(_jax_vmapped("step")(hex_jax_state(tiled), jnp.asarray(acts)).board)
    got = TG.step(torch_state(tiled), torch.as_tensor(acts))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(ref, got.numpy())

    flat = TOPS.from_state(torch_state(tiled))
    a_col = torch.as_tensor(acts, dtype=torch.float32)[:, None]
    got_flat = TOPS.step(flat, a_col)
    np.testing.assert_array_equal(ref.reshape(-1, 49), got_flat.numpy())
    jstep = jax.jit(JOPS.step)
    stored = jstep(JOPS.from_state(hex_jax_state(tiled)), jnp.asarray(a_col.numpy()))   # parity 1
    np.testing.assert_array_equal(_jax_canonical(np.asarray(stored)), got_flat.numpy())
    # a second move from every parity-1 stored board, at another action
    acts2 = (acts * 5 + 3) % 49
    a2 = torch.as_tensor(acts2, dtype=torch.float32)[:, None]
    stored2 = jstep(stored, jnp.asarray(a2.numpy()))                                     # parity 0
    np.testing.assert_array_equal(_jax_canonical(np.asarray(stored2)), TOPS.step(got_flat, a2).numpy())
    occupied = tiled.reshape(-1, 49)[np.arange(len(acts)), acts]
    assert (occupied == 1).any() and (occupied == -1).any()          # overwrites were checked


def test_terminal_valid_features_match():
    """The connection test (reachability by repeated squaring) against the
    JAX flood fill, on random, full and snake boards; valid moves and
    features; the flat ops against the game ops."""
    boards = _positions()
    js, ts = hex_jax_state(boards), torch_state(boards)
    jd, jv = _jax_vmapped("terminal")(js)
    td, tv = TG.terminal(ts)
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    full = (boards != 0).all(axis=(1, 2))
    assert full.sum() >= 6 and td.numpy()[full].all() and (tv.numpy()[full] != 0).all()   # no draw
    assert (tv == 1).any() and (tv == -1).any() and (~td).any()
    np.testing.assert_array_equal(tv.numpy()[-4:], [1, 0, -1, 0])                      # the snakes
    np.testing.assert_array_equal(np.asarray(_jax_vmapped("valid_moves")(js)), TG.valid_moves(ts).numpy())
    np.testing.assert_array_equal(np.asarray(_jax_vmapped("to_features")(js)), TG.to_features(ts).numpy())
    np.testing.assert_array_equal(np.zeros(len(boards), np.float32), TG.eval_heuristic(ts).numpy())

    tflat = TOPS.from_state(ts)
    aux = TOPS.aux("cpu")
    fd, fv = TOPS.terminal(tflat, aux)
    np.testing.assert_array_equal(fd.numpy()[:, 0], td.numpy())
    np.testing.assert_array_equal(fv.numpy()[:, 0], tv.numpy())
    vm, vd, vv = TOPS.valid_terminal(tflat, aux)
    assert torch.equal(vd, fd) and torch.equal(vv, fv)
    jflat = JOPS.from_state(js)
    np.testing.assert_array_equal(np.asarray(JOPS.valid(jflat)), vm.numpy())
    jfd, jfv = JOPS.terminal(jflat, JOPS.aux())
    np.testing.assert_array_equal(np.asarray(jfd), fd.numpy())
    np.testing.assert_array_equal(np.asarray(jfv), fv.numpy())
    np.testing.assert_array_equal(np.asarray(JOPS.to_features(jflat)), TOPS.to_features(tflat).numpy())


def test_symmetries_match():
    boards = _positions()[:10]
    rng = np.random.default_rng(0)
    pi = rng.dirichlet(np.ones(49), len(boards)).astype(np.float32)
    feats = np.array(_jax_vmapped("to_features")(hex_jax_state(boards)))
    jf, jp = jax.vmap(JG.symmetries)(jnp.asarray(feats), jnp.asarray(pi))
    tf, tp = TG.symmetries(torch.as_tensor(feats), torch.as_tensor(pi))
    assert tf.shape == (10, 2, 7, 7, 2) and tp.shape == (10, 2, 49)
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())


SEARCH_CFG = JaxMCTSConfig(num_sims=16, max_depth=56)


@lru_cache(maxsize=None)
def _jax_xla_counts_fn():
    search = make_search_fn(JG, jax_uniform(JG).apply_fn, SEARCH_CFG)
    return jax.jit(lambda state: search({}, state).root_counts())


def _port_counts(cfg, boards: np.ndarray) -> np.ndarray:
    root_counts = make_hybrid_root_fn(TG, make_uniform_model(TG).apply_fn, MCTSConfig(**dataclasses.asdict(cfg)))
    return root_counts(torch_state(boards)).numpy()


@pytest.mark.parametrize("moves", [0, 9, 30])
def test_uniform_matches_xla_engine(moves):
    """Uniform searches (B=4, 16 sims) of the port's plain hybrid engine
    equal the jitted JAX XLA engine's, with terminal children near the
    end."""
    boards = random_play_boards(TG, 4, moves, seed=moves)
    np.testing.assert_array_equal(np.asarray(_jax_xla_counts_fn()(hex_jax_state(boards))),
                                  _port_counts(SEARCH_CFG, boards))


def test_reproduces_tpu_golden():
    """``hybrid_hex_uniform_counts_head``: the first 4 positions of
    tests/test_fused.py's generator at 5 moves, seed 15; 16 sims,
    max_depth 56."""
    with open(os.path.join(os.path.dirname(__file__), "tpu_goldens.json")) as f:
        golden = json.load(f)["hybrid_hex_uniform_counts_head"]
    boards = fused_test_positions(TG, 256, 5, seed=15)[:4]
    np.testing.assert_array_equal(_port_counts(SEARCH_CFG, boards), np.asarray(golden))


def test_position_replica_matches_the_jax_generator():
    ref = np.asarray(_random_positions(JG, 256, 5, seed=15).board)
    np.testing.assert_array_equal(ref, fused_test_positions(TG, 256, 5, seed=15))


def _feats(batch: int, moves: int, seed: int) -> np.ndarray:
    boards = random_play_boards(TG, batch, moves, seed=seed)
    return np.stack([(boards == 1), (boards == -1)], axis=-1).astype(np.float32)


def test_az_resnet_forward_matches_flax():
    """AZResNet-16x2 at 49 cells, f32: the folded eval and the
    training-shaped module against flax."""
    variables = random_az_resnet_variables(49, 16, 2, cells=49, seed=7)
    feats = _feats(4, 12, seed=5)
    jax_model = JaxAZResNet(num_actions=49, channels=16, blocks=2, dtype=jnp.float32)
    model = convert_az_resnet(variables, dtype=torch.float32)
    apply_fn = make_apply_fn(model)
    with torch.no_grad():
        pairs = [
            (jax_model.folded_apply(variables, jnp.asarray(feats)), apply_fn(torch.as_tensor(feats))),
            (jax_model.apply(variables, jnp.asarray(feats), train=False), model(torch.as_tensor(feats))),
        ]
    for (jl, jv), (tl, tv) in pairs:
        assert tl.shape == (4, 49) and tv.shape == (4,)
        np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=F32_ATOL, rtol=0)
        np.testing.assert_allclose(np.asarray(jv), tv.numpy(), atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("hidden", [(32, 32), (256, 256)], ids=["32x32", "mlp_preset_256x256"])
def test_mlp_forward_matches_flax(hidden):
    variables = random_mlp_variables(49, hidden, cells=49, seed=len(hidden))
    feats = _feats(16, 10, seed=6)
    jl, jv = JaxMLPNet(num_actions=49, hidden=hidden).apply(variables, jnp.asarray(feats))
    with torch.no_grad():
        tl, tv = make_apply_fn(convert_mlp(variables))(torch.as_tensor(feats))
    assert tl.shape == (16, 49) and tv.shape == (16,)
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=MLP_ATOL, rtol=0)
    np.testing.assert_allclose(np.asarray(jv), tv.numpy(), atol=MLP_ATOL, rtol=0)
