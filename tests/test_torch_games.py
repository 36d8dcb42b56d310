"""Connect-Four game ops and FlatOps: the port equals the JAX package
exactly on random-play positions (plus full columns, wins and a draw)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.games import ConnectFour as JaxConnectFour
from alphazero_tpu_torch.games import ConnectFour, Game
from tests.torch_parity import DRAW_BOARD, jax_state, random_boards, torch_state

JG = JaxConnectFour()
TG = ConnectFour()


def _positions():
    """Openings, midgames, finished games, boards played past a win, and
    the draw board."""
    parts = [
        random_boards(8, 0, seed=0),
        random_boards(16, 9, seed=1),
        random_boards(16, 25, seed=2),
        random_boards(16, 40, seed=3),
        random_boards(8, 30, seed=4, freeze_done=False),
        DRAW_BOARD[None],
    ]
    return np.concatenate(parts)


def test_protocol_and_static_fields():
    assert isinstance(TG, Game)
    for name in ("name", "num_actions", "feature_shape", "max_moves", "num_symmetries"):
        assert getattr(TG, name) == getattr(JG, name)
    assert TG.init(3, "cpu").shape == (3, 6, 7) and TG.init(3, "cpu").dtype == torch.int8


def test_step_matches_every_action_including_full_columns():
    boards = _positions()
    for a in range(7):
        acts = np.full(len(boards), a)
        ref = jax.vmap(JG.step)(jax_state(boards), jnp.asarray(acts)).board
        got = TG.step(torch_state(boards), torch.as_tensor(acts))
        np.testing.assert_array_equal(np.asarray(ref), got.numpy(), err_msg=f"action {a}")


def test_valid_terminal_features_match():
    boards = _positions()
    js, ts = jax_state(boards), torch_state(boards)
    np.testing.assert_array_equal(np.asarray(jax.vmap(JG.valid_moves)(js)), TG.valid_moves(ts).numpy())
    jd, jv = jax.vmap(JG.terminal)(js)
    td, tv = TG.terminal(ts)
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    assert jd.any() and (np.asarray(jv) != 0).any()       # wins are covered
    assert td[-1] and tv[-1].item() == 0.0                  # the exact-0 draw
    np.testing.assert_array_equal(np.asarray(jax.vmap(JG.to_features)(js)), TG.to_features(ts).numpy())


def test_symmetries_match():
    boards = random_boards(6, 11, seed=7)
    feats = np.array(jax.vmap(JG.to_features)(jax_state(boards)))
    pi = np.random.default_rng(0).random((6, 7)).astype(np.float32)
    jf, jp = jax.vmap(JG.symmetries)(jnp.asarray(feats), jnp.asarray(pi))
    tf, tp = TG.symmetries(torch.as_tensor(feats), torch.as_tensor(pi))
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())


def test_flat_ops_match():
    boards = _positions()
    jops, tops = JG.flat_ops(), TG.flat_ops()
    np.testing.assert_array_equal(np.asarray(jops.aux()), tops.aux("cpu").numpy())
    jb = jops.from_state(jax_state(boards))
    tb = tops.from_state(torch_state(boards))
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
    for a in range(7):
        col = np.full((len(boards), 1), float(a), np.float32)
        np.testing.assert_array_equal(
            np.asarray(jops.step(jb, jnp.asarray(col))),
            tops.step(tb, torch.as_tensor(col)).numpy(),
            err_msg=f"action {a}",
        )
    np.testing.assert_array_equal(np.asarray(jops.valid(jb)), tops.valid(tb).numpy())
    np.testing.assert_array_equal(np.asarray(jops.to_features(jb)), tops.to_features(tb).numpy())
    jd, jv = jops.terminal(jb, jops.aux())
    td, tv = tops.terminal(tb, tops.aux("cpu"))
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


@pytest.mark.parametrize("seed", [11, 12])
def test_flat_step_chain_matches_game_step(seed):
    """A whole random game through FlatOps.step stays equal to
    ConnectFour.step (flat layout row-major, row 5 on top)."""
    rng = np.random.default_rng(seed)
    tops = TG.flat_ops()
    state = TG.init(4, "cpu")
    flat = tops.from_state(state)
    for _ in range(20):
        acts = rng.integers(0, 7, 4)
        state = TG.step(state, torch.as_tensor(acts))
        flat = tops.step(flat, torch.as_tensor(acts, dtype=torch.float32)[:, None])
        np.testing.assert_array_equal(tops.from_state(state).numpy(), flat.numpy())
