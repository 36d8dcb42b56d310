"""The port's arena on Othello against the JAX ``make_arena_fn``, on the
CPU: 65 actions with a pass move, games of up to ``max_moves`` = 96 moves
(the count of those left unfinished is part of the result). The JAX tie
uniforms are replayed into the port, its kernels' plain versions search,
and the results must be equal (the exact chain: the engines' root counts
agree exactly). Asymmetric budgets are held on Gomoku and Hex
(``tests/test_torch_coach_gomoku.py``, ``_hex.py``); each jitted JAX
Othello arena compiles for ~30 s on the CPU, so this file keeps two."""

import jax
import jax.numpy as jnp
import pytest
import torch

from alphazero_tpu.games import Othello as JaxOthello
from alphazero_tpu.models import make_uniform_model as jax_uniform
from alphazero_tpu.models.nets import MLPNet as JaxMLPNet
from alphazero_tpu_torch.games import Othello
from alphazero_tpu_torch.models import convert_mlp, make_uniform_model, order_free_mlp_variables
from tests.torch_parity import arena_both

G, JG = Othello(), JaxOthello()
A = G.num_actions


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_uniform_vs_uniform_equals_jax():
    ju = jax_uniform(JG).apply_fn
    uni = make_uniform_model(G)
    want, got = arena_both(JG, G, ju, ju, uni, uni, 8, seed=3, num_sims=4, max_depth=16)
    assert got == want and sum(got) == 8


def test_order_free_mlp_vs_uniform_combined_forward_equals_jax():
    """An MLPNet with dyadic weights (exact partial sums) against uniform:
    the hybrid engine on the combined forward, both models evaluating
    every leaf batch."""
    hidden = (32,)
    variables = order_free_mlp_variables(A, hidden, cells=64, seed=1)
    jnet = JaxMLPNet(num_actions=A, hidden=hidden)
    jparams = jax.tree_util.tree_map(jnp.asarray, variables)
    want, got = arena_both(JG, G, lambda p, f: jnet.apply(p, f), jax_uniform(JG).apply_fn,
                           convert_mlp(variables), make_uniform_model(G), 4, seed=5,
                           jax_params=(jparams, {}), num_sims=4, max_depth=16)
    assert got == want and sum(got) == 4
