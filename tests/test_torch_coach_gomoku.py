"""The port's arena and coach on Gomoku 9 against the JAX package's, on the
CPU (``tests/test_torch_arena.py`` and ``tests/test_torch_coach.py`` hold
them on Connect-Four).

Arenas: uniform against uniform, an order-free MLPNet against uniform on
the combined forward, and asymmetric budgets; the JAX tie uniforms are
replayed into the port, its kernels' plain versions search, and the
results must be equal, ``unfinished`` included (the exact chain: the
engines' root counts agree exactly). The coach: ``torch_parity.outer_cfg``
(continuous mode, a warmup anchored pass, a pool cross match) for three
iterations in each package, the JAX one in a module fixture: the records'
keys, the ring holding every move once per symmetry (8 on Gomoku), the
adoptions, and the anchored match graph's players and game totals. The
two packages draw different random numbers, so wins differ; the
structure may not."""

import jax
import jax.numpy as jnp
import pytest
import torch

from alphazero_tpu.games import Gomoku as JaxGomoku
from alphazero_tpu.models import make_uniform_model as jax_uniform
from alphazero_tpu.models.nets import MLPNet as JaxMLPNet
from alphazero_tpu_torch.games import Gomoku
from alphazero_tpu_torch.models import convert_mlp, make_uniform_model, order_free_mlp_variables
from tests.torch_parity import (
    arena_both,
    check_continuous,
    check_match_graph,
    check_record_keys,
    check_replay_holds_the_symmetries,
    coach_runs,
)

G, JG = Gomoku(9), JaxGomoku(9)
A, CELLS = G.num_actions, 81


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
    assert got == want
    assert sum(got) == 8 and got.unfinished == 0


def test_order_free_mlp_vs_uniform_combined_forward_equals_jax():
    hidden = (32,)
    variables = order_free_mlp_variables(A, hidden, cells=CELLS, seed=1)
    jnet = JaxMLPNet(num_actions=A, hidden=hidden)
    jparams = jax.tree_util.tree_map(jnp.asarray, variables)
    want, got = arena_both(JG, G, lambda p, f: jnet.apply(p, f), jax_uniform(JG).apply_fn,
                           convert_mlp(variables), make_uniform_model(G), 4, seed=5,
                           jax_params=(jparams, {}), num_sims=4, max_depth=16)
    assert got == want and sum(got) == 4


def test_asymmetric_budgets_equal_jax():
    ju = jax_uniform(JG).apply_fn
    uni = make_uniform_model(G)
    want, got = arena_both(JG, G, ju, ju, uni, uni, 4, seed=2, num_sims=2, max_depth=16,
                           inc={"num_sims": 16})
    assert got == want


@pytest.fixture(scope="module")
def runs():
    return coach_runs(JG, G, 3)


def test_record_keys_equal_jax(runs):
    check_record_keys(*runs)


def test_replay_holds_every_move_eight_times(runs):
    for run in runs:
        check_replay_holds_the_symmetries(run, 8)


def test_continuous_mode_always_adopts(runs):
    check_continuous(*runs)


def test_anchored_match_graph_structure_equals_jax(runs):
    check_match_graph(*runs)
