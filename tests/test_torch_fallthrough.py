"""Configurations the JAX engine ladder runs on its fused kernel and the
port's fused kernels do not take: an MLPNet wider than the in-kernel
evaluator and a flat-ops game other than Connect-Four at A <= 16
(``Gomoku(4, 4)``). ``make_fused_root_fn`` declines them and the port's
ladder runs the hybrid engine, held to the JAX fused kernel (the Pallas
interpreter, blocks of 4 games, as tests/test_fused.py runs it) on the same
boards and injected Dirichlet draws: exactly for the uniform model; for the
MLP within the bound the JAX package holds its Mosaic kernel to against
its XLA engine (>= 75% of games identical, max |dpi| <= 0.25), since bf16
products round at other places. And Gomoku above 256 cells, which the
descends' 8-word boards take: a search held to the JAX hybrid engine in
interpret mode, exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
from alphazero_tpu.games import ConnectFour as JaxConnectFour
from alphazero_tpu.games import Gomoku as JaxGomoku
from alphazero_tpu.mcts.fused import make_fused_root_fn as jax_fused_root_fn
from alphazero_tpu.mcts.hybrid import make_hybrid_root_fn as jax_hybrid_root_fn
from alphazero_tpu.models import MLPNet as JaxMLPNet
from alphazero_tpu.models import make_flax_apply_fn
from alphazero_tpu.models import make_uniform_model as jax_uniform
from alphazero_tpu_torch import kernels
from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.games import ConnectFour, Gomoku
from alphazero_tpu_torch.mcts import make_fused_root_fn
from alphazero_tpu_torch.models import convert_mlp, make_apply_fn, make_uniform_model, random_mlp_variables
from alphazero_tpu_torch.selfplay import _make_root_counts_fn
from tests.torch_parity import gomoku_jax_state, jax_state, random_boards, random_play_boards, torch_state

SAME_GAMES = 0.75
MAX_DPI = 0.25
WIDE = (512,)


def _dirichlet(key, batch: int, actions: int, alpha: float):
    """The root noise JAX's ``root_prior`` draws from ``key``."""
    return jax.random.dirichlet(key, jnp.full((actions,), alpha), (batch,))


def test_fused_engine_declines_and_the_ladder_runs_hybrid():
    wide = make_apply_fn(convert_mlp(random_mlp_variables(7, WIDE, seed=0)))
    g4 = Gomoku(4, 4)
    uni = make_uniform_model(g4).apply_fn
    cfg = MCTSConfig(num_sims=8)
    assert make_fused_root_fn(ConnectFour(), wide, cfg) is None
    assert make_fused_root_fn(g4, uni, cfg) is None
    for game, apply_fn in ((ConnectFour(), wide), (g4, uni)):
        assert _make_root_counts_fn(game, apply_fn, cfg).__qualname__.startswith("make_hybrid_root_fn.")
    # the JAX fused engine takes both (tests pass it a block size off the TPU)
    assert jax_fused_root_fn(JaxGomoku(4, 4), jax_uniform(JaxGomoku(4, 4)).apply_fn, JaxMCTSConfig(num_sims=8),
                             block_size=4) is not None


def test_gomoku4_ladder_equals_jax_fused_kernel():
    """Uniform Gomoku(4, 4), 16 sims, Dirichlet 1.0 (JAX's own draws):
    root counts exactly the JAX fused kernel's."""
    jg, tg = JaxGomoku(4, 4), Gomoku(4, 4)
    jcfg = JaxMCTSConfig(num_sims=16, max_depth=16, dirichlet_alpha=1.0)
    boards = random_play_boards(tg, 8, 5, seed=4)
    key = jax.random.key(11)
    ref = np.asarray(jax_fused_root_fn(jg, jax_uniform(jg).apply_fn, jcfg, block_size=4)(
        {}, gomoku_jax_state(boards), key))
    kernels.reset_launch_counts()
    got = _make_root_counts_fn(tg, make_uniform_model(tg).apply_fn, MCTSConfig(**dataclasses.asdict(jcfg)))(
        torch_state(boards), torch.as_tensor(np.array(_dirichlet(key, 8, 16, 1.0))))
    np.testing.assert_array_equal(ref, got.numpy())
    live = ~tg.terminal(torch_state(boards))[0]
    assert (got.sum(1)[live] == 16).all() and live.any()
    assert all(v == 0 for v in kernels.launch_counts().values())   # CPU tensors: the plain versions


def test_wide_mlp_ladder_close_to_jax_fused_kernel():
    """MLPNet (512,) on Connect-Four, 24 sims, Dirichlet 1.0: the port's
    ladder (hybrid engine, the library forward) against the JAX fused
    kernel's in-kernel MLP, within the Mosaic-vs-XLA bound."""
    jg, tg = JaxConnectFour(), ConnectFour()
    jcfg = JaxMCTSConfig(num_sims=24, max_depth=48, dirichlet_alpha=1.0)
    variables = random_mlp_variables(7, WIDE, seed=5)
    boards = random_boards(16, 6, seed=8)
    key = jax.random.key(3)
    jax_apply = make_flax_apply_fn(JaxMLPNet(num_actions=7, hidden=WIDE))
    ref = np.asarray(jax_fused_root_fn(jg, jax_apply, jcfg, block_size=4)(variables, jax_state(boards), key))
    got = _make_root_counts_fn(tg, make_apply_fn(convert_mlp(variables)), MCTSConfig(**dataclasses.asdict(jcfg)))(
        torch_state(boards), torch.as_tensor(np.array(_dirichlet(key, 16, 7, 1.0)))).numpy()
    assert (got.sum(1) == 24).all() and (ref.sum(1) == 24).all()
    assert (ref == got).all(axis=1).mean() >= SAME_GAMES
    dpi = np.abs(ref / ref.sum(1, keepdims=True) - got / got.sum(1, keepdims=True)).max()
    assert dpi <= MAX_DPI


def test_gomoku17_matches_jax_hybrid_engine():
    """Gomoku 17 (289 cells: 5 of the descends' 8 words), uniform,
    B=4, 8 sims: root counts exactly the JAX hybrid engine's in interpret
    mode."""
    jg, tg = JaxGomoku(17), Gomoku(17)
    jcfg = JaxMCTSConfig(num_sims=8, max_depth=32)
    boards = random_play_boards(tg, 4, 40, seed=17)
    ref = np.asarray(jax_hybrid_root_fn(jg, jax_uniform(jg).apply_fn, jcfg, block_size=4)(
        {}, gomoku_jax_state(boards)))
    assert kernels.descend_entry(tg.flat_ops()) == "az_descend_gomoku"
    got = _make_root_counts_fn(tg, make_uniform_model(tg).apply_fn, MCTSConfig(**dataclasses.asdict(jcfg)))(
        torch_state(boards))
    np.testing.assert_array_equal(ref, got.numpy())
    assert (got.sum(1) == 8).all()
