"""Othello's networks and searches with real models in the port, against
the JAX package on the same seeded numpy weights: AZResNet and MLPNet at
Othello's widths (64 cells, 65 actions, a 128-channel tower), the hybrid
engine with a dyadic model, a bf16 AZResNet and an MLPNet against the JAX
hybrid engine in interpret mode, and the self-play ladder's routes.

Tolerances (the reasons are those of tests/test_torch_nets.py and
tests/test_torch_mlp.py):

* f32 forwards: atol 1e-4 on logits and value (convs and matmuls sum in
  different orders); the bf16 MLP forward: atol 1e-3.
* dyadic model: exact counts (its outputs are exact in both frameworks).
* bf16 AZResNet and MLPNet searches: >= 75% of games with identical root
  counts and max |dpi| <= 0.25, the bound the JAX package holds its Mosaic
  kernels to against its XLA engine.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
from alphazero_tpu.games import Othello as JaxOthello
from alphazero_tpu.mcts.hybrid import make_hybrid_root_fn as jax_hybrid_root_fn
from alphazero_tpu.models import AZResNet as JaxAZResNet
from alphazero_tpu.models import MLPNet as JaxMLPNet
from alphazero_tpu.models import make_flax_apply_fn
from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.games import Othello
from alphazero_tpu_torch.mcts import make_fused_root_fn, make_hybrid_root_fn
from alphazero_tpu_torch.models import (
    convert_az_resnet,
    convert_mlp,
    make_apply_fn,
    make_uniform_model,
    random_az_resnet_variables,
    random_mlp_variables,
)
from alphazero_tpu_torch.selfplay import _make_root_counts_fn
from tests.test_torch_othello import _dyadic_models
from tests.torch_parity import othello_jax_state, random_othello_boards, torch_state

F32_ATOL = 1e-4
MLP_ATOL = 1e-3
SAME_GAMES = 0.75
MAX_DPI = 0.25

JG = JaxOthello()
TG = Othello()


def _feats(batch: int, moves: int, seed: int) -> np.ndarray:
    boards = random_othello_boards(batch, moves, seed=seed)
    return np.stack([(boards == 1), (boards == -1)], axis=-1).astype(np.float32)


def test_az_resnet_forward_matches_flax_at_othello_widths():
    """AZResNet-128x2 on 8x8 boards with 65 actions, f32: the folded eval
    and the training-shaped module (real BatchNorm layers, the converted
    policy rows) against flax."""
    variables = random_az_resnet_variables(65, 128, 2, cells=64, seed=4)
    feats = _feats(4, 20, seed=5)
    jax_model = JaxAZResNet(num_actions=65, channels=128, blocks=2, dtype=jnp.float32)
    model = convert_az_resnet(variables, dtype=torch.float32)
    assert model.policy.in_features == 128 and model.value_hidden.in_features == 64
    apply_fn = make_apply_fn(model)
    with torch.no_grad():
        pairs = [
            (jax_model.folded_apply(variables, jnp.asarray(feats)), apply_fn(torch.as_tensor(feats))),
            (jax_model.apply(variables, jnp.asarray(feats), train=False), model(torch.as_tensor(feats))),
        ]
    for (jl, jv), (tl, tv) in pairs:
        assert tl.shape == (4, 65) and tv.shape == (4,)
        np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=F32_ATOL, rtol=0)
        np.testing.assert_allclose(np.asarray(jv), tv.numpy(), atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("hidden", [(32, 32), (512, 512)], ids=["32x32", "mlp_preset_512x512"])
def test_mlp_forward_matches_flax_at_othello_widths(hidden):
    variables = random_mlp_variables(65, hidden, cells=64, seed=len(hidden))
    feats = _feats(16, 14, seed=6)
    jl, jv = JaxMLPNet(num_actions=65, hidden=hidden).apply(variables, jnp.asarray(feats))
    model = convert_mlp(variables)
    assert model.cells == 64
    with torch.no_grad():
        tl, tv = make_apply_fn(model)(torch.as_tensor(feats))
    assert tl.shape == (16, 65) and tv.shape == (16,)
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=MLP_ATOL, rtol=0)
    np.testing.assert_allclose(np.asarray(jv), tv.numpy(), atol=MLP_ATOL, rtol=0)


def _jax_hybrid(jax_apply, params, cfg, boards):
    fn = jax_hybrid_root_fn(JG, jax_apply, cfg, block_size=4)
    return np.asarray(fn(params, othello_jax_state(boards)))


def _port_counts(apply_fn, cfg, boards):
    return make_hybrid_root_fn(TG, apply_fn, MCTSConfig(**dataclasses.asdict(cfg)))(
        torch_state(boards)
    ).numpy()


def _assert_close_searches(ref, got, sims):
    assert (got.sum(1) == sims).all() and (ref.sum(1) == sims).all()
    assert (ref == got).all(axis=1).mean() >= SAME_GAMES
    p_r = ref / ref.sum(1, keepdims=True)
    p_g = got / got.sum(1, keepdims=True)
    assert np.abs(p_r - p_g).max() <= MAX_DPI


def test_dyadic_matches_jax_hybrid_engine_in_interpret_mode():
    """Against the JAX hybrid engine itself (Pallas interpreter on CPU),
    B=4, 10 sims: exact counts."""
    jax_apply, torch_apply = _dyadic_models(seed=1)
    cfg = JaxMCTSConfig(num_sims=10, max_depth=64)
    boards = random_othello_boards(4, 8, seed=7)
    np.testing.assert_array_equal(_jax_hybrid(jax_apply, {}, cfg, boards),
                                  _port_counts(torch_apply, cfg, boards))


def test_tiny_bf16_resnet_bounded_divergence():
    """bf16 AZResNet-8x1 at Othello's widths, the port against the JAX
    hybrid engine on the same weights."""
    variables = random_az_resnet_variables(65, 8, 1, cells=64, seed=2)
    jax_apply = make_flax_apply_fn(JaxAZResNet(num_actions=65, channels=8, blocks=1))
    torch_apply = make_apply_fn(convert_az_resnet(variables, dtype=torch.bfloat16))
    cfg = JaxMCTSConfig(num_sims=12, max_depth=64)
    boards = random_othello_boards(8, 10, seed=2)
    _assert_close_searches(_jax_hybrid(jax_apply, variables, cfg, boards),
                           _port_counts(torch_apply, cfg, boards), 12)


def test_mlp_through_the_hybrid_route_with_cutoffs():
    """MLPNet at 64 cells: the ladder sends it to the hybrid engine (the
    fused engine declines a nonzero-heuristic game), and its counts at
    max_depth 3 stay within the bound of the JAX hybrid engine's."""
    variables = random_mlp_variables(65, (16,), cells=64, seed=3)
    apply_fn = make_apply_fn(convert_mlp(variables))
    cfg = JaxMCTSConfig(num_sims=12, max_depth=3)
    port_cfg = MCTSConfig(**dataclasses.asdict(cfg))
    assert make_fused_root_fn(TG, apply_fn, port_cfg) is None
    boards = random_othello_boards(8, 6, seed=9)
    ref = _jax_hybrid(make_flax_apply_fn(JaxMLPNet(num_actions=65, hidden=(16,))), variables, cfg, boards)
    got = _make_root_counts_fn(TG, apply_fn, port_cfg)(torch_state(boards)).numpy()
    _assert_close_searches(ref, got, 12)


def test_ladder_sends_every_model_to_the_hybrid_engine():
    cfg = MCTSConfig(num_sims=4)
    models = [
        make_uniform_model(TG).apply_fn,
        make_apply_fn(convert_mlp(random_mlp_variables(65, (16,), cells=64))),
        make_apply_fn(convert_az_resnet(random_az_resnet_variables(65, 8, 1, cells=64), dtype=torch.float32)),
    ]
    boards = torch_state(random_othello_boards(2, 4, seed=1))
    for apply_fn in models:
        assert make_fused_root_fn(TG, apply_fn, cfg) is None
        counts = _make_root_counts_fn(TG, apply_fn, cfg)(boards)
        assert counts.shape == (2, 65) and (counts.sum(1) == 4).all()
