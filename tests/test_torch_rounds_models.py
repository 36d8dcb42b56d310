"""The port's K>1 leaf-parallel rounds with non-uniform models on
Connect-Four, against the JAX hybrid engine's rounds (its round kernels in
the Pallas interpreter): a dyadic linear model, exact in both frameworks,
gives equal root counts; the bf16 AZResNet, whose forward rounds
differently in the two frameworks, is held to the JAX package's
Mosaic-vs-XLA bound (tests/test_fused.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
from alphazero_tpu.games import ConnectFour as JaxConnectFour
from alphazero_tpu.mcts.hybrid import make_hybrid_root_fn as jax_hybrid_root_fn
from alphazero_tpu.models import AZResNet as JaxAZResNet
from alphazero_tpu.models import make_flax_apply_fn
from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.games import ConnectFour
from alphazero_tpu_torch.mcts import make_hybrid_root_fn
from alphazero_tpu_torch.models import convert_az_resnet, make_apply_fn, random_az_resnet_variables
from tests.torch_parity import jax_state, random_boards, torch_state

JG = JaxConnectFour()
TG = ConnectFour()


def _counts(jax_apply, torch_apply, cfg, boards, params=None):
    """(JAX hybrid rounds, port rounds) root counts of ``boards``."""
    jax_fn = jax_hybrid_root_fn(JG, jax_apply, cfg, block_size=len(boards))
    c_jax = np.asarray(jax_fn({} if params is None else params, jax_state(boards)))
    port_fn = make_hybrid_root_fn(TG, torch_apply, MCTSConfig(**dataclasses.asdict(cfg)))
    return c_jax, port_fn(torch_state(boards)).numpy()


def _dyadic_models(seed=0):
    """A linear model with dyadic weights: logits and value are exact in
    both frameworks (0/1 features, sums of multiples of 1/64)."""
    rng = np.random.default_rng(seed)
    wp = (rng.integers(-4, 5, (84, 7)) / 8).astype(np.float32)
    bp = (rng.integers(-4, 5, 7) / 8).astype(np.float32)
    wv = (rng.integers(-2, 3, 84) / 64).astype(np.float32)

    def jax_apply(params, feats):
        x = feats.reshape(feats.shape[0], -1)
        return x @ wp + bp, jnp.clip(x @ wv + 1 / 16, -1.0, 1.0)

    twp, tbp, twv = map(torch.as_tensor, (wp, bp, wv))

    def torch_apply(feats):
        x = feats.reshape(feats.shape[0], -1)
        return x @ twp + tbp, torch.clamp(x @ twv + 1 / 16, -1.0, 1.0)

    torch_apply.needs_features = True
    return jax_apply, torch_apply


def test_dyadic_model_rounds_match_jax_hybrid():
    """A non-uniform prior and value, exact in both frameworks: W backs up
    values of both signs, and the K leaf boards of a round are evaluated in
    one forward of K*B boards stacked K-major."""
    jax_apply, torch_apply = _dyadic_models(seed=3)
    cfg = JaxMCTSConfig(num_sims=24, max_depth=48, parallel_sims=4)
    boards = random_boards(8, 4, seed=6)
    c_jax, got = _counts(jax_apply, torch_apply, cfg, boards)
    np.testing.assert_array_equal(got, c_jax)
    assert (got.max(1) > got.min(1) + 2).any()                    # a non-uniform search


def test_tiny_resnet_rounds_bounded_divergence():
    """bf16 AZResNet-8x1 on the same weights at K=4: sims conserved, most
    games identical, visit distributions close (tests/test_fused.py's
    Mosaic-vs-XLA bound)."""
    variables = random_az_resnet_variables(7, 8, 1, seed=2)
    jax_apply = make_flax_apply_fn(JaxAZResNet(num_actions=7, channels=8, blocks=1))
    torch_apply = make_apply_fn(convert_az_resnet(variables, dtype=torch.bfloat16))
    cfg = JaxMCTSConfig(num_sims=24, max_depth=48, parallel_sims=4)
    boards = random_boards(16, 5, seed=2)
    c_jax, c_port = _counts(jax_apply, torch_apply, cfg, boards, params=variables)
    assert (c_port.sum(1) == c_jax.sum(1)).all()
    assert (c_jax == c_port).all(axis=1).mean() >= 0.75
    p_j = c_jax / np.maximum(c_jax.sum(1, keepdims=True), 1)
    p_p = c_port / np.maximum(c_port.sum(1, keepdims=True), 1)
    assert np.abs(p_j - p_p).max() <= 0.25
