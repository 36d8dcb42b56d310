"""ops/policy.py: the port's masked_policy, action_probs and root_prior
equal the JAX ones (rtol 1e-6) when the port is handed JAX's own draws."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
from alphazero_tpu.games import ConnectFour as JaxConnectFour
from alphazero_tpu.models import make_uniform_model as jax_uniform
from alphazero_tpu.ops import action_probs as jax_action_probs
from alphazero_tpu.ops import masked_policy as jax_masked_policy
from alphazero_tpu.ops import root_prior as jax_root_prior
from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.games import ConnectFour
from alphazero_tpu_torch.models import make_uniform_model
from alphazero_tpu_torch.ops import action_probs, masked_policy, root_prior, sample_draws
from tests.torch_parity import jax_state, random_boards, torch_state

RTOL = 1e-6  # exp/log/pow of the two libraries may differ in the last ulp


def _close(jax_out, torch_out):
    np.testing.assert_allclose(np.asarray(jax_out), torch_out.numpy(), rtol=RTOL, atol=0)


def test_masked_policy_matches():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((64, 7)) * 3).astype(np.float32)
    logits[0] = 200.0                                 # saturating logits
    valid = rng.random((64, 7)) < 0.6
    valid[1] = False                                  # nothing valid
    valid[2] = [True] + [False] * 6                   # one valid action
    _close(
        jax_masked_policy(jnp.asarray(logits), jnp.asarray(valid)),
        masked_policy(torch.as_tensor(logits), torch.as_tensor(valid)),
    )


@pytest.mark.parametrize("temp", [0.0, 1.0, 0.5, "per_row"])
def test_action_probs_matches_with_injected_tie_uniforms(temp):
    rng = np.random.default_rng(1)
    counts = rng.integers(0, 5, (64, 7)).astype(np.float32)   # many ties
    counts[0] = 0.0
    if temp == "per_row":
        temp = rng.choice([0.0, 1.0, 0.25], 64).astype(np.float32)
    key = jax.random.key(3)
    u = np.array(jax.random.uniform(key, counts.shape))
    _close(
        jax_action_probs(jnp.asarray(counts), jnp.asarray(temp), key),
        action_probs(torch.as_tensor(counts), torch.as_tensor(np.asarray(temp, np.float32)), torch.as_tensor(u)),
    )


@pytest.mark.parametrize("alpha", [None, 0.3, 1.0])
def test_root_prior_matches_with_injected_dirichlet(alpha):
    boards = random_boards(32, 12, seed=4)
    jcfg = JaxMCTSConfig(dirichlet_alpha=alpha, dirichlet_frac=0.25)
    cfg = MCTSConfig(**dataclasses.asdict(jcfg))
    key = jax.random.key(5)
    jg, tg = JaxConnectFour(), ConnectFour()
    jp, jv = jax_root_prior(jg, jax_uniform(jg).apply_fn, jcfg, {}, jax_state(boards), key)
    noise = None
    if alpha is not None:
        noise = torch.as_tensor(np.array(jax.random.dirichlet(key, jnp.full((7,), alpha), (32,))))
    tp, tv = root_prior(tg, make_uniform_model(tg).apply_fn, cfg, torch_state(boards), noise)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    _close(jp, tp)
    if alpha is not None:
        with pytest.raises(ValueError):
            root_prior(tg, make_uniform_model(tg).apply_fn, cfg, torch_state(boards), None)


def test_jax_categorical_is_argmax_of_logits_plus_gumbel():
    """The actor replaces jax.random.categorical with argmax(logits +
    gumbel); in this JAX version they are the same draw on the same key."""
    logits = jnp.log(jax.random.uniform(jax.random.key(0), (256, 7)) + 1e-12)
    for k in range(4):
        key = jax.random.key(100 + k)
        a = jax.random.categorical(key, logits, axis=-1)
        b = jnp.argmax(logits + jax.random.gumbel(key, logits.shape), axis=-1)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("alpha", [0.3, 1.0])
def test_sample_draws(alpha):
    gen = torch.Generator().manual_seed(0)
    d = sample_draws(gen, 4096, 7, alpha, "cpu")
    assert d.dirichlet.shape == d.tie.shape == d.gumbel.shape == (4096, 7)
    assert (d.dirichlet > 0).all() and torch.allclose(d.dirichlet.sum(1), torch.ones(4096))
    # Dirichlet(alpha * 1): each component has mean 1/7 and variance
    # (1/7)(6/7)/(7 alpha + 1)
    var = (1 / 7) * (6 / 7) / (7 * alpha + 1)
    assert abs(float(d.dirichlet.mean()) - 1 / 7) < 1e-3
    assert abs(float(d.dirichlet.var()) - var) < 0.1 * var
    assert ((d.tie >= 0) & (d.tie < 1)).all()
    assert abs(float(d.gumbel.mean()) - 0.5772) < 0.05     # Euler-Mascheroni
    again = sample_draws(torch.Generator().manual_seed(0), 4096, 7, alpha, "cpu")
    assert torch.equal(d.dirichlet, again.dirichlet) and torch.equal(d.gumbel, again.gumbel)
    assert sample_draws(gen, 8, 7, None, "cpu").dirichlet is None
