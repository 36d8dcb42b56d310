"""The port's learner against the JAX package's ``train.make_train_step``:
one step from the same converted weights on the same minibatch gives the
same loss terms, gradients (Adam's first moment, a tenth of the gradient
after one step), updated parameters and BatchNorm running statistics.

Two levels. f32: flax ``AZResNet(dtype=float32)`` and ``MLPNet(dtype=
float32)`` against the port's at f32 (one block of 8 channels; hidden
(32, 32)): loss terms within rtol 1e-5; gradients within rtol 1e-5 plus
1e-5 of the tensor's largest; parameters within rtol 1e-5 plus 1e-6,
except where the reference's gradient is below 1e-4 of its tensor's
largest: Adam divides each entry's step by its own |g| + 1e-8, so there a
rounding of the gradient can turn the step's sign, and those entries are
held within 2 lr; running statistics within rtol 1e-5. bf16: the flax
default bf16 models with random weights, where XLA and torch round the
bf16 products differently: loss terms within rtol 2e-2, >= 95% of the
parameter entries within half a learning rate of the reference's (an Adam
step moves an entry by about one learning rate, so this asks the two
updates to agree in sign; the reference's own bf16 step turns the sign of
its f32 step on 2.6% of the AZResNet's entries here, and the port's bf16
step disagrees with the reference's bf16 step on 2.4%), running
statistics within rtol 1e-3 plus 1e-4.

Then the loop: a train phase on a ring filled by self-play, and the actor
following the trained weights on its next call (the AZResNet refolded,
the MLPNet's kernel weights repacked)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.config import TrainConfig as JaxTrainConfig
from alphazero_tpu.models import AZResNet as JaxAZResNet
from alphazero_tpu.models import MLPNet as JaxMLPNet
from alphazero_tpu.train import TrainState as JaxTrainState
from alphazero_tpu.train import make_optimizer as jax_make_optimizer
from alphazero_tpu.train import make_train_step as jax_make_train_step
from alphazero_tpu_torch.config import MCTSConfig, ReplayConfig, SelfPlayConfig, TrainConfig
from alphazero_tpu_torch.games import ConnectFour
from alphazero_tpu_torch.models import (
    convert_az_resnet,
    convert_mlp,
    make_apply_fn,
    random_az_resnet_variables,
    random_mlp_variables,
)
from alphazero_tpu_torch.models.convert import az_resnet_state_dict, mlp_state_dict
from alphazero_tpu_torch.ops import action_probs, sample_draws
from alphazero_tpu_torch.replay import replay_init, replay_insert
from alphazero_tpu_torch.selfplay import (
    _make_root_counts_fn,
    make_recycling_selfplay_fn,
)
from alphazero_tpu_torch.train import (
    init_train_state,
    loss_terms,
    make_train_phase,
    make_train_step,
)
from tests.torch_parity import random_boards

GAME = ConnectFour()
N = 32   # minibatch rows


def _batch(seed: int):
    """Features of random-play boards, policy targets (rows 3 and 7
    value-only: all-zero), values in {-1, 0, 1}."""
    rng = np.random.default_rng(seed)
    boards = random_boards(N, int(rng.integers(4, 20)), seed=seed)
    feats = GAME.to_features(torch.as_tensor(boards)).numpy()
    pi = rng.dirichlet(np.ones(7), N).astype(np.float32)
    pi[[3, 7]] = 0.0
    v = rng.choice(np.array([-1.0, 0.0, 1.0], np.float32), N)
    return feats, pi, v


def _models(kind: str, level: str, seed: int = 0):
    """``(flax module, flax variables, port module)`` with the same weights."""
    jdt, tdt = (jnp.float32, torch.float32) if level == "f32" else (jnp.bfloat16, torch.bfloat16)
    if kind == "resnet":
        channels = 8 if level == "f32" else 16
        variables = random_az_resnet_variables(7, channels, 1, seed=seed)
        jm = JaxAZResNet(num_actions=7, channels=channels, blocks=1, dtype=jdt)
        return jm, variables, convert_az_resnet(variables, dtype=tdt)
    variables = random_mlp_variables(7, (32, 32), seed=seed)
    return JaxMLPNet(num_actions=7, hidden=(32, 32), dtype=jdt), variables, convert_mlp(variables, tdt)


def _state_dict(kind: str, params, batch_stats) -> dict:
    tree = jax.device_get({"params": params, "batch_stats": batch_stats})
    sd = az_resnet_state_dict(tree) if kind == "resnet" else mlp_state_dict(tree)
    return {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}


def _adam_mu(kind, jstate, tstate) -> tuple:
    """Adam's first moments, ``(jax, port)`` by state-dict name: a tenth
    of the gradient after the first step."""
    mu = next(s.mu for s in jstate.opt_state if hasattr(s, "mu"))
    jmu = _state_dict(kind, mu, jstate.batch_stats)
    opt = tstate.optimizer
    return jmu, {n: opt.state[p]["exp_avg"] for n, p in tstate.model.named_parameters()}


def _step_both(kind, level, tcfg: TrainConfig, seed: int = 10):
    """One step of each package: ``(jax metrics, port metrics, jax state
    dict, port state dict, jax Adam mu, port Adam mu)``."""
    jm, variables, model = _models(kind, level)
    jcfg = JaxTrainConfig(**dataclasses.asdict(tcfg))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables.get("batch_stats", {}))
    jstate = JaxTrainState(params, stats, jax_make_optimizer(jcfg).init(params), jnp.zeros((), jnp.int32))
    jstep = jax.jit(jax_make_train_step(jm, jcfg))
    tstate = init_train_state(model, tcfg)
    tstep = make_train_step(tcfg)
    feats, pi, v = _batch(seed)
    jstate, jmet = jstep(jstate, jnp.asarray(feats), jnp.asarray(pi), jnp.asarray(v), jax.random.key(0))
    tstate, tmet = tstep(tstate, *(torch.as_tensor(x) for x in (feats, pi, v)))
    assert tstate.step == int(jstate.step) == 1
    tsd = {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    return (jmet, tmet, _state_dict(kind, jstate.params, jstate.batch_stats), tsd,
            *_adam_mu(kind, jstate, tstate))


CASES = [("resnet", TrainConfig()), ("mlp", TrainConfig()),
         ("mlp", TrainConfig(weight_decay=1e-2, l2_scale=0.0))]


@pytest.mark.parametrize("kind,tcfg", CASES, ids=["resnet", "mlp", "mlp-adamw-no-l2"])
def test_train_step_matches_jax_f32(kind, tcfg):
    jmet, tmet, jsd, tsd, jmu, tmu = _step_both(kind, "f32", tcfg)
    for name, j, t in zip(jmet._fields, jmet, tmet):
        np.testing.assert_allclose(float(t), float(j), rtol=1e-5, atol=1e-7, err_msg=name)
    assert jsd.keys() == tsd.keys() and tmu.keys() <= jsd.keys()
    lr = tcfg.learning_rate
    for k in jsd:
        want, got = jsd[k].numpy(), tsd[k].numpy()
        if k not in tmu:   # running statistics
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=0, err_msg=k)
            continue
        mu = jmu[k].numpy()
        big = np.abs(mu).max()
        np.testing.assert_allclose(tmu[k].numpy(), mu, rtol=1e-5, atol=1e-5 * big, err_msg=f"{k} grad")
        steep = np.abs(mu) < 1e-4 * big
        np.testing.assert_allclose(got[~steep], want[~steep], rtol=1e-5, atol=1e-6, err_msg=k)
        assert (np.abs(got - want)[steep] <= 2 * lr).all(), k


@pytest.mark.parametrize("kind", ["resnet", "mlp"])
def test_train_step_matches_jax_bf16(kind):
    lr = TrainConfig().learning_rate
    jmet, tmet, jsd, tsd, _, tmu = _step_both(kind, "bf16", TrainConfig())
    for name, j, t in zip(jmet._fields, jmet, tmet):
        np.testing.assert_allclose(float(t), float(j), rtol=2e-2, err_msg=name)
    near = total = 0
    for k in jsd:
        d = np.abs(tsd[k].numpy() - jsd[k].numpy())
        if k not in tmu:   # running statistics
            np.testing.assert_allclose(tsd[k].numpy(), jsd[k].numpy(), rtol=1e-3, atol=1e-4, err_msg=k)
        else:
            near += int((d <= lr / 2).sum())
            total += d.size
    assert near >= 0.95 * total, f"{total - near} of {total} entries off by > lr/2"


def test_value_only_rows_carry_no_policy_loss():
    """Rows whose target sums to 0 add nothing to the policy loss, and the
    normaliser counts only the others."""
    _, _, model = _models("mlp", "f32")
    feats, pi, v = (torch.as_tensor(x) for x in _batch(seed=3))
    full = loss_terms(model, TrainConfig(), feats, pi, v)
    keep = pi.sum(-1) > 0.5
    part = loss_terms(model, TrainConfig(), feats[keep], pi[keep], v[keep])
    torch.testing.assert_close(full.policy_loss, part.policy_loss, rtol=1e-6, atol=0)


def test_init_train_state_refuses_low_precision_parameters():
    _, _, model = _models("mlp", "f32")
    with pytest.raises(ValueError, match="f32 parameters"):
        init_train_state(model.to(torch.bfloat16), TrainConfig())


@pytest.mark.parametrize("kind", ["resnet", "mlp"])
def test_actor_follows_the_trained_weights(kind):
    """One recycling call fills a ring, a train phase takes two steps at a
    large learning rate, and the next call's first search is the search of
    a fresh ``make_apply_fn`` of the trained model (the AZResNet refolded,
    the MLPNet repacked), not of the weights the actor played before."""
    _, _, model = _models(kind, "bf16", seed=4)
    cfg = MCTSConfig(num_sims=8, max_depth=48, dirichlet_alpha=1.0)
    sp = SelfPlayConfig(batch_size=8, temp_threshold=15, recycle=True)
    init, play = make_recycling_selfplay_fn(GAME, cfg, sp, device="cpu")
    gen = torch.Generator().manual_seed(0)
    steps = [sample_draws(gen, 8, 7, 1.0, "cpu") for _ in range(2 * GAME.max_moves)]
    carry, traj, _ = play(model, init(), lambda t: steps[t])
    ring = replay_insert(replay_init(GAME, ReplayConfig(capacity=4096), device="cpu"), GAME, traj)
    before = _make_root_counts_fn(GAME, make_apply_fn(model), cfg)(carry.state, steps[42].dirichlet)

    tcfg = TrainConfig(batch_size=64, learning_rate=0.05)
    tstate, losses = make_train_phase(tcfg, 2, GAME)(init_train_state(model, tcfg), ring,
                                                     torch.Generator().manual_seed(1))
    assert losses.shape == (2,) and torch.isfinite(losses).all() and tstate.step == 2
    after = _make_root_counts_fn(GAME, make_apply_fn(model), cfg)(carry.state, steps[42].dirichlet)
    assert not torch.equal(before, after)      # the trained weights search otherwise
    _, traj2, _ = play(model, carry, lambda t: steps[42 + t])
    temp = (carry.move_count < sp.temp_threshold).float()
    torch.testing.assert_close(traj2.pi[GAME.max_moves], action_probs(after, temp, steps[42].tie),
                               rtol=0, atol=0)
