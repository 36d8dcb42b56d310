"""models/nets.py's ``AZConvNet`` (the ``convnet`` preset's net) and its
converter against the flax ``AZConvNet``, and the learner's dropout.

The same seeded numpy weights (``random_az_convnet_variables``: a flax
``{'params', 'batch_stats'}`` tree with non-trivial BatchNorm statistics)
go through the JAX model and, via ``convert_az_convnet``, the port, at 16
channels on the Connect-Four board (``Dense_0`` reads 2*3*16 = 96 rows).
Tolerances:

* f32 (eval forward, folded forward, folded against unfolded): atol 1e-4
  on logits and value, as ``tests/test_torch_nets.py``: the convs and
  matmuls sum in other orders; nothing else differs.
* bf16 eval and folded forwards: atol 0.1, the AZResNet's bf16 bound
  (single bf16-ulp flips of the products accumulate through the layers).
* one f32 learner step with the JAX step's dropout masks replayed into the
  port: ``tests/test_torch_train.py``'s f32 bounds (loss terms rtol 1e-5;
  Adam's first moment, a tenth of the gradient, rtol 1e-5 plus 1e-5 of the
  tensor's largest; parameters rtol 1e-5 plus 1e-6 except where the
  reference's gradient is below 1e-4 of its largest, there within 2 lr);
  running statistics rtol 1e-5 plus 1e-7 (the dense BatchNorms' running
  means hold entries near 0, where a batch mean's last-bit rounding, ~1e-8
  on means of magnitude ~0.1, exceeds any relative bound).

The masks: flax's ``Dropout`` draws ``jax.random.bernoulli(rng, 0.7,
shape)`` from the key its ``make_rng("dropout")`` derives from the step's
``rngs={"dropout": rng}``; the test records each call's key and shape in
an eager run of the step's training forward on the same key, recomputes
the masks from them, and passes them to the port's step, which it holds
against the jitted JAX step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.config import TrainConfig as JaxTrainConfig
from alphazero_tpu.models.nets import AZConvNet as JaxAZConvNet
from alphazero_tpu.train import TrainState as JaxTrainState
from alphazero_tpu.train import make_optimizer as jax_make_optimizer
from alphazero_tpu.train import make_train_step as jax_make_train_step
from alphazero_tpu_torch.config import ReplayConfig, TrainConfig
from alphazero_tpu_torch.games import ConnectFour
from alphazero_tpu_torch.models import (
    AZConvNet,
    AZResNet,
    FoldedAZConvNet,
    MLPNet,
    az_convnet_state_dict,
    convert_az_convnet,
    is_folded,
    make_apply_fn,
    random_az_convnet_variables,
)
from alphazero_tpu_torch.models.convert import policy_row_perm
from alphazero_tpu_torch.replay import replay_init, replay_insert, replay_sample
from alphazero_tpu_torch.selfplay import Trajectory
from alphazero_tpu_torch.train import init_train_state, make_train_phase, make_train_step
from tests.torch_parity import random_boards

GAME = ConnectFour()
A = GAME.num_actions
CH = 16
F32_ATOL = 1e-4
BF16_ATOL = 0.1
N = 32   # minibatch rows


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _feats(batch: int, seed: int) -> np.ndarray:
    boards = random_boards(batch, 14, seed=seed)
    return np.stack([(boards == 1), (boards == -1)], axis=-1).astype(np.float32)


def _jax(dtype):
    return JaxAZConvNet(num_actions=A, channels=CH, dtype=dtype)


def _bound(jl, jv, tl, tv, atol):
    dl = float(np.abs(np.asarray(jl) - tl.numpy()).max())
    dv = float(np.abs(np.asarray(jv) - tv.numpy()).max())
    assert max(dl, dv) <= atol, f"|dlogits|={dl:.4g} |dvalue|={dv:.4g}"


@pytest.mark.parametrize("level", ["f32", "bf16"])
def test_eval_forward_matches_flax(level):
    jdt, tdt, atol = ((jnp.float32, torch.float32, F32_ATOL) if level == "f32"
                      else (jnp.bfloat16, torch.bfloat16, BF16_ATOL))
    variables = random_az_convnet_variables(A, CH, seed=1)
    feats = _feats(8, seed=2)
    jl, jv = _jax(jdt).apply(variables, jnp.asarray(feats), train=False)
    model = convert_az_convnet(variables, dtype=tdt)
    with torch.no_grad():
        tl, tv = model(torch.as_tensor(feats))
    assert tl.dtype == tv.dtype == torch.float32 and tl.shape == (8, A) and tv.shape == (8,)
    _bound(jl, jv, tl, tv, atol)


@pytest.mark.parametrize("level", ["f32", "bf16"])
def test_folded_forward_matches_folded_apply(level):
    jdt, tdt, atol = ((jnp.float32, torch.float32, F32_ATOL) if level == "f32"
                      else (jnp.bfloat16, torch.bfloat16, BF16_ATOL))
    variables = random_az_convnet_variables(A, CH, seed=3)
    feats = _feats(8, seed=4)
    jl, jv = _jax(jdt).folded_apply(variables, jnp.asarray(feats))
    net = convert_az_convnet(variables, dtype=tdt)
    apply_fn = make_apply_fn(net)
    assert apply_fn.needs_features and is_folded(net)
    tl, tv = apply_fn(torch.as_tensor(feats))
    assert tl.dtype == tv.dtype == torch.float32
    _bound(jl, jv, tl, tv, atol)


def test_fold_matches_unfolded_module():
    net = convert_az_convnet(random_az_convnet_variables(A, CH, seed=5), dtype=torch.float32)
    feats = torch.as_tensor(_feats(8, seed=6))
    folded = net.fold()
    assert isinstance(folded, FoldedAZConvNet)
    with torch.no_grad():
        ul, uv = net(feats)
        fl, fv = folded(feats)
    torch.testing.assert_close(fl, ul, atol=F32_ATOL, rtol=0)
    torch.testing.assert_close(fv, uv, atol=F32_ATOL, rtol=0)


def test_dense0_rows_follow_the_nchw_flatten():
    """``Dense_0`` of the port on the NCHW flatten of a conv map equals
    the flax kernel on its NHWC flatten, which holds only with the row
    permutation: dropping it changes the products."""
    variables = random_az_convnet_variables(A, CH, seed=7)
    kernel = np.asarray(variables["params"]["Dense_0"]["kernel"])   # [2*3*CH, 1024]
    w = az_convnet_state_dict(variables)["dense.0.weight"]          # [1024, CH*2*3]
    y = torch.randn(5, CH, 2, 3, generator=torch.Generator().manual_seed(0))
    nhwc = y.permute(0, 2, 3, 1).reshape(5, -1).numpy()
    want = nhwc @ kernel
    np.testing.assert_allclose((y.reshape(5, -1) @ w.t()).numpy(), want, rtol=1e-5, atol=1e-5)
    unpermuted = torch.from_numpy(kernel.T.copy())
    assert not np.allclose((y.reshape(5, -1) @ unpermuted.t()).numpy(), want, atol=1e-2)
    assert sorted(policy_row_perm(6, CH).tolist()) == list(range(6 * CH))


def test_folded_and_training_shapes_off_connect_four():
    """The board sets ``Dense_0``'s width: (rows - 4) * (cols - 4) * C."""
    net = AZConvNet(81, channels=8, board=(9, 9), dtype=torch.float32)
    assert net.dense[0].in_features == 5 * 5 * 8
    feats = torch.zeros(3, 9, 9, 2)
    logits, value = make_apply_fn(net)(feats)
    assert logits.shape == (3, 81) and value.shape == (3,)
    with pytest.raises(ValueError, match="dropout"):
        net(feats, train=True)


def _batch(seed: int):
    rng = np.random.default_rng(seed)
    boards = random_boards(N, int(rng.integers(4, 20)), seed=seed)
    feats = GAME.to_features(torch.as_tensor(boards)).numpy()
    pi = rng.dirichlet(np.ones(A), N).astype(np.float32)
    pi[[3, 7]] = 0.0
    v = rng.choice(np.array([-1.0, 0.0, 1.0], np.float32), N)
    return feats, pi, v


def _jax_dropout_draws(jm, variables, feats, key, monkeypatch) -> list:
    """The key, keep probability and shape of every dropout draw of the
    JAX step's training forward (``model.apply(..., train=True,
    rngs={"dropout": key})``, the call ``alphazero_tpu.train`` makes), run
    eagerly while ``jax.random.bernoulli`` is recorded."""
    calls = []
    real = jax.random.bernoulli

    def recording(k, p=0.5, shape=None, **kw):
        calls.append((k, p, tuple(shape)))
        return real(k, p, shape, **kw)

    monkeypatch.setattr(jax.random, "bernoulli", recording)
    with jax.disable_jit():
        jm.apply(variables, jnp.asarray(feats), train=True, mutable=["batch_stats"],
                 rngs={"dropout": key})
    monkeypatch.setattr(jax.random, "bernoulli", real)
    return calls


def test_train_step_matches_jax_f32_with_replayed_dropout(monkeypatch):
    tcfg = TrainConfig()
    variables = random_az_convnet_variables(A, CH, seed=8)
    jm = _jax(jnp.float32)
    jcfg = JaxTrainConfig(**dataclasses.asdict(tcfg))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    jstate = JaxTrainState(params, stats, jax_make_optimizer(jcfg).init(params),
                           jnp.zeros((), jnp.int32))
    batch = _batch(10)
    key = jax.random.key(3)
    calls = _jax_dropout_draws(jm, variables, batch[0], key, monkeypatch)
    # Dense(1024)'s and Dense(512)'s dropout
    assert [(p, s) for _, p, s in calls] == [(0.7, (N, 1024)), (0.7, (N, 512))]
    jstate, jmet = jax.jit(jax_make_train_step(jm, jcfg))(jstate, *(jnp.asarray(x) for x in batch),
                                                           key)
    masks = [torch.from_numpy(np.array(jax.random.bernoulli(k, 0.7, s))) for k, _, s in calls]
    assert 0.6 < float(torch.cat([m.flatten() for m in masks]).float().mean()) < 0.8

    model = convert_az_convnet(variables, dtype=torch.float32)
    tstate = init_train_state(model, tcfg)
    tstate, tmet = make_train_step(tcfg)(tstate, *(torch.as_tensor(x) for x in batch), masks)
    for name, j, t in zip(jmet._fields, jmet, tmet):
        np.testing.assert_allclose(float(t), float(j), rtol=1e-5, atol=1e-7, err_msg=name)

    jsd = {k: v for k, v in az_convnet_state_dict(jax.device_get(
        {"params": jstate.params, "batch_stats": jstate.batch_stats})).items()
        if not k.endswith("num_batches_tracked")}
    mu = next(s.mu for s in jstate.opt_state if hasattr(s, "mu"))
    jmu = az_convnet_state_dict(jax.device_get({"params": mu, "batch_stats": jstate.batch_stats}))
    tmu = {n: tstate.optimizer.state[p]["exp_avg"] for n, p in model.named_parameters()}
    tsd = model.state_dict()
    lr = tcfg.learning_rate
    for k in jsd:
        want, got = jsd[k].numpy(), tsd[k].numpy()
        if k not in tmu:   # running statistics
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7, err_msg=k)
            continue
        m = jmu[k].numpy()
        big = np.abs(m).max()
        np.testing.assert_allclose(tmu[k].numpy(), m, rtol=1e-5, atol=1e-5 * big, err_msg=f"{k} grad")
        steep = np.abs(m) < 1e-4 * big
        np.testing.assert_allclose(got[~steep], want[~steep], rtol=1e-5, atol=1e-6, err_msg=k)
        assert (np.abs(got - want)[steep] <= 2 * lr).all(), k


def _ring(seed: int, rows: int = 64):
    """A ring holding ``rows`` random-board samples (both symmetries)."""
    feats, pi, v = _batch(seed)
    traj = Trajectory(torch.as_tensor(feats)[:, None], torch.as_tensor(pi)[:, None],
                      torch.as_tensor(v)[:, None], torch.ones(N, 1, dtype=torch.bool))
    return replay_insert(replay_init(GAME, ReplayConfig(capacity=rows), device="cpu"), GAME, traj)


def test_train_phase_draws_dropout_masks_from_its_generator():
    """The phase hands its generator to a dropout model: the same seed
    gives the same steps, another seed other masks (and other weights)."""
    ring = _ring(11)
    tcfg = TrainConfig(batch_size=16)
    out = []
    for seed in (0, 0, 1):
        torch.manual_seed(4)
        model = AZConvNet(A, channels=8, dtype=torch.float32)
        state, losses = make_train_phase(tcfg, 2, GAME)(init_train_state(model, tcfg), ring,
                                                        torch.Generator().manual_seed(seed))
        assert torch.isfinite(losses).all() and state.step == 2
        out.append((losses, model.dense[1].weight.detach().clone()))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    assert not torch.equal(out[0][1], out[2][1])


@pytest.mark.parametrize("kind", ["resnet", "mlp"])
def test_resnet_and_mlp_steps_are_unchanged(kind):
    """A model without dropout takes no dropout argument and the phase
    draws nothing for it: the phase is, bit for bit, a loop of
    ``replay_sample`` and ``train_step(state, feats, pi_t, v_t)``."""
    ring = _ring(12)
    tcfg = TrainConfig(batch_size=16)
    states = []
    for _ in range(2):
        torch.manual_seed(6)
        model = (AZResNet(A, channels=4, blocks=1, value_hidden=8, dtype=torch.float32)
                 if kind == "resnet" else MLPNet(A, hidden=(16,), dtype=torch.float32))
        states.append(init_train_state(model, tcfg))
    state, losses = make_train_phase(tcfg, 3, GAME)(states[0], ring,
                                                    torch.Generator().manual_seed(2))
    gen = torch.Generator().manual_seed(2)
    step = make_train_step(tcfg)
    manual = []
    for _ in range(3):
        _, met = step(states[1], *replay_sample(ring, tcfg.batch_size, GAME, gen))
        manual.append(met.loss)
    assert torch.equal(losses, torch.stack(manual))
    for (n, a), b in zip(state.model.state_dict().items(), states[1].model.state_dict().values()):
        assert torch.equal(a, b), n
