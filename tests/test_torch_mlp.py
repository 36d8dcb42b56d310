"""MLPNet in the port (models/nets.py, models/convert.py) and its fused
search with the in-kernel evaluator (mcts/fused.py; on the CPU the plain
versions of the ``az_fused_mlp`` kernel), against the JAX package on the
same seeded numpy weights (nonzero biases) and boards. Tolerances:

* forward, logits and value: atol 1e-3. Both sides round at the same
  points (the bf16 product, then the bf16 bias add), but XLA and torch sum
  the bf16 products in different orders, so a rounded activation can land
  one bf16 ulp apart and that carries through the layers. Measured on the
  CPU for the cases below: at most 4.2e-7 (hidden (256, 256), 256
  boards); one such flip moved a logit by 1.1e-3 over 2048 boards.
* the plain evaluator against the JAX ``eval_fn`` of
  ``attach_mlp_kernel_eval``: logits and value atol 1e-3 for the same
  reason (measured at most 3.6e-7 here); prior atol 1e-4, the softmax of
  those logits (measured at most 1.2e-7).
* searches: >= 75% of games with identical root counts and
  max |dpi| <= 0.25, the bound the JAX package holds its Mosaic kernel to
  against its XLA engine (tests/test_fused.py): a bf16 difference in one
  leaf can flip a near-tie in the PUCT argmax and reroute the rest of a
  game's search.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
from alphazero_tpu.games import ConnectFour as JaxConnectFour
from alphazero_tpu.mcts.fused import make_fused_root_fn as jax_fused_root_fn
from alphazero_tpu.models import MLPNet as JaxMLPNet
from alphazero_tpu.models import make_flax_apply_fn
from alphazero_tpu.ops.policy import masked_policy as jax_masked_policy
from alphazero_tpu_torch import kernels
from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.games import ConnectFour
from alphazero_tpu_torch.games.connect_four import FlatOps
from alphazero_tpu_torch.mcts import fused_mlp_search, make_fused_root_fn, make_hybrid_root_fn
from alphazero_tpu_torch.mcts.fused import mlp_forward, mlp_prior
from alphazero_tpu_torch.models import (
    MLPKernelWeights,
    MLPNet,
    convert_az_resnet,
    convert_mlp,
    make_apply_fn,
    make_uniform_model,
    order_free_mlp_variables,
    random_az_resnet_variables,
    random_mlp_variables,
)
from alphazero_tpu_torch.models.nets import mlp_feature_perm, mlp_sections
from alphazero_tpu_torch.selfplay import _make_root_counts_fn
from tests.torch_parity import (
    assert_order_free,
    jax_state,
    order_free_mlp_apply,
    random_boards,
    torch_state,
)

FWD_ATOL = 1e-3
PRIOR_ATOL = 1e-4
SAME_GAMES = 0.75
MAX_DPI = 0.25

JG = JaxConnectFour()
TG = ConnectFour()
FLAT = FlatOps()


def _feats(boards: np.ndarray) -> np.ndarray:
    return np.stack([(boards == 1), (boards == -1)], axis=-1).astype(np.float32)


def _flat(boards: np.ndarray) -> torch.Tensor:
    return FLAT.from_state(torch_state(boards))


def _port(hidden, seed):
    variables = random_mlp_variables(7, hidden, seed=seed)
    return variables, make_apply_fn(convert_mlp(variables))


@pytest.mark.parametrize(
    "hidden,batch", [((32, 32), 16), ((256, 256), 256), ((64,), 16)], ids=["32x32", "256x256", "smoke64"]
)
def test_forward_matches_flax(hidden, batch):
    """The search apply_fn and the training-shaped module forward against
    flax ``MLPNet.apply``."""
    variables, apply_fn = _port(hidden, seed=len(hidden) + batch)
    feats = _feats(random_boards(batch, 12, seed=batch, freeze_done=False))
    jl, jv = JaxMLPNet(num_actions=7, hidden=hidden).apply(variables, jnp.asarray(feats))
    model = convert_mlp(variables)
    with torch.no_grad():
        outs = [apply_fn(torch.as_tensor(feats)), model(torch.as_tensor(feats))]
    for tl, tv in outs:
        assert tl.dtype == tv.dtype == torch.float32 and tl.shape == (batch, 7) and tv.shape == (batch,)
        np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=FWD_ATOL, rtol=0)
        np.testing.assert_allclose(np.asarray(jv), tv.numpy(), atol=FWD_ATOL, rtol=0)


def test_converter_and_kernel_weight_layout():
    """Dense kernels are transposed only; the kernel weights hold W_0 with
    its rows in [+plane | -plane] order, bf16 hidden layers and the fused
    f32 policy|value head, in the kernel's order, each section where
    ``mlp_sections`` puts it in one buffer."""
    variables = random_mlp_variables(7, (32, 16), seed=4)
    p = variables["params"]
    model = convert_mlp(variables)
    assert isinstance(model, MLPNet) and model.hidden == (32, 16)
    assert sorted(model.state_dict()) == sorted(
        f"{n}.{t}" for n in ("Dense_0", "Dense_1", "policy", "value") for t in ("weight", "bias")
    )
    np.testing.assert_array_equal(model.Dense_1.weight.detach().numpy(), p["Dense_1"]["kernel"].T)
    w = make_apply_fn(model).kernel_eval_factory(FLAT)
    perm = mlp_feature_perm(42)
    assert sorted(perm) == list(range(84)) and perm[:3] == [0, 2, 4] and perm[42:44] == [1, 3]
    want = [
        p["Dense_0"]["kernel"][perm], p["Dense_0"]["bias"], p["Dense_1"]["kernel"], p["Dense_1"]["bias"],
        np.concatenate([p["policy"]["kernel"], p["value"]["kernel"]], axis=1),
        np.concatenate([p["policy"]["bias"], p["value"]["bias"]]),
    ]
    got = w.sections()
    assert len(got) == 6
    assert all(g is r for g, r in zip(got, [w.w[0], w.b[0], w.w[1], w.b[1], w.wh, w.bh]))
    sections, nbytes = mlp_sections((32, 16), 7, 42)
    assert w.wh.untyped_storage().nbytes() == nbytes
    for g, ref, (shape, dtype, off) in zip(got, want, sections):
        assert g.dtype == dtype and g.shape == shape and off % 16 == 0
        assert g.data_ptr() == w.w[0].data_ptr() + off
        ref = torch.as_tensor(ref).to(dtype)
        assert torch.equal(g, ref)


@pytest.mark.parametrize("hidden", [(32, 32), (64,)], ids=["32x32", "smoke64"])
def test_plain_evaluator_matches_jax_eval_fn(hidden):
    """``mlp_forward``/``mlp_prior`` against the JAX in-kernel evaluator
    (``attach_mlp_kernel_eval``'s ``eval_fn`` on ``extract(variables)``,
    called directly on the CPU) and ``masked_policy``."""
    variables, apply_fn = _port(hidden, seed=7)
    boards = random_boards(64, 18, seed=5, freeze_done=False)
    flat = np.asarray(_flat(boards))
    jax_apply = make_flax_apply_fn(JaxMLPNet(num_actions=7, hidden=hidden))
    extract, eval_fn = jax_apply.kernel_eval_factory(JG.flat_ops())
    vm = flat[:, 35:] == 0
    jl, jv = eval_fn(jnp.asarray(flat), jnp.asarray(vm), *extract(variables))
    jp = np.asarray(jax_masked_policy(jl, jnp.asarray(vm)))
    weights = apply_fn.kernel_eval_factory(FLAT)
    tl, tv = mlp_forward(torch.as_tensor(flat), weights)
    tp = mlp_prior(tl, torch.as_tensor(vm))
    assert (~vm).any()
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(np.asarray(jv)[:, 0], tv.numpy(), atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(jp[vm], tp.numpy()[vm], atol=PRIOR_ATOL, rtol=0)
    assert (tp.numpy()[~vm] == -1e30).all()


@pytest.mark.parametrize(
    "hidden", [(32, 32), (64,), (16, 24, 40, 8), (256, 256), (256, 256, 256, 256)],
    ids=["32x32", "smoke64", "four_layers", "256x256", "256x4"],
)
def test_order_free_weights_are_exact_in_every_order(hidden):
    """``order_free_mlp_variables`` (the dyadic weights that hold the
    in-kernel evaluator bit for bit against its plain version, whose
    tensor-core sums add in another order): on boards of every depth the
    plain f32 forward equals its float64 evaluation layer by layer, and the
    JAX ``eval_fn``, which sums in XLA's order, gives the same bits."""
    apply_fn = order_free_mlp_apply(hidden, seed=len(hidden))
    weights = apply_fn.kernel_eval_factory(FLAT)
    boards = np.concatenate([random_boards(64, m, seed=m, freeze_done=False) for m in (0, 9, 21, 42)])
    flat = _flat(boards)
    assert_order_free(flat, weights)
    variables = order_free_mlp_variables(7, hidden, seed=len(hidden))
    jax_apply = make_flax_apply_fn(JaxMLPNet(num_actions=7, hidden=hidden))
    extract, eval_fn = jax_apply.kernel_eval_factory(JG.flat_ops())
    vm = np.asarray(flat)[:, 35:] == 0
    jl, jv = eval_fn(jnp.asarray(np.asarray(flat)), jnp.asarray(vm), *extract(variables))
    tl, tv = mlp_forward(flat, weights)
    assert np.array_equal(np.asarray(jl), tl.numpy())
    assert len(set(np.asarray(tl).ravel().tolist())) > 50   # the logits are not degenerate


def _assert_close_searches(a: np.ndarray, b: np.ndarray) -> None:
    assert (a.sum(axis=1) == b.sum(axis=1)).all()   # sims conserved
    same = (a == b).all(axis=1).mean()
    assert same >= SAME_GAMES, f"only {same:.0%} of games identical"
    pa = a / np.maximum(a.sum(1, keepdims=True), 1)
    pb = b / np.maximum(b.sum(1, keepdims=True), 1)
    assert np.abs(pa - pb).max() <= MAX_DPI


def test_fused_search_close_to_jax_fused_kernel():
    """The port's fused MLP engine (its plain version on the CPU) against
    the JAX fused kernel with the in-kernel MLP, in the Pallas interpreter
    with blocks of 4 games, as tests/test_fused.py runs it."""
    cfg = JaxMCTSConfig(num_sims=24, max_depth=48)
    variables, apply_fn = _port((32, 32), seed=0)
    boards = random_boards(16, 5, seed=2)
    jax_apply = make_flax_apply_fn(JaxMLPNet(num_actions=7, hidden=(32, 32)))
    ref = np.asarray(jax_fused_root_fn(JG, jax_apply, cfg, block_size=4)(variables, jax_state(boards), None))
    got = make_fused_root_fn(TG, apply_fn, MCTSConfig(**dataclasses.asdict(cfg)))(torch_state(boards)).numpy()
    assert got.sum(axis=1).max() == 24
    _assert_close_searches(ref, got)


def test_fused_route_close_to_hybrid_route():
    """The in-kernel evaluator's route and the hybrid engine's (the
    library forward of ``apply_fn`` and ``masked_policy``)."""
    cfg = MCTSConfig(num_sims=24, max_depth=48)
    _, apply_fn = _port((32, 32), seed=1)
    state = torch_state(random_boards(16, 8, seed=3))
    fused = make_fused_root_fn(TG, apply_fn, cfg)(state).numpy()
    hybrid = make_hybrid_root_fn(TG, apply_fn, cfg)(state).numpy()
    _assert_close_searches(fused, hybrid)


def test_deterministic():
    cfg = MCTSConfig(num_sims=16, max_depth=48)
    _, apply_fn = _port((32, 32), seed=2)
    root_counts = make_fused_root_fn(TG, apply_fn, cfg)
    state = torch_state(random_boards(8, 4, seed=9))
    a, b = root_counts(state), root_counts(state)
    assert torch.equal(a, b) and a.sum() > 0


def test_ladder_routes_each_model():
    cfg = MCTSConfig(num_sims=8)
    routes = {
        "mlp": _port((32, 32), seed=0)[1],
        "uniform": make_uniform_model(TG).apply_fn,
        "resnet": make_apply_fn(convert_az_resnet(random_az_resnet_variables(7, 8, 1, seed=0),
                                                  dtype=torch.float32)),
    }
    engines = {k: _make_root_counts_fn(TG, fn, cfg).__qualname__.split(".")[0] for k, fn in routes.items()}
    assert engines == {"mlp": "make_fused_root_fn", "uniform": "make_fused_root_fn",
                       "resnet": "make_hybrid_root_fn"}


@pytest.mark.parametrize("hidden", [(300,), (32,) * 5], ids=["wide", "deep"])
def test_widths_the_kernel_does_not_take_raise(hidden):
    """The in-kernel evaluator's wrappers raise for widths it does not
    take; the engine ladder declines the fused kernel for them and runs
    the hybrid engine instead."""
    _, apply_fn = _port(hidden, seed=0)
    weights = apply_fn.kernel_eval_factory(FLAT)
    boards = _flat(random_boards(4, 6, seed=1))
    p = torch.where(FLAT.valid(boards), 1.0 / 7, -1e30)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kernels.fused_mlp(boards, p, weights, 8, 9, 48, 1.0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kernels.mlp_eval(boards, weights)
    assert make_fused_root_fn(TG, apply_fn, MCTSConfig(num_sims=8)) is None
    root_counts = _make_root_counts_fn(TG, apply_fn, MCTSConfig(num_sims=8))
    assert root_counts.__qualname__.startswith("make_hybrid_root_fn.")
    counts = root_counts(torch_state(random_boards(4, 6, seed=1)))
    assert (counts.sum(dim=1) == 8).all()


def test_wrappers_route_cpu_to_plain_and_check_the_weights():
    _, apply_fn = _port((32, 32), seed=3)
    w = apply_fn.kernel_eval_factory(FLAT)
    boards = _flat(random_boards(4, 6, seed=1))
    p = torch.where(FLAT.valid(boards), 1.0 / 7, -1e30)
    kernels.reset_launch_counts()
    got = kernels.fused_mlp(boards, p, w, 8, 9, 48, 1.0)
    want = fused_mlp_search(boards, p, MCTSConfig(num_sims=8, max_depth=48), w)
    assert all(torch.equal(g, r) for g, r in zip(got, want))
    pm, value, logits = kernels.mlp_eval(boards, w)
    ref_logits, ref_value = mlp_forward(boards, w)
    assert torch.equal(logits, ref_logits) and torch.equal(value, ref_value)
    assert torch.equal(pm, mlp_prior(ref_logits, FLAT.valid(boards)))
    assert kernels.launch_counts()["fused_mlp"] == kernels.launch_counts()["mlp_eval"] == 0
    on_meta = MLPKernelWeights(w.hidden, *(tuple(t.to("meta") for t in ts) for ts in (w.w, w.b)),
                               w.wh.to("meta"), w.bh.to("meta"))
    with pytest.raises(ValueError, match="no kernel for device"):
        kernels.fused_mlp(boards.to("meta"), p.to("meta"), on_meta, 8, 9, 48, 1.0)
    with pytest.raises(ValueError, match="several devices"):
        kernels.mlp_eval(boards, w._replace(bh=w.bh.to("meta")))
    with pytest.raises(TypeError, match="weight section 4"):
        kernels.fused_mlp(boards, p, w._replace(wh=w.wh.double()), 8, 9, 48, 1.0)
    with pytest.raises(ValueError, match="weight section 1: expected shape"):
        kernels.fused_mlp(boards, p, w._replace(b=(w.b[0][:16], w.b[1])), 8, 9, 48, 1.0)
    with pytest.raises(ValueError, match="weight section 4: expected a contiguous"):
        kernels.mlp_eval(boards, w._replace(wh=w.wh.t().contiguous().t()))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kernels.mlp_eval(boards, w._replace(hidden=(32, 300)))
