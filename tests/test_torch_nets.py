"""models/nets.py + models/convert.py against the flax AZResNet.

The same seeded numpy weights (a flax ``{'params', 'batch_stats'}`` tree,
non-trivial BatchNorm statistics) go through the JAX model and, via the
converter, the port. Tolerances:

* f32, folded or not: atol 1e-4 on logits and value — the two conv
  implementations sum in different orders; nothing else differs.
* bf16 folded eval: atol 0.1. Both evals round at the same points (conv
  output, then the bias add, in bf16), but the convs accumulate in
  different orders, so single bf16-ulp flips (2^-8 relative) appear and
  accumulate through the tower. Measured here: |dlogits| 0.046 and
  |dvalue| 0.005 for the 64x5 case below, and up to 0.086 on logits of
  magnitude ~20 over four other weight seeds; 8x1 agrees to 2e-7.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.models import AZResNet as JaxAZResNet
from alphazero_tpu_torch.models import (
    AZResNet,
    convert_az_resnet,
    make_apply_fn,
    make_uniform_model,
    random_az_resnet_variables,
)
from alphazero_tpu_torch.models.convert import policy_row_perm
from alphazero_tpu_torch.games import ConnectFour
from tests.torch_parity import random_boards

F32_ATOL = 1e-4
BF16_ATOL = 0.1


def _feats(batch: int, seed: int) -> np.ndarray:
    boards = random_boards(batch, 14, seed=seed)
    return np.stack([(boards == 1), (boards == -1)], axis=-1).astype(np.float32)


def _jax_model(channels, blocks, dtype):
    return JaxAZResNet(num_actions=7, channels=channels, blocks=blocks, dtype=dtype)


@pytest.mark.parametrize("channels,blocks", [(8, 1), (64, 5)])
def test_folded_forward_f32(channels, blocks):
    variables = random_az_resnet_variables(7, channels, blocks, seed=channels)
    feats = _feats(4, seed=blocks)
    jl, jv = _jax_model(channels, blocks, jnp.float32).folded_apply(variables, jnp.asarray(feats))
    apply_fn = make_apply_fn(convert_az_resnet(variables, dtype=torch.float32))
    tl, tv = apply_fn(torch.as_tensor(feats))
    assert tl.dtype == tv.dtype == torch.float32 and tl.shape == (4, 7) and tv.shape == (4,)
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(np.asarray(jv), tv.numpy(), atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("channels,blocks", [(8, 1), (64, 5)])
def test_unfolded_forward_f32_checks_the_converter(channels, blocks):
    """The training-shaped module (real BatchNorm layers) against flax's
    eval-mode apply: every converted tensor, the policy-row permutation
    included, lands where the torch layer reads it."""
    variables = random_az_resnet_variables(7, channels, blocks, seed=channels + 1)
    feats = _feats(4, seed=3)
    jl, jv = _jax_model(channels, blocks, jnp.float32).apply(variables, jnp.asarray(feats), train=False)
    model = convert_az_resnet(variables, dtype=torch.float32)
    with torch.no_grad():
        tl, tv = model(torch.as_tensor(feats))
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(np.asarray(jv), tv.numpy(), atol=F32_ATOL, rtol=0)


def test_policy_flatten_order_matters():
    """The permutation is load-bearing: without it the logits change."""
    variables = random_az_resnet_variables(7, 8, 1, seed=5)
    feats = torch.as_tensor(_feats(4, seed=6))
    model = convert_az_resnet(variables, dtype=torch.float32)
    with torch.no_grad():
        good, _ = model(feats)
        perm = torch.as_tensor(policy_row_perm(42))
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(len(perm))
        model.policy.weight.copy_(model.policy.weight[:, inv])   # undo it
        bad, _ = model(feats)
    assert not torch.allclose(good, bad, atol=1e-2)
    assert sorted(policy_row_perm(42).tolist()) == list(range(84))


@pytest.mark.parametrize("channels,blocks", [(8, 1), (64, 5)])
def test_folded_forward_bf16(channels, blocks):
    variables = random_az_resnet_variables(7, channels, blocks, seed=channels + 2)
    feats = _feats(4, seed=7)
    jl, jv = _jax_model(channels, blocks, jnp.bfloat16).folded_apply(variables, jnp.asarray(feats))
    net = convert_az_resnet(variables, dtype=torch.bfloat16)
    tl, tv = make_apply_fn(net)(torch.as_tensor(feats))
    assert tl.dtype == tv.dtype == torch.float32
    dl = float(np.abs(np.asarray(jl) - tl.numpy()).max())
    dv = float(np.abs(np.asarray(jv) - tv.numpy()).max())
    assert max(dl, dv) <= BF16_ATOL, f"bf16 |dlogits|={dl:.4g} |dvalue|={dv:.4g}"


def test_fold_matches_unfolded_module():
    """Folding is exact up to f32 rounding against the module's own
    eval-mode forward."""
    variables = random_az_resnet_variables(7, 16, 2, seed=9)
    net = convert_az_resnet(variables, dtype=torch.float32)
    feats = torch.as_tensor(_feats(8, seed=10))
    with torch.no_grad():
        ul, uv = net(feats)
    fl, fv = make_apply_fn(net)(feats)
    torch.testing.assert_close(fl, ul, atol=F32_ATOL, rtol=0)
    torch.testing.assert_close(fv, uv, atol=F32_ATOL, rtol=0)


def test_apply_fn_flags_and_uniform_model():
    game = ConnectFour()
    uni = make_uniform_model(game, value=0.5)
    assert make_apply_fn(uni) is uni.apply_fn and not uni.apply_fn.needs_features
    logits, value = uni.apply_fn(torch.zeros(3, 1))
    assert torch.equal(logits, torch.zeros(3, 7)) and torch.equal(value, torch.full((3,), 0.5))
    resnet_fn = make_apply_fn(AZResNet(7, channels=8, blocks=1))
    assert resnet_fn.needs_features
    with pytest.raises(TypeError):
        make_apply_fn(object())
