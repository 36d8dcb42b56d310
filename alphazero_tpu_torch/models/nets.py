"""Policy/value networks.

Counterpart of ``alphazero_tpu/models/nets.py``. Every model's search-side
entry is ``apply_fn(feats_nhwc) -> (logits f32[B, A], value f32[B])`` with
a ``needs_features`` flag; the JAX ``apply_fn(variables, feats)`` closes
over its parameters here instead (``make_apply_fn``).

Features keep the JAX NHWC layout ``[B, 6, 7, 2]`` at the public
functions; the conv stack permutes them to an NCHW view with channels_last
strides, the layout cuDNN runs fastest. The convs are library calls, as
they are XLA ops outside any Pallas kernel in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5          # flax BatchNorm default, used by _fold_conv_bn
BN_MOMENTUM = 0.01     # torch convention for flax's momentum=0.99


class UniformModel:
    """Uniform policy, constant value — the pure-MCTS baseline net."""

    def __init__(self, num_actions: int, value: float = 0.0):
        self.num_actions = num_actions
        self.value = value

        def apply_fn(feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
            b = feats.shape[0]
            return (
                torch.zeros((b, num_actions), device=feats.device),
                torch.full((b,), value, device=feats.device),
            )

        # the search skips feature materialization for feature-free models
        apply_fn.needs_features = False
        # constant prior/value: eligible for the fused search kernel
        # (mcts/fused.py)
        apply_fn.uniform_value = value
        self.apply_fn = apply_fn


def make_uniform_model(game, value: float = 0.0) -> UniformModel:
    return UniformModel(game.num_actions, value)


def _bn(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


class _ResBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn1 = _bn(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn2 = _bn(channels)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(x + y)


class AZResNet(nn.Module):
    """AlphaZero-style conv ResNet with the training-shaped layers: stem
    conv + residual tower + 1x1-conv policy/value heads, BatchNorm after
    every conv. ``forward`` runs in the parameter dtype (the learner's
    bf16 mix arrives with the learner port); the search runs the
    BN-folded ``fold()`` network.

    The policy ``Linear`` consumes the NCHW flatten (C*H*W order) of the
    2-channel head map; ``models/convert.py`` permutes the flax kernel's
    H*W*C rows to match. ``cells`` (42 for 6x7) is the board's cell count,
    the input width of the dense heads."""

    def __init__(
        self,
        num_actions: int,
        channels: int = 64,
        blocks: int = 5,
        value_hidden: int = 256,
        cells: int = 42,
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.num_actions = num_actions
        self.dtype = dtype
        self.stem = nn.Conv2d(2, channels, 3, padding=1, bias=False)
        self.stem_bn = _bn(channels)
        self.blocks = nn.ModuleList(_ResBlock(channels) for _ in range(blocks))
        self.policy_conv = nn.Conv2d(channels, 2, 1, bias=False)
        self.policy_bn = _bn(2)
        self.policy = nn.Linear(2 * cells, num_actions)
        self.value_conv = nn.Conv2d(channels, 1, 1, bias=False)
        self.value_bn = _bn(1)
        self.value_hidden = nn.Linear(cells, value_hidden)
        self.value = nn.Linear(value_hidden, 1)

    def forward(self, feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = feats.to(self.stem.weight.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.stem_bn(self.stem(x)))
        for blk in self.blocks:
            x = blk(x)
        p = F.relu(self.policy_bn(self.policy_conv(x))).flatten(1)
        logits = self.policy(p)
        v = F.relu(self.value_bn(self.value_conv(x))).flatten(1)
        v = self.value(F.relu(self.value_hidden(v)))
        return logits.float(), torch.tanh(v.float())[:, 0]

    @torch.no_grad()
    def fold(self) -> "FoldedAZResNet":
        """The BN-folded inference network, in ``self.dtype``, built once
        (the JAX ``folded_apply`` refolds on every call)."""
        return FoldedAZResNet(self)


def _fold_conv_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d, dtype):
    """(W * gamma/sqrt(var+eps), beta - mean*gamma/sqrt(var+eps)) in
    ``dtype`` — the arithmetic of the JAX ``_fold_conv_bn``, with the
    scale on the output-channel (first, OIHW) dim."""
    inv = 1.0 / torch.sqrt(bn.running_var + bn.eps)
    scale = bn.weight * inv
    w = conv.weight * scale.reshape(-1, 1, 1, 1)
    b = bn.bias - bn.running_mean * scale
    return (
        w.to(dtype).contiguous(memory_format=torch.channels_last),
        b.to(dtype),
    )


class FoldedAZResNet(nn.Module):
    """BN-folded AZResNet inference forward, matching the JAX
    ``AZResNet.folded_apply``: convs and the value hidden Dense in the
    compute dtype, policy and value heads in f32, ``tanh`` on the value."""

    def __init__(self, net: AZResNet):
        super().__init__()
        dt = net.dtype
        self.dtype = dt

        def frozen(t):
            return nn.Parameter(t.detach().clone(), requires_grad=False)

        def conv_pair(conv, bn):
            w, b = _fold_conv_bn(conv, bn, dt)
            return nn.ParameterList([frozen(w), frozen(b)])

        self.stem = conv_pair(net.stem, net.stem_bn)
        self.blocks = nn.ModuleList(
            nn.ModuleList([conv_pair(b.conv1, b.bn1), conv_pair(b.conv2, b.bn2)])
            for b in net.blocks
        )
        self.policy_conv = conv_pair(net.policy_conv, net.policy_bn)
        self.value_conv = conv_pair(net.value_conv, net.value_bn)
        self.policy_w = frozen(net.policy.weight.float())
        self.policy_b = frozen(net.policy.bias.float())
        self.hidden_w = frozen(net.value_hidden.weight.to(dt))
        self.hidden_b = frozen(net.value_hidden.bias.to(dt))
        self.value_w = frozen(net.value.weight.float())
        self.value_b = frozen(net.value.bias.float())

    @staticmethod
    def _conv(x, wb):
        # conv rounded to the compute dtype, then the bias add rounded
        # again: the rounding points of the JAX eval (a bias fused into the
        # conv rounds once and drifts ~4x further from it in bf16)
        w, b = wb
        return F.conv2d(x, w, padding=w.shape[-1] // 2).add_(b.view(1, -1, 1, 1))

    def forward(self, feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        # NHWC -> an NCHW view whose strides are channels_last
        x = feats.to(self.dtype).permute(0, 3, 1, 2)
        x = F.relu(self._conv(x, self.stem))
        for c1, c2 in self.blocks:
            y = F.relu(self._conv(x, c1))
            y = self._conv(y, c2)
            x = F.relu(x + y)
        p = F.relu(self._conv(x, self.policy_conv)).flatten(1)
        logits = F.linear(p.float(), self.policy_w, self.policy_b)
        v = F.relu(self._conv(x, self.value_conv)).flatten(1)
        vh = F.relu(F.linear(v, self.hidden_w).add_(self.hidden_b))
        v = F.linear(vh.float(), self.value_w, self.value_b)
        return logits, torch.tanh(v)[:, 0]


def make_apply_fn(model) -> Callable:
    """Search-side ``apply_fn(feats_nhwc) -> (logits f32[B, A], value
    f32[B])``. An ``AZResNet`` is BN-folded once, here; a
    ``UniformModel`` returns its own feature-free apply_fn."""
    if isinstance(model, UniformModel):
        return model.apply_fn
    if not isinstance(model, AZResNet):
        raise TypeError(f"no search apply_fn for {type(model).__name__}")
    folded = model.fold().eval()

    def apply_fn(feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        with torch.no_grad():
            return folded(feats)

    apply_fn.needs_features = True
    return apply_fn
