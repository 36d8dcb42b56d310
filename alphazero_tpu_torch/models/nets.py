"""Policy/value networks.

Counterpart of ``alphazero_tpu/models/nets.py``. Every model's search-side
entry is ``apply_fn(feats_nhwc) -> (logits f32[B, A], value f32[B])`` with
a ``needs_features`` flag; the JAX ``apply_fn(variables, feats)`` closes
over its parameters here instead (``make_apply_fn``). ``model(feats,
train=True)`` is the learner's forward (``train.make_train_step``), at the
flax modules' rounding points; ``AZConvNet``'s also takes its dropout.

Features keep the JAX NHWC layout ``[B, 6, 7, 2]`` at the public
functions; the conv stack permutes them to an NCHW view with channels_last
strides, the layout cuDNN runs fastest. The convs and the MLP's matmuls
are library calls, as they are XLA ops outside any Pallas kernel in the
JAX package; the fused search evaluates the MLP in its own kernel from the
packed weights of ``pack_mlp_weights``.
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from alphazero_tpu_torch.parallel.distributed import global_sum

BN_EPS = 1e-5          # flax BatchNorm default, used by _fold_conv_bn
BN_MOMENTUM = 0.99     # flax BatchNorm default: ra = m * ra + (1 - m) * batch


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
    # a holder of flax's BatchNorm parameters and statistics: weight
    # (flax's scale), bias, running_mean, running_var; ``_batch_norm``
    # applies them
    return nn.BatchNorm2d(channels, eps=BN_EPS)


def _batch_moments(x: torch.Tensor, dims, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(E[x], E[x^2])`` over ``dims``: the local batch's, or with a
    ``mesh`` the global batch's, the sum over the ranks of each rank's
    moments times its share of the rows (``global_sum``: the
    backward sums the ranks' gradients of the statistics, as flax's
    BatchNorm over a sharded batch differentiates through its global
    mean). The ranks' batches are equal (``parallel.batch_sharding``), so
    each share is ``1 / ranks``, and a world of one takes the local
    moments bit for bit."""
    mean, ex2 = x.mean(dim=dims), (x * x).mean(dim=dims)
    if mesh is None:
        return mean, ex2
    share = 1.0 / mesh.data
    tot = global_sum(torch.stack([mean * share, ex2 * share]), mesh)
    return tot[0], tot[1]


def _batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d, train: bool, mesh=None) -> torch.Tensor:
    """flax ``BatchNorm(dtype=float32)`` on ``x``, an NCHW conv output or
    a ``[B, F]`` dense output (features on dim 1): in f32, ``(x - mean) *
    (rsqrt(var + eps) * scale) + bias``. ``train`` normalises by the
    batch's statistics (with a ``mesh``, the global batch's of its ranks),
    ``var = max(0, E[x^2] - E[x]^2)`` (biased, as flax's fast variance),
    and moves the running statistics toward them by flax's momentum
    (torch's own BatchNorm would move ``running_var`` toward the unbiased
    variance); otherwise by the running statistics."""
    x = x.float()
    dims = (0, *range(2, x.ndim))
    if train:
        mean, ex2 = _batch_moments(x, dims, mesh)
        var = torch.clamp(ex2 - mean * mean, min=0.0)
        with torch.no_grad():
            bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean + (1.0 - BN_MOMENTUM) * mean)
            bn.running_var.copy_(BN_MOMENTUM * bn.running_var + (1.0 - BN_MOMENTUM) * var)
    else:
        mean, var = bn.running_mean, bn.running_var
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return (x - mean.view(shape)) * mul.view(shape) + bn.bias.view(shape)


def _conv(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype, padding=None) -> torch.Tensor:
    """flax ``Conv(dtype=dtype)``: input and f32 kernel cast to ``dtype``;
    ``padding`` None is SAME, 0 VALID."""
    w = conv.weight.to(dtype)
    return F.conv2d(x.to(dtype), w, padding=w.shape[-1] // 2 if padding is None else padding)


class _ResBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn1 = _bn(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn2 = _bn(channels)

    def forward(self, x: torch.Tensor, train: bool, bn_mesh=None) -> torch.Tensor:
        # the flax _ResBlock: BatchNorm in f32, the residual add in x's dtype
        y = F.relu(_batch_norm(_conv(x, self.conv1, x.dtype), self.bn1, train, bn_mesh))
        y = _batch_norm(_conv(y, self.conv2, x.dtype), self.bn2, train, bn_mesh)
        return F.relu(x + y.to(x.dtype))


class AZResNet(nn.Module):
    """AlphaZero-style conv ResNet with the training-shaped layers: stem
    conv + residual tower + 1x1-conv policy/value heads, BatchNorm after
    every conv. Parameters and statistics are f32; ``forward`` is the flax
    ``AZResNet.__call__`` at its rounding points: convs and the value
    hidden Dense in ``dtype``, BatchNorm in f32 (``train=True``: the
    batch's statistics, updating the running ones), the stem's output cast
    back to ``dtype``, the residual add in ``dtype``, f32 policy and value
    heads, ``tanh`` on the value. The search runs the BN-folded ``fold()``
    network.

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

    def forward(self, feats: torch.Tensor, train: bool = False,
                bn_mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
        dt = self.dtype
        # NHWC -> an NCHW view whose strides are channels_last
        x = feats.to(dt).permute(0, 3, 1, 2)
        x = F.relu(_batch_norm(_conv(x, self.stem, dt), self.stem_bn, train, bn_mesh)).to(dt)
        for blk in self.blocks:
            x = blk(x, train, bn_mesh)
        p = F.relu(_batch_norm(_conv(x, self.policy_conv, dt), self.policy_bn, train,
                               bn_mesh)).flatten(1)
        logits = self.policy(p)
        v = F.relu(_batch_norm(_conv(x, self.value_conv, dt), self.value_bn, train,
                               bn_mesh)).flatten(1)
        # the flax Dense in dt: product rounded to dt, then the bias add
        vh = F.relu(F.linear(v.to(dt), self.value_hidden.weight.to(dt))
                    + self.value_hidden.bias.to(dt))
        v = self.value(vh.float())
        return logits, torch.tanh(v)[:, 0]

    @torch.no_grad()
    def fold(self) -> "FoldedAZResNet":
        """The BN-folded inference network, in ``self.dtype``, built once
        (the JAX ``folded_apply`` refolds on every call)."""
        return FoldedAZResNet(self)


def _fold_conv_bn(conv: nn.Module, bn: nn.BatchNorm2d, dtype):
    """(W * gamma/sqrt(var+eps), beta - mean*gamma/sqrt(var+eps)) in
    ``dtype`` — the arithmetic of the JAX ``_fold_conv_bn``, with the
    scale on the output-channel (first: OIHW, or a ``Linear``'s ``[out,
    in]``) dim. A conv kernel comes channels_last."""
    inv = 1.0 / torch.sqrt(bn.running_var + bn.eps)
    scale = bn.weight * inv
    w = conv.weight * scale.reshape((-1,) + (1,) * (conv.weight.ndim - 1))
    b = bn.bias - bn.running_mean * scale
    w = w.to(dtype)
    if w.ndim == 4:
        w = w.contiguous(memory_format=torch.channels_last)
    return w, b.to(dtype)


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t.detach().clone(), requires_grad=False)


def _folded_pair(conv: nn.Module, bn: nn.BatchNorm2d, dtype) -> nn.ParameterList:
    w, b = _fold_conv_bn(conv, bn, dtype)
    return nn.ParameterList([_frozen(w), _frozen(b)])


class FoldedAZResNet(nn.Module):
    """BN-folded AZResNet inference forward, matching the JAX
    ``AZResNet.folded_apply``: convs and the value hidden Dense in the
    compute dtype, policy and value heads in f32, ``tanh`` on the value."""

    def __init__(self, net: AZResNet):
        super().__init__()
        dt = net.dtype
        self.dtype = dt
        self.stem = _folded_pair(net.stem, net.stem_bn, dt)
        self.blocks = nn.ModuleList(
            nn.ModuleList([_folded_pair(b.conv1, b.bn1, dt), _folded_pair(b.conv2, b.bn2, dt)])
            for b in net.blocks
        )
        self.policy_conv = _folded_pair(net.policy_conv, net.policy_bn, dt)
        self.value_conv = _folded_pair(net.value_conv, net.value_bn, dt)
        self.policy_w = _frozen(net.policy.weight.float())
        self.policy_b = _frozen(net.policy.bias.float())
        self.hidden_w = _frozen(net.value_hidden.weight.to(dt))
        self.hidden_b = _frozen(net.value_hidden.bias.to(dt))
        self.value_w = _frozen(net.value.weight.float())
        self.value_b = _frozen(net.value.bias.float())

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


CONVNET_PADDING = (None, None, 0, 0)   # SAME, SAME, VALID, VALID: the flax AZConvNet's
CONVNET_DENSE = (1024, 512)


def _dropout(x: torch.Tensor, rate: float, mask: torch.Tensor) -> torch.Tensor:
    """flax's ``Dropout``: ``x / keep`` where ``mask`` keeps, else 0. JAX
    casts the Python scalar ``keep = 1 - rate`` to ``x``'s dtype (a weak
    type), so the divisor is ``keep`` rounded to that dtype."""
    keep = torch.tensor(1.0 - rate, dtype=x.dtype).item()
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class AZConvNet(nn.Module):
    """The plain conv net of the reference's TF1 architecture spec, the
    flax ``AZConvNet`` (the ``convnet`` preset): four 3x3 convs (SAME,
    SAME, VALID, VALID) without bias, each with BatchNorm and ReLU; the
    flatten; Dense(1024) and Dense(512) without bias, each with
    BatchNorm, ReLU and Dropout(``dropout``); f32 ``policy`` and
    ``value`` heads, ``tanh`` on the value. Parameters are f32; the
    forward rounds where flax does: convs and dense layers in ``dtype``,
    BatchNorm in f32, a cast back to ``dtype`` after each ReLU. ``board``
    is ``(rows, cols)``: the VALID convs leave ``(rows - 4) * (cols - 4)``
    cells of ``channels``, the input of ``Dense_0``, which consumes their
    NCHW flatten (``models/convert.py`` permutes the flax kernel's H*W*C
    rows to match).

    Dropout (rate ``dropout``) runs only in ``forward(train=True)``, and
    then needs the forward's ``dropout`` argument: a ``torch.Generator``
    on ``feats``' device, from which each layer's keep mask is drawn as
    flax's (``uniform < 1 - rate``), a callable giving each layer's
    uniforms for the layer's output (a rank's rows of the global batch's),
    or the two bool masks themselves (a test replaying the JAX step's)."""

    def __init__(
        self,
        num_actions: int,
        channels: int = 512,
        dropout: float = 0.3,
        board: Tuple[int, int] = (6, 7),
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.num_actions = num_actions
        self.dropout = float(dropout)
        self.board = tuple(board)
        self.dtype = dtype
        rows, cols = self.board
        self.convs = nn.ModuleList(
            nn.Conv2d(2 if i == 0 else channels, channels, 3, bias=False) for i in range(4))
        self.conv_bns = nn.ModuleList(_bn(channels) for _ in range(4))
        widths = ((rows - 4) * (cols - 4) * channels, *CONVNET_DENSE)
        self.dense = nn.ModuleList(
            nn.Linear(widths[j], widths[j + 1], bias=False) for j in range(2))
        self.dense_bns = nn.ModuleList(_bn(h) for h in CONVNET_DENSE)
        self.policy = nn.Linear(widths[-1], num_actions)
        self.value = nn.Linear(widths[-1], 1)

    def forward(self, feats: torch.Tensor, train: bool = False,
                dropout=None, bn_mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
        dt = self.dtype
        if train and self.dropout > 0 and dropout is None:
            raise ValueError("AZConvNet's training forward needs its dropout: a generator or masks")
        # NHWC -> an NCHW view whose strides are channels_last
        x = feats.to(dt).permute(0, 3, 1, 2)
        for conv, bn, pad in zip(self.convs, self.conv_bns, CONVNET_PADDING):
            x = F.relu(_batch_norm(_conv(x, conv, dt, pad), bn, train, bn_mesh)).to(dt)
        x = x.flatten(1)
        for j, (lin, bn) in enumerate(zip(self.dense, self.dense_bns)):
            x = F.relu(_batch_norm(F.linear(x, lin.weight.to(dt)), bn, train, bn_mesh)).to(dt)
            if train and self.dropout > 0:
                if isinstance(dropout, torch.Generator):
                    mask = torch.rand(x.shape, generator=dropout, device=x.device) < 1.0 - self.dropout
                elif callable(dropout):
                    # a rank's rows of the global batch's uniforms
                    # (train.py under a mesh)
                    mask = dropout(x) < 1.0 - self.dropout
                else:
                    mask = dropout[j]
                x = _dropout(x, self.dropout, mask)
        h = x.float()
        return F.linear(h, self.policy.weight, self.policy.bias), torch.tanh(
            F.linear(h, self.value.weight, self.value.bias))[:, 0]

    @torch.no_grad()
    def fold(self) -> "FoldedAZConvNet":
        """The BN-folded inference network, in ``self.dtype``."""
        return FoldedAZConvNet(self)


class FoldedAZConvNet(nn.Module):
    """BN-folded AZConvNet inference forward, matching the JAX
    ``AZConvNet.folded_apply``: the four convs and the two dense layers
    with their BatchNorms folded in, in the compute dtype (the product
    rounded, then the bias add rounded again), ReLU; f32 heads, ``tanh``
    on the value. Dropout is the identity here."""

    def __init__(self, net: AZConvNet):
        super().__init__()
        dt = net.dtype
        self.dtype = dt
        self.convs = nn.ModuleList(
            _folded_pair(c, bn, dt) for c, bn in zip(net.convs, net.conv_bns))
        self.dense = nn.ModuleList(
            _folded_pair(d, bn, dt) for d, bn in zip(net.dense, net.dense_bns))
        self.policy_w = _frozen(net.policy.weight.float())
        self.policy_b = _frozen(net.policy.bias.float())
        self.value_w = _frozen(net.value.weight.float())
        self.value_b = _frozen(net.value.bias.float())

    def forward(self, feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        # NHWC -> an NCHW view whose strides are channels_last
        x = feats.to(self.dtype).permute(0, 3, 1, 2)
        for (w, b), pad in zip(self.convs, CONVNET_PADDING):
            pad = w.shape[-1] // 2 if pad is None else pad
            x = F.relu(F.conv2d(x, w, padding=pad).add_(b.view(1, -1, 1, 1)))
        x = x.flatten(1)
        for w, b in self.dense:
            x = F.relu(F.linear(x, w).add_(b))
        h = x.float()
        v = F.linear(h, self.value_w, self.value_b)
        return F.linear(h, self.policy_w, self.policy_b), torch.tanh(v)[:, 0]


def _mlp_forward(feats, hidden, heads) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MLP on NHWC features: ``hidden`` is ``[(W [out, in], b [out]),
    ...]`` in the hidden layers' dtype, ``heads`` the f32 ``(policy W,
    policy b, value W, value b)``."""
    x = feats.reshape(feats.shape[0], -1)
    x = x.to(hidden[0][0].dtype) if hidden else x   # no hidden layer: the f32 heads on the input
    for w, b in hidden:
        # the product rounded to the dtype, then the bias add rounded again:
        # the rounding points of the flax Dense (F.linear(x, w, b) rounds once)
        x = F.relu(F.linear(x, w).add_(b))
    h = x.float()
    wp, bp, wv, bv = heads
    return F.linear(h, wp, bp), torch.tanh(F.linear(h, wv, bv))[:, 0]


class MLPNet(nn.Module):
    """Tiny MLP policy/value net (BASELINE config 2), the flax ``MLPNet``:
    hidden layers ``Dense_0..n-1`` in ``dtype`` (bf16, flax's default) with
    ReLU, then f32 ``policy`` and ``value`` heads, ``tanh`` on the value.
    The input is the NHWC-flat feature vector ``[B, 2 * cells]``, as flax
    flattens it. Parameters are f32; the forward casts the hidden layers'
    to ``dtype``. The search takes only the bf16 one, whose hidden layers
    the fused kernel's evaluator computes (``make_apply_fn`` raises for
    another); another ``dtype`` runs only the learner's forward."""

    def __init__(self, num_actions: int, hidden: Sequence[int] = (256, 256), cells: int = 42,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_actions = num_actions
        self.hidden = tuple(int(h) for h in hidden)
        self.cells = cells
        self.dtype = dtype
        widths = (2 * cells, *self.hidden)
        for i in range(len(self.hidden)):
            setattr(self, f"Dense_{i}", nn.Linear(widths[i], widths[i + 1]))
        self.policy = nn.Linear(widths[-1], num_actions)
        self.value = nn.Linear(widths[-1], 1)

    def dense_layers(self) -> List[nn.Linear]:
        return [getattr(self, f"Dense_{i}") for i in range(len(self.hidden))]

    def forward_weights(self):
        """``(hidden, heads)`` of ``_mlp_forward``: the hidden layers cast
        to ``dtype``, the f32 heads."""
        hidden = [(d.weight.to(self.dtype), d.bias.to(self.dtype)) for d in self.dense_layers()]
        heads = (self.policy.weight, self.policy.bias, self.value.weight, self.value.bias)
        return hidden, heads

    def forward(self, feats: torch.Tensor, train: bool = False,
                bn_mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
        # no BatchNorm (``bn_mesh`` has nothing to act on): training and
        # inference are one forward, as in flax;
        # gradients reach the f32 parameters through the bf16 casts
        return _mlp_forward(feats, *self.forward_weights())


class MLPKernelWeights(NamedTuple):
    """The in-kernel MLP evaluator's weights, sections of one packed device
    buffer (``pack_mlp_weights``); the kernel takes each section's own
    address (``sections()``)."""

    hidden: Tuple[int, ...]            # hidden widths
    w: Tuple[torch.Tensor, ...]        # bf16 [in, out]; W_0's rows [+plane | -plane]
    b: Tuple[torch.Tensor, ...]        # bf16 [out]
    wh: torch.Tensor                   # f32 [H_last, A + 1]: policy | value
    bh: torch.Tensor                   # f32 [A + 1]

    def sections(self) -> List[torch.Tensor]:
        """``W_0, b_0, ..., W_n-1, b_n-1, Wh, bh``: the kernel's order."""
        return [t for pair in zip(self.w, self.b) for t in pair] + [self.wh, self.bh]


def _itemsize(dtype: torch.dtype) -> int:
    return torch.finfo(dtype).bits // 8


def mlp_sections(hidden: Sequence[int], num_actions: int, cells: int):
    """``([(shape, dtype, byte offset), ...], nbytes)`` of the packed
    buffer: W_l, b_l of each hidden layer, then Wh and bh, each section at
    a 16-byte boundary."""
    widths = (2 * cells, *hidden)
    shapes = []
    for i, h in enumerate(hidden):
        shapes += [((widths[i], h), torch.bfloat16), ((h,), torch.bfloat16)]
    shapes += [((widths[-1], num_actions + 1), torch.float32), ((num_actions + 1,), torch.float32)]
    out, off = [], 0
    for shape, dtype in shapes:
        out.append((shape, dtype, off))
        nbytes = math.prod(shape) * _itemsize(dtype)
        off = (off + nbytes + 15) // 16 * 16
    return out, off


def mlp_feature_perm(cells: int) -> List[int]:
    """Input ``j`` of the kernel's ``[+plane | -plane]`` order is NHWC-flat
    feature ``2j`` (``j < cells``), else ``2(j - cells) + 1``."""
    return [2 * j for j in range(cells)] + [2 * j + 1 for j in range(cells)]


@torch.no_grad()
def pack_mlp_weights(model: MLPNet) -> MLPKernelWeights:
    """The kernel's weights of ``model`` on its device (the JAX
    ``extract``): the rows of the first matrix that reads the input (W_0,
    or the head when there is no hidden layer) permuted from the NHWC-flat
    order to ``[+plane | -plane]``, the hidden layers in bf16, the policy
    and value heads fused into one f32 ``[H_last, A + 1]`` head."""
    dev = model.policy.weight.device
    perm = torch.as_tensor(mlp_feature_perm(model.cells), device=dev)
    tensors = []
    for i, d in enumerate(model.dense_layers()):
        w = d.weight.t()
        if i == 0:
            w = w[perm]
        tensors += [w.to(torch.bfloat16), d.bias.to(torch.bfloat16)]
    wh = torch.cat([model.policy.weight, model.value.weight]).t().float()
    tensors.append(wh if model.hidden else wh[perm])
    tensors.append(torch.cat([model.policy.bias, model.value.bias]).float())
    sections, nbytes = mlp_sections(model.hidden, model.num_actions, model.cells)
    packed = torch.zeros(nbytes, dtype=torch.uint8, device=dev)
    views = []
    for t, (shape, dtype, off) in zip(tensors, sections):
        view = packed[off: off + t.numel() * _itemsize(dtype)].view(dtype).view(shape)
        view.copy_(t)
        views.append(view)
    return MLPKernelWeights(
        model.hidden, tuple(views[0:-2:2]), tuple(views[1:-2:2]), views[-2], views[-1]
    )


def _mlp_apply_fn(model: MLPNet) -> Callable:
    if model.dtype != torch.bfloat16:
        raise ValueError(
            f"the search evaluates a bf16 MLPNet (the fused kernel's evaluator); "
            f"this one's hidden layers are {model.dtype}"
        )
    # a snapshot of the weights, as the packed kernel weights are one
    with torch.no_grad():
        hidden, heads = model.forward_weights()
        heads = tuple(t.clone() for t in heads)

    def apply_fn(feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        with torch.no_grad():
            return _mlp_forward(feats, hidden, heads)

    apply_fn.needs_features = True
    weights = pack_mlp_weights(model)

    def kernel_eval_factory(ops) -> MLPKernelWeights:
        if ops.size != model.cells:
            raise ValueError(f"the MLP takes {model.cells}-cell boards, the game has {ops.size}")
        return weights

    # the in-kernel evaluator of the fused search (mcts/fused.py), under
    # the JAX package's name
    apply_fn.kernel_eval_factory = kernel_eval_factory
    return apply_fn


def is_folded(model) -> bool:
    """Whether the search evaluates ``model`` BN-folded (``fold()``): the
    JAX ``make_flax_apply_fn``'s ``folded`` for a model with a
    ``folded_apply``."""
    return callable(getattr(model, "fold", None))


def make_apply_fn(model) -> Callable:
    """Search-side ``apply_fn(feats_nhwc) -> (logits f32[B, A], value
    f32[B])``. An ``AZResNet`` or ``AZConvNet`` is BN-folded once, here; a bf16 ``MLPNet``'s
    cast weights and its packed in-kernel weights (``kernel_eval_factory``)
    are built once, here, and an MLPNet of another dtype raises; an
    object with an ``apply_fn`` of this kind (a ``UniformModel``, a
    rule-based prior) returns that."""
    if callable(getattr(model, "apply_fn", None)):
        return model.apply_fn
    if isinstance(model, MLPNet):
        return _mlp_apply_fn(model)
    if not is_folded(model):
        raise TypeError(f"no search apply_fn for {type(model).__name__}")
    folded = model.fold().eval()

    def apply_fn(feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        with torch.no_grad():
            return folded(feats)

    apply_fn.needs_features = True
    return apply_fn
