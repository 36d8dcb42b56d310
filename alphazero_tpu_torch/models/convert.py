"""JAX (flax) parameters -> the port's modules.

Takes a flax ``{'params', 'batch_stats'}`` tree whose leaves are numpy
arrays (``jax.device_get`` of a JAX model's variables, or
``random_az_resnet_variables`` / ``random_mlp_variables`` /
``order_free_mlp_variables``) and returns the
port's ``AZResNet`` or ``MLPNet`` with the same weights:

* conv kernels HWIO -> OIHW; Dense kernels ``[in, out]`` -> ``[out, in]``;
* BatchNorm ``scale/bias`` + ``mean/var`` -> the torch BN's
  ``weight/bias`` + ``running_mean/running_var`` (``AZResNet.fold`` then
  folds them with eps=1e-5, as the JAX ``_fold_conv_bn`` does);
* the policy head flattens a 2-channel NHWC map in H*W*C order in flax,
  but the torch module flattens NCHW (C*H*W order), so the ``policy``
  kernel's rows are permuted. The value head has one channel: no change.
* ``MLPNet`` reads the NHWC-flat features in flax's order: its Dense
  kernels are only transposed.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from alphazero_tpu_torch.models.nets import AZResNet, MLPNet


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _conv(kernel) -> torch.Tensor:
    return _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))  # HWIO -> OIHW


def _bn(sd: Dict[str, torch.Tensor], name: str, params, stats) -> None:
    sd[f"{name}.weight"] = _t(params["scale"])
    sd[f"{name}.bias"] = _t(params["bias"])
    sd[f"{name}.running_mean"] = _t(stats["mean"])
    sd[f"{name}.running_var"] = _t(stats["var"])
    sd[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)


def _dense(sd: Dict[str, torch.Tensor], name: str, params, row_perm=None) -> None:
    kernel = np.asarray(params["kernel"])
    if row_perm is not None:
        kernel = kernel[row_perm]
    sd[f"{name}.weight"] = _t(kernel.T)
    sd[f"{name}.bias"] = _t(params["bias"])


def policy_row_perm(hw: int, channels: int = 2) -> np.ndarray:
    """Row ``c*hw + i`` of the torch (NCHW-flatten) policy kernel is row
    ``i*channels + c`` of the flax (NHWC-flatten) kernel."""
    return np.array([i * channels + c for c in range(channels) for i in range(hw)])


def az_resnet_state_dict(variables: Any) -> Dict[str, torch.Tensor]:
    """The ``AZResNet`` state dict for a flax ``AZResNet`` variable tree."""
    p, bs = variables["params"], variables["batch_stats"]
    blocks = sum(1 for k in p if k.startswith("_ResBlock_"))
    sd: Dict[str, torch.Tensor] = {}
    sd["stem.weight"] = _conv(p["Conv_0"]["kernel"])
    _bn(sd, "stem_bn", p["BatchNorm_0"], bs["BatchNorm_0"])
    for i in range(blocks):
        bp, bst = p[f"_ResBlock_{i}"], bs[f"_ResBlock_{i}"]
        for j in (1, 2):
            sd[f"blocks.{i}.conv{j}.weight"] = _conv(bp[f"Conv_{j - 1}"]["kernel"])
            _bn(sd, f"blocks.{i}.bn{j}", bp[f"BatchNorm_{j - 1}"], bst[f"BatchNorm_{j - 1}"])
    sd["policy_conv.weight"] = _conv(p["Conv_1"]["kernel"])
    _bn(sd, "policy_bn", p["BatchNorm_1"], bs["BatchNorm_1"])
    hw = int(np.shape(p["Dense_0"]["kernel"])[0])   # board cells
    _dense(sd, "policy", p["policy"], row_perm=policy_row_perm(hw))
    sd["value_conv.weight"] = _conv(p["Conv_2"]["kernel"])
    _bn(sd, "value_bn", p["BatchNorm_2"], bs["BatchNorm_2"])
    _dense(sd, "value_hidden", p["Dense_0"])
    _dense(sd, "value", p["value"])
    return sd


def convert_az_resnet(variables: Any, dtype: torch.dtype = torch.bfloat16) -> AZResNet:
    """A port ``AZResNet`` (f32 parameters, compute ``dtype`` for its
    folded eval) holding the weights of a flax ``AZResNet`` tree; widths
    are read from the tree."""
    p = variables["params"]
    model = AZResNet(
        num_actions=int(np.shape(p["policy"]["kernel"])[1]),
        channels=int(np.shape(p["Conv_0"]["kernel"])[3]),
        blocks=sum(1 for k in p if k.startswith("_ResBlock_")),
        value_hidden=int(np.shape(p["Dense_0"]["kernel"])[1]),
        cells=int(np.shape(p["Dense_0"]["kernel"])[0]),
        dtype=dtype,
    )
    model.load_state_dict(az_resnet_state_dict(variables))
    return model.eval()


def mlp_state_dict(variables: Any) -> Dict[str, torch.Tensor]:
    """The ``MLPNet`` state dict for a flax ``MLPNet`` variable tree. The
    torch module reads the NHWC-flat features in flax's order, so only the
    Dense kernels are transposed."""
    p = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    for name in (*_mlp_hidden_names(p), "policy", "value"):
        _dense(sd, name, p[name])
    return sd


def _mlp_hidden_names(params) -> list:
    return [f"Dense_{i}" for i in range(sum(1 for k in params if k.startswith("Dense_")))]


def convert_mlp(variables: Any) -> MLPNet:
    """A port ``MLPNet`` holding the weights of a flax ``MLPNet`` tree;
    widths are read from the tree."""
    p = variables["params"]
    model = MLPNet(
        num_actions=int(np.shape(p["policy"]["kernel"])[1]),
        hidden=[int(np.shape(p[n]["kernel"])[1]) for n in _mlp_hidden_names(p)],
        cells=int(np.shape(p["Dense_0"]["kernel"])[0]) // 2,
    )
    model.load_state_dict(mlp_state_dict(variables))
    return model.eval()


def random_mlp_variables(
    num_actions: int, hidden: Sequence[int], cells: int = 42, seed: int = 0
) -> Dict[str, Dict[str, Any]]:
    """A flax-layout ``MLPNet`` variable tree of seeded numpy arrays
    (He-scaled kernels, nonzero biases so that the bf16 bias add is
    exercised), for runs that need real widths but no trained weights and
    no JAX."""
    rng = np.random.default_rng(seed)
    widths = (2 * cells, *hidden)
    params: Dict[str, Any] = {}
    names = [f"Dense_{i}" for i in range(len(hidden))] + ["policy", "value"]
    for name, cin, cout in zip(names, widths + (widths[-1],), (*hidden, num_actions, 1)):
        params[name] = {
            "kernel": (rng.standard_normal((cin, cout)) * np.sqrt(2.0 / cin)).astype(np.float32),
            "bias": (rng.standard_normal(cout) * 0.1).astype(np.float32),
        }
    return {"params": params}


def order_free_mlp_variables(
    num_actions: int, hidden: Sequence[int], cells: int = 42, seed: int = 0
) -> Dict[str, Dict[str, Any]]:
    """A flax-layout ``MLPNet`` variable tree on a small dyadic grid, for
    holding the in-kernel evaluator bit for bit against its plain version:
    hidden kernels and biases k/16 with |k| <= 2, head kernels and biases
    k/64 with |k| <= 4. On 0/1 board inputs every partial sum of every dot
    product is then a multiple of a power of two far inside f32's 24 bits,
    so it is exact, and every order of the adds (the plain evaluator's k
    order, a tensor-core tile's) gives the same bits."""
    rng = np.random.default_rng(seed)
    widths = (2 * cells, *hidden)
    params: Dict[str, Any] = {}
    names = [f"Dense_{i}" for i in range(len(hidden))] + ["policy", "value"]
    for name, cin, cout in zip(names, widths + (widths[-1],), (*hidden, num_actions, 1)):
        k, scale = (4, 64.0) if name in ("policy", "value") else (2, 16.0)
        params[name] = {
            "kernel": (rng.integers(-k, k + 1, (cin, cout)) / scale).astype(np.float32),
            "bias": (rng.integers(-k, k + 1, cout) / scale).astype(np.float32),
        }
    return {"params": params}


def random_az_resnet_variables(
    num_actions: int,
    channels: int,
    blocks: int,
    value_hidden: int = 256,
    cells: int = 42,
    seed: int = 0,
) -> Dict[str, Dict[str, Any]]:
    """A flax-layout ``AZResNet`` variable tree of seeded numpy arrays
    (He-scaled kernels, BatchNorm statistics near identity), for runs
    that need real widths but no trained weights and no JAX."""
    rng = np.random.default_rng(seed)

    def conv(k, cin, cout):
        std = np.sqrt(2.0 / (k * k * cin))
        return {"kernel": (rng.standard_normal((k, k, cin, cout)) * std).astype(np.float32)}

    def bn(c):
        params = {
            "scale": rng.uniform(0.8, 1.2, c).astype(np.float32),
            "bias": (rng.standard_normal(c) * 0.1).astype(np.float32),
        }
        stats = {
            "mean": (rng.standard_normal(c) * 0.1).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, c).astype(np.float32),
        }
        return params, stats

    def dense(cin, cout):
        return {
            "kernel": (rng.standard_normal((cin, cout)) / np.sqrt(cin)).astype(np.float32),
            "bias": (rng.standard_normal(cout) * 0.1).astype(np.float32),
        }

    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    params["Conv_0"] = conv(3, 2, channels)
    params["BatchNorm_0"], stats["BatchNorm_0"] = bn(channels)
    for i in range(blocks):
        bp: Dict[str, Any] = {}
        bst: Dict[str, Any] = {}
        for j in range(2):
            bp[f"Conv_{j}"] = conv(3, channels, channels)
            bp[f"BatchNorm_{j}"], bst[f"BatchNorm_{j}"] = bn(channels)
        params[f"_ResBlock_{i}"] = bp
        stats[f"_ResBlock_{i}"] = bst
    params["Conv_1"] = conv(1, channels, 2)
    params["BatchNorm_1"], stats["BatchNorm_1"] = bn(2)
    params["policy"] = dense(2 * cells, num_actions)
    params["Conv_2"] = conv(1, channels, 1)
    params["BatchNorm_2"], stats["BatchNorm_2"] = bn(1)
    params["Dense_0"] = dense(cells, value_hidden)
    params["value"] = dense(value_hidden, 1)
    return {"params": params, "batch_stats": stats}
