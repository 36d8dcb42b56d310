"""The fused int8 ResNet tower on the card: the counterpart of the
repository's ``experiments/int8_fused_tower.py``.

The reference asks whether the whole Connect-Four ResNet tower — a stem
conv and 5 residual blocks of two convs, 11 convs of 3x3 SAME from 64 to
64 channels on the 6x7 board — runs faster as ONE kernel, with int8
activations and weights kept on chip across the layers and every layer
requantized in the kernel's epilogue, than as the library's bf16 conv
tower. Its TPU kernel (``tower_kernel``) measured a negative result on its
own hardware. Here the question is asked afresh of the H100: the kernel of
``csrc/int8_tower.cu`` (``kernels.int8_tower``) against two yardsticks,

* ``int_mm_tower``: the same function through library calls — per layer
  the 9 shifted slices as int8 patches and ``torch._int_mm``, then the same
  requantization (bit-equal to the kernel);
* ``cudnn_tower``: the bf16 cuDNN conv tower of the port's BN-folded
  ResNet (``FoldedAZResNet._conv``'s 11 convs with bias, ReLU and residual
  adds, channels_last) on the same input.

The tower's function, its plain version and its layout are in
``models/int8_tower.py``.

Run it on the card:

    python -m alphazero_tpu_torch.experiments.int8_fused_tower
"""

from __future__ import annotations

import math
import subprocess
from typing import Callable, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from alphazero_tpu_torch.models.int8_tower import (
    BLOCKS, CELLS, CH, COLS, N_LAYERS, ROWS, TAPS, WSCALE, patches, tower, tower_ops,
    tower_weights_from_jax)
from alphazero_tpu_torch.models.nets import FoldedAZResNet

MAIN_B = 4096             # the reference main's batch ...
MAIN_REPS, MAIN_TRIALS = 30, 3   # ... towers per timed run, best of 3 runs
MAIN_SEED = 0
# kernel launches of one main(): the forward, the warm-up, the timed runs
MAIN_LAUNCHES = 2 + MAIN_REPS * MAIN_TRIALS


def random_tower_inputs(seed: int, B: int, low: int = -16,
                        high: int = 16) -> Tuple[np.ndarray, List[np.ndarray]]:
    """The reference main's inputs, drawn in its order from
    ``np.random.default_rng(seed)``: x f32[B*42, 64] ~ U(-1, 1), then the
    11 layers' weights int8[576, 64] from ``integers(low, high)`` (the
    main's -16..15; -127..127 drives activations into the clip). Numpy
    arrays in the reference's layout."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B * CELLS, CH)).astype(np.float32)
    ws = [rng.integers(low, high, (TAPS * CH, CH)).astype(np.int8) for _ in range(N_LAYERS)]
    return x, ws


def int_mm_tower(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Yardstick: the tower through the library's int8 matmul
    (``torch._int_mm`` on the 9 shifted slices, int32 accumulation), then
    the same requantization; bit-equal to ``tower_plain``."""
    def conv_acc(q, wl):
        return torch._int_mm(patches(q), wl.t()).float()

    return tower(x, w, conv_acc)


def cudnn_weights(w: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The tower's weights as the (weight, bias) pairs of the folded bf16
    ResNet's convs: OIHW weights w * WSCALE in channels_last, zero bias."""
    oihw = w.view(N_LAYERS, CH, 3, 3, CH).permute(0, 1, 4, 2, 3).float() * WSCALE
    return [(oihw[i].to(torch.bfloat16).contiguous(memory_format=torch.channels_last),
             torch.zeros(CH, dtype=torch.bfloat16, device=w.device)) for i in range(N_LAYERS)]


def cudnn_input(x: torch.Tensor) -> torch.Tensor:
    """x f32[B*42, 64] as the bf16 NCHW view with channels_last strides
    that ``FoldedAZResNet.forward`` feeds its convs."""
    return x.view(-1, ROWS, COLS, CH).to(torch.bfloat16).permute(0, 3, 1, 2)


def cudnn_tower(x: torch.Tensor, convs) -> torch.Tensor:
    """Yardstick: the bf16 conv tower of ``FoldedAZResNet.forward`` (stem,
    then per block conv, ReLU, conv, residual add, ReLU), each conv
    ``FoldedAZResNet._conv``'s (cuDNN, then the bias add)."""
    h = F.relu(FoldedAZResNet._conv(x, convs[0]))
    for b in range(BLOCKS):
        y = F.relu(FoldedAZResNet._conv(h, convs[1 + 2 * b]))
        y = FoldedAZResNet._conv(y, convs[2 + 2 * b])
        h = F.relu(h + y)
    return h


def best_ms(fn: Callable) -> float:
    """Device ms per call of ``fn``: one warm-up call, then MAIN_TRIALS runs
    of MAIN_REPS calls between CUDA events; the best run's mean."""
    fn()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(MAIN_TRIALS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(MAIN_REPS):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / MAIN_REPS)
    return best


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> dict:
    """The reference main's experiment on the card: its inputs at B=4096,
    the kernel's tower once, then a warm-up and the best of 3 runs of 30
    towers, and the two yardsticks timed the same way. Prints ms and TOPS
    (the reference's operation count) with the card's name and power
    limit; returns the inputs, the first tower's output and the times."""
    from alphazero_tpu_torch import kernels

    if not torch.cuda.is_available():
        raise SystemExit("int8_fused_tower: the experiment runs on a CUDA card, and none is visible")
    dev = torch.device("cuda", 0)
    card = card_line()
    B = MAIN_B
    x_np, ws = random_tower_inputs(MAIN_SEED, B)
    x = torch.from_numpy(x_np).to(dev)
    w = tower_weights_from_jax(ws).to(dev)
    start = kernels.int8_tower.launches
    out = kernels.int8_tower(x, w)
    torch.cuda.synchronize()
    print(f"compiled + ran; out mean {float(out.abs().mean())}", flush=True)
    ms = best_ms(lambda: kernels.int8_tower(x, w))
    launches = kernels.int8_tower.launches - start
    int_mm_ms = best_ms(lambda: int_mm_tower(x, w))
    convs, x4 = cudnn_weights(w), cudnn_input(x)
    cudnn_ms = best_ms(lambda: cudnn_tower(x4, convs))
    ops = tower_ops(B)
    for label, t in (("int8 fused tower (csrc/int8_tower.cu)", ms),
                     ("int8 library tower (torch._int_mm chain)", int_mm_ms),
                     ("bf16 cuDNN conv tower (FoldedAZResNet._conv)", cudnn_ms)):
        print(f"{label}, B={B}: {t:.4f} ms ({ops / t / 1e9:.1f} TOPS) | {card}", flush=True)
    return {"x": x, "w": w, "out": out, "ms": ms, "int_mm_ms": int_mm_ms, "cudnn_ms": cudnn_ms,
            "tops": ops / ms / 1e9, "launches": launches, "card": card}


if __name__ == "__main__":
    main()
