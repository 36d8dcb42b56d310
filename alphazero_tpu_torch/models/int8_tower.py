"""The fused int8 ResNet tower's function: the counterpart of
``tower_kernel`` in the repository's ``experiments/int8_fused_tower.py``.

The whole Connect-Four ResNet tower — a stem conv and 5 residual blocks of
two convs, 11 convs of 3x3 SAME from 64 to 64 channels on the 6x7 board —
with int8 activations and weights, exact integer products and every layer
requantized in its epilogue. ``tower_plain`` is the plain PyTorch version
of the kernel ``az_int8_tower`` (``csrc/int8_tower.cu``,
``kernels.int8_tower``); ``experiments/int8_fused_tower.py`` times both.

Layout (the reference's): activations f32[B*42, 64], rows game-major
b*42 + r*7 + c. A layer's weights hold K = 9 taps x 64 input channels,
row tap*64 + c_in with tap = (dr+1)*3 + (dc+1); the reference stores them
int8[576, 64], the port int8[11, 64, 576], K-contiguous per output channel
as the tensor cores' K-major operand takes them (``tower_weights_from_jax``).
The kernel computes on a padded board (``padded_rows``: per game a zero
row, then each board row and a zero column), where each tap's operand is
the rows shifted by ``padded_shift(tap)``; ``padded_patches`` is that
im2col in plain PyTorch, equal to ``patches``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

ROWS, COLS, CH, BLOCKS = 6, 7, 64, 5
CELLS = ROWS * COLS
TAPS = 9
N_LAYERS = 1 + 2 * BLOCKS
WSCALE = 1.0 / 16.0   # weight quant scale (the reference's fake calibration)
ASCALE = 32.0         # activation quant scale (the same)
# (cell, tap) pairs of one game whose neighbour lies on the board: the
# others multiply the SAME padding's zeros
BOARD_PAIRS = sum((ROWS - abs(dr)) * (COLS - abs(dc)) for dr in (-1, 0, 1) for dc in (-1, 0, 1))
# the kernel's padded board (csrc/int8_tower.cu): a zero row of PAD_COLS
# cells, then each board row with a zero column after it; GAME_ROWS rows a
# game
PAD_COLS = COLS + 1
GAME_ROWS = PAD_COLS * (1 + ROWS)


def tower_ops(B: int) -> int:
    """The reference's operation count of one tower (every cell's 9 taps):
    2 per multiply-add."""
    return 2 * B * CELLS * TAPS * CH * CH * N_LAYERS


def board_ops(B: int) -> int:
    """The operations one tower needs: 2 per multiply-add of the (cell,
    tap) pairs whose neighbour is on the board (304 of a game's 378)."""
    return 2 * B * BOARD_PAIRS * CH * CH * N_LAYERS


def tower_weights_from_jax(ws: Sequence[np.ndarray]) -> torch.Tensor:
    """The reference's 11 layer weights int8[576, 64] (row tap*64 + c_in)
    as the port's int8[11, 64, 576]: each output channel's 576 taps
    contiguous."""
    w = np.stack([np.asarray(x) for x in ws])
    if w.shape != (N_LAYERS, TAPS * CH, CH) or w.dtype != np.int8:
        raise ValueError(f"expected {N_LAYERS} int8[{TAPS * CH}, {CH}] weights, got "
                         f"{w.dtype}{list(w.shape)}")
    return torch.from_numpy(np.ascontiguousarray(w.transpose(0, 2, 1)))


def quantize(f: torch.Tensor) -> torch.Tensor:
    """f32 -> int8 at ASCALE: round half to even, clip to +-127."""
    return torch.clamp(torch.round(f * ASCALE), -127.0, 127.0).to(torch.int8)


def patches(q: torch.Tensor) -> torch.Tensor:
    """int8[B*42, 64] -> the 3x3 SAME conv's patches int8[B*42, 576], row
    tap*64 + c_in of each cell's tap (dr, dc), zero off the board."""
    B = q.shape[0] // CELLS
    pad = q.new_zeros(B, ROWS + 2, COLS + 2, CH)
    pad[:, 1:-1, 1:-1] = q.view(B, ROWS, COLS, CH)
    taps = [pad[:, 1 + dr:1 + dr + ROWS, 1 + dc:1 + dc + COLS]
            for dr in (-1, 0, 1) for dc in (-1, 0, 1)]
    return torch.cat(taps, dim=-1).view(B * CELLS, TAPS * CH)


def padded_rows(q: torch.Tensor) -> torch.Tensor:
    """int8[B*42, 64] -> the kernel's padded layout int8[B*GAME_ROWS, 64]:
    per game a zero row, then each board row and a zero column."""
    B = q.shape[0] // CELLS
    pad = q.new_zeros(B, 1 + ROWS, PAD_COLS, CH)
    pad[:, 1:, :COLS] = q.view(B, ROWS, COLS, CH)
    return pad.view(B * GAME_ROWS, CH)


def padded_shift(tap: int) -> int:
    """Rows from a cell to its tap (dr, dc) neighbour in the padded layout."""
    return (tap // 3 - 1) * PAD_COLS + tap % 3 - 1


def padded_patches(q: torch.Tensor) -> torch.Tensor:
    """``patches(q)`` the kernel's way: each tap's operand is the padded
    rows shifted by ``padded_shift(tap)``, zero past either end, read at the
    board's cells. Equal to ``patches(q)`` because every neighbour off the
    board lands on a pad row or column."""
    rows = padded_rows(q)
    n = rows.shape[0]
    halo = PAD_COLS + 1
    ext = torch.cat([rows.new_zeros(halo, CH), rows, rows.new_zeros(halo, CH)])
    cells = torch.arange(n).view(-1, GAME_ROWS)[:, PAD_COLS:].reshape(-1, PAD_COLS)[:, :COLS]
    cells = cells.reshape(-1)
    return torch.cat([ext[halo + cells + padded_shift(tap)] for tap in range(TAPS)], dim=-1)


def _requant(acc: torch.Tensor, res: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``conv_q`` epilogue on the exact f32 product: scale,
    residual add, ReLU, then the next layer's int8 input. ``(q, f)``."""
    f = acc * (WSCALE / ASCALE)
    if res is not None:
        f = f + res
    f = torch.relu(f)
    return quantize(f), f


def check_tower_args(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != CH or x.shape[0] % CELLS \
            or x.shape[0] == 0:
        raise ValueError(f"x: expected f32[B*{CELLS}, {CH}] with B >= 1, got {x.dtype}{list(x.shape)}")
    if w.dtype != torch.int8 or tuple(w.shape) != (N_LAYERS, CH, TAPS * CH):
        raise ValueError(f"w: expected int8[{N_LAYERS}, {CH}, {TAPS * CH}], got {w.dtype}{list(w.shape)}")


def tower(x: torch.Tensor, w: torch.Tensor, conv_acc: Callable) -> torch.Tensor:
    """The reference's tower with the conv product ``conv_acc(q, w_layer)``
    (exact, as f32): stem, then per block a conv and a conv with the
    block's residual. The last block's f."""
    check_tower_args(x, w)
    q = quantize(x)
    q, f = _requant(conv_acc(q, w[0]), None)
    for b in range(BLOCKS):
        q1, _ = _requant(conv_acc(q, w[1 + 2 * b]), None)
        q, f = _requant(conv_acc(q1, w[2 + 2 * b]), f)
    return f


def tower_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version of the fused tower (the reference's
    ``tower_kernel``): x f32[B*42, 64], w int8[11, 64, 576] -> the last
    block's f f32[B*42, 64], on the CPU or the card.

    The product runs in f32 and is exact: every operand is an integer of
    at most 127 in magnitude, so each partial sum of the 576 terms is an
    integer below 576 * 127 * 127 < 2**24, which f32 holds exactly in any
    order of summation (the card has no int32 matmul). The epilogue is then
    the reference's to the bit: the scales are powers of two, the residual
    add is the one rounding step, and ``torch.round`` rounds half to even
    as ``jnp.round`` does."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("tower_plain needs full-f32 matmuls: TF32 would round the product")

    def conv_acc(q, wl):
        return patches(q).float() @ wl.float().t()

    return tower(x, w, conv_acc)
