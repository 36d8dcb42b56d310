"""The port's fused int8 tower (alphazero_tpu_torch/models/int8_tower.py)
against the reference experiment's Pallas
``tower_kernel`` (experiments/int8_fused_tower.py), run in the Pallas
interpreter on the same numpy inputs: the plain version must be bit-equal
(the function is exact integer arithmetic with power-of-two scales, one
rounded residual add and round-half-to-even requantization). The kernel
itself is held to the plain version through g++ in
tests/test_torch_tower_emu.py, and on the card by chip_smoke.py's phase 13.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from alphazero_tpu_torch import kernels
from alphazero_tpu_torch.experiments import int8_fused_tower as experiment
from alphazero_tpu_torch.models import int8_tower as port

REF_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "experiments", "int8_fused_tower.py")
_CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(scope="module")
def ref():
    """The reference experiment's module, loaded by path. Its import points
    JAX's compilation cache at the repository; both settings are put back
    right after."""
    saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    spec = importlib.util.spec_from_file_location("reference_int8_fused_tower", REF_PATH)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


def _reference_tower(ref, x: np.ndarray, ws, Bb: int) -> np.ndarray:
    """The reference main's pallas_call at block Bb, in the interpreter."""
    B = x.shape[0] // ref.CELLS
    M = Bb * ref.CELLS
    n_layers = len(ws)
    call = pl.pallas_call(
        functools.partial(ref.tower_kernel, n_layers=n_layers),
        grid=(B // Bb,),
        in_specs=[pl.BlockSpec((M, ref.CH), lambda i: (i, 0)),
                  pl.BlockSpec((9, M), lambda i: (0, 0))]
        + [pl.BlockSpec(w.shape, lambda i: (0, 0)) for w in ws],
        out_specs=pl.BlockSpec((M, ref.CH), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((B * ref.CELLS, ref.CH), jnp.float32),
        interpret=True,
    )
    out = call(jnp.asarray(x), jnp.asarray(ref.make_boundary_masks(Bb)),
               *[jnp.asarray(w) for w in ws])
    return np.asarray(out)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(np.int32)


def test_constants_match_the_reference(ref):
    for name in ("ROWS", "COLS", "CH", "BLOCKS", "CELLS", "WSCALE", "ASCALE"):
        assert getattr(port, name) == getattr(ref, name), name


@pytest.mark.parametrize("B,Bb", [(8, 4), (8, 8)], ids=["B8_Bb4", "B8_Bb8"])
@pytest.mark.parametrize("low,high", [(-16, 16), (-127, 128)], ids=["main_weights", "full_range"])
def test_plain_tower_bit_equal_reference_kernel(ref, B, Bb, low, high):
    """``tower_plain`` against the Pallas ``tower_kernel`` on the main's
    generator (seed 0): bit-equal at either block, so the reference's
    blocking is layout; full-range weights drive activations into the clip."""
    x, ws = experiment.random_tower_inputs(0, B, low, high)
    want = _reference_tower(ref, x, ws, Bb)
    got = kernels.int8_tower(torch.from_numpy(x), port.tower_weights_from_jax(ws))
    assert got.shape == (B * port.CELLS, port.CH)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    if high == 128:
        assert (want * port.ASCALE > 127).any()   # the clip is reached


def test_main_generator_matches_the_reference_draws():
    """``random_tower_inputs`` draws as the reference main does."""
    rng = np.random.default_rng(3)
    x_ref = np.asarray(jnp.asarray(rng.uniform(-1, 1, (2 * 42, 64)), jnp.float32))
    w_ref = [np.asarray(jnp.asarray(rng.integers(-16, 16, (576, 64)), jnp.int8)) for _ in range(11)]
    x, ws = experiment.random_tower_inputs(3, 2)
    np.testing.assert_array_equal(x, x_ref)
    for a, b in zip(ws, w_ref):
        np.testing.assert_array_equal(a, b)


def test_requantization_rounds_half_to_even(ref):
    """Hand-built ties that reach the output. Every cell holds q = 8 in
    input channel 0; the stem's centre tap maps it to output channels 0..5
    with weights 1, 3, 5, 7, 9, 11, so acc = 8w, f = w/64 and f * 32 = w/2,
    each exactly k + 0.5. Half to even quantizes them to 0, 2, 2, 4, 4, 6
    (half away from zero would give 1, 2, 3, 4, 5, 6). Block 0's convs copy
    channel c to c with weight 16 (acc = 16q, f = q/32), so its output is
    q_stem/32 + f_stem; the other blocks have zero weights and carry it."""
    x = np.zeros((42, 64), np.float32)
    x[:, 0] = 8 / 32.0
    wvals = (1, 3, 5, 7, 9, 11)
    ws = [np.zeros((576, 64), np.int8) for _ in range(11)]
    centre = 4 * 64                        # tap (dr, dc) = (0, 0)
    for c, wv in enumerate(wvals):
        ws[0][centre + 0, c] = wv
        ws[1][centre + c, c] = 16
        ws[2][centre + c, c] = 16
    got = port.tower_plain(torch.from_numpy(x), port.tower_weights_from_jax(ws))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(_reference_tower(ref, x, ws, 1)))
    even = (0, 2, 2, 4, 4, 6)
    want = torch.tensor([q / 32 + wv / 64 for q, wv in zip(even, wvals)])
    assert torch.equal(got[:, :6], want.expand(42, 6))
    assert (got[:, 6:] == 0).all()


def test_tower_weights_layout_round_trip():
    """``tower_weights_from_jax``: row tap*64 + c_in of layer l's reference
    weight, column n, is w[l, n, tap*64 + c_in]; transposing back restores
    the reference's arrays; wrong shapes and dtypes raise."""
    _, ws = experiment.random_tower_inputs(1, 1, -127, 128)
    w = port.tower_weights_from_jax(ws)
    assert w.dtype == torch.int8 and w.shape == (11, 64, 576) and w.is_contiguous()
    for l in (0, 5, 10):
        np.testing.assert_array_equal(w[l].numpy().T, ws[l])
    assert int(w[3, 7, 2 * 64 + 5]) == int(ws[3][2 * 64 + 5, 7])
    with pytest.raises(ValueError):
        port.tower_weights_from_jax(ws[:10])
    with pytest.raises(ValueError):
        port.tower_weights_from_jax([a.astype(np.int16) for a in ws])


def test_int_mm_yardstick_bit_equal_plain():
    """The library yardstick (``torch._int_mm`` on int8 patches) computes
    the plain version's function to the bit."""
    x, ws = experiment.random_tower_inputs(2, 5, -127, 128)
    x, w = torch.from_numpy(x), port.tower_weights_from_jax(ws)
    assert torch.equal(experiment.int_mm_tower(x, w).view(torch.int32), port.tower_plain(x, w).view(torch.int32))


def test_wrapper_checks_shapes_and_runs_plain_on_cpu():
    x, ws = experiment.random_tower_inputs(0, 2)
    x, w = torch.from_numpy(x), port.tower_weights_from_jax(ws)
    kernels.reset_launch_counts()
    out = kernels.int8_tower(x, w)
    assert kernels.launch_counts()["int8_tower"] == 0   # the plain version is no launch
    assert torch.equal(out, port.tower_plain(x, w))
    with pytest.raises(ValueError):
        kernels.int8_tower(x[:41], w)
    with pytest.raises(ValueError):
        kernels.int8_tower(x, w[:10])
    with pytest.raises(ValueError):
        kernels.int8_tower(x.double(), w)


def test_board_ops_count_the_patches_on_board():
    """The bound's operation count: a game's patches hold BOARD_PAIRS
    on-board (cell, tap) pairs, the rest the SAME padding's zeros."""
    q = torch.ones(2 * port.CELLS, port.CH, dtype=torch.int8)
    assert int(port.patches(q).count_nonzero()) == 2 * port.BOARD_PAIRS * port.CH == 2 * 304 * 64
    assert port.board_ops(2) * port.TAPS * port.CELLS == port.tower_ops(2) * port.BOARD_PAIRS


@pytest.mark.parametrize("B", [1, 3, 8])
def test_padded_layout_reads_zeros_exactly_off_the_board(B):
    """The kernel's padded board (a zero row and a zero column a game): each
    tap's operand, the padded rows shifted by ``padded_shift(tap)``, equals
    the reference's patches, so it reads a zero exactly where the cell's
    neighbour is off the board, neighbouring games included; the pad rows
    and columns hold zeros and the board's cells in order."""
    q = torch.from_numpy(np.random.default_rng(B).integers(1, 128, (B * port.CELLS, port.CH))
                         .astype(np.int8))   # no zero on the board
    got = port.padded_patches(q)
    assert torch.equal(got, port.patches(q))
    off = (got.view(B * port.CELLS, port.TAPS, port.CH) == 0).all(dim=2)
    assert int(off.sum()) == B * (port.CELLS * port.TAPS - port.BOARD_PAIRS)
    rows = port.padded_rows(q).view(B, 1 + port.ROWS, port.PAD_COLS, port.CH)
    assert (rows[:, 0] == 0).all() and (rows[:, :, port.COLS:] == 0).all()
    assert torch.equal(rows[:, 1:, :port.COLS].reshape(-1, port.CH), q)
    assert sorted(port.padded_shift(t) for t in range(port.TAPS)) == [-9, -8, -7, -1, 0, 1, 7, 8, 9]
