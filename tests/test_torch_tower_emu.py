"""The fused int8 tower's CUDA source (alphazero_tpu_torch/csrc/int8_tower.cu)
compiled with g++ against the CPU stand-in of tests/cuda_emu/ and run on
host memory, and the stand-ins of the Hopper instructions it uses, each held
against numpy.

* The stand-ins (tests/cuda_emu/cuda_runtime.h, probed through
  tests/cuda_emu/wgmma_probe.cpp): the int8 ``wgmma.mma_async`` with A and B
  from shared-memory descriptors (start address, LBO, SBO and the layout
  type, the 64-byte swizzle among them) against ``A @ B.T``, its
  asynchrony (nothing lands before ``wait_group``); the TMA tiled load of a
  tensor map encoded through ``cudaGetDriverEntryPointByVersion`` /
  ``cuTensorMapEncodeTiled``, box by box against the swizzle formula, zeros
  past the tensor's edge; the mbarrier's phase parity before and after the
  load completes.
* ``az_int8_tower`` against ``tower_plain``, bit for bit, at B = 1, one
  tile of 8 games, a tile and one, 11, 13, and two tiles and three
  (twice), with the main's and full-range weights and with weights that
  drive the sums toward their largest: the padded layout and its pad
  rows, the descriptors' shifts, the weight ring, the requantizing
  epilogue, the residual in registers, and no store for a tail tile's
  missing games.

Whether the source builds with nvcc and runs on the card is chip_smoke.py's
job.
"""

import ctypes

import numpy as np
import pytest
import torch

from alphazero_tpu_torch import kernels
from alphazero_tpu_torch.experiments import int8_fused_tower
from alphazero_tpu_torch.models import int8_tower
from tests.torch_parity import bits, build_emulated

_P = ctypes.c_void_p
_U32, _U64, _I = ctypes.c_uint32, ctypes.c_uint64, ctypes.c_int
LAYOUT_NONE, LAYOUT_B128, LAYOUT_B64, LAYOUT_B32 = 0, 1, 2, 3
SWIZZLE_BITS = {LAYOUT_B128: 3, LAYOUT_B64: 2, LAYOUT_B32: 1}
TMA_SWIZZLE = {"none": 0, "32B": 1, "64B": 2, "128B": 3}   # CUtensorMapSwizzle


@pytest.fixture(scope="module")
def emulated_tower():
    lib = build_emulated(sources=(kernels._CSRC / "int8_tower.cu",), probes=("wgmma_probe.cpp",))
    lib.lib.emu_probe_smem_window.restype = _U32
    lib.lib.emu_probe_tma_2d.argtypes = [_P, _U64, _U64, _U64, _U32, _U32, _I, _I, _I, _U32, _U32, _P,
                                         _U32, _P]
    lib.lib.emu_probe_wgmma.argtypes = [_P, _U32, _P, _P, _I, _I, _I, _P]
    lib.lib.emu_probe_wgmma.restype = None
    return lib


def swizzle(addr, b: int):
    """The 16-byte-unit swizzle of shared addresses: bits [4, 4+b) ^= [7, 7+b)."""
    return addr ^ (((addr >> 7) & ((1 << b) - 1)) << 4)


def descriptor(start: int, lbo: int, sbo: int, layout: int) -> int:
    return (start >> 4) | (lbo >> 4) << 16 | (sbo >> 4) << 32 | layout << 62


def matrix_addresses(rows: int, k: int, start: int, lbo: int, sbo: int, layout: int) -> np.ndarray:
    """Shared address of byte (row, k) of a K-major operand: no swizzle,
    8 x 16-byte core matrices (rows 16 bytes apart, 8-row groups SBO apart,
    16-byte K chunks LBO apart); swizzled, rows the swizzle's width apart,
    8-row groups SBO apart, K contiguous, then swizzled."""
    r, kk = np.meshgrid(np.arange(rows), np.arange(k), indexing="ij")
    if layout == LAYOUT_NONE:
        return start + r // 8 * sbo + r % 8 * 16 + kk // 16 * lbo + kk % 16
    b = SWIZZLE_BITS[layout]
    return swizzle(start + r // 8 * sbo + r % 8 * (16 << b) + kk, b)


def place(image: np.ndarray, window: int, mat: np.ndarray, addrs: np.ndarray) -> None:
    idx = addrs - window
    assert (idx >= 0).all() and (idx < image.size).all()
    assert np.unique(idx).size == idx.size, "the layout maps two bytes to one address"
    image[idx] = mat.view(np.uint8)


# (A's layout, A's start offset, B's layout, N, k32 steps): A no-swizzle at
# a start of any 16-byte row (the tower's shifted operand) with B 64-byte
# swizzled (the tower's TMA tiles, the second step 32 bytes into each row),
# and the other layouts.
WGMMA_CASES = [
    (LAYOUT_NONE, 16 * 7, LAYOUT_B64, 64, 2),
    (LAYOUT_NONE, 16 * 3, LAYOUT_NONE, 16, 3),
    (LAYOUT_B128, 0, LAYOUT_B128, 256, 4),
    (LAYOUT_B32, 0, LAYOUT_B32, 8, 1),
]


@pytest.mark.parametrize("a_layout,a_off,b_layout,n,steps", WGMMA_CASES,
                         ids=["A_none_B_sw64_N64", "A_none_B_none_N16", "sw128_N256", "sw32_N8"])
def test_emulated_wgmma_matches_numpy(emulated_tower, a_layout, a_off, b_layout, n, steps):
    """A chain of ``steps`` m64nNk32 s8 wgmma from descriptors equals
    ``A @ B.T`` over the chain's K, the first step overwriting the
    accumulators; read before ``wait_group`` they still hold their old
    values."""
    lib = emulated_tower.lib
    window = lib.emu_probe_smem_window()
    rng = np.random.default_rng(n + steps)
    K = 32 * steps
    a = rng.integers(-128, 128, (64, K), dtype=np.int8)
    b = rng.integers(-128, 128, (n, K), dtype=np.int8)
    smem = 1 << 17
    image = np.full(smem, 0xff, np.uint8)
    aligned = (window + 1023) // 1024 * 1024   # the swizzle's period
    da, db = [], []
    for side, mat, base, layout, rows in (("a", a, aligned + a_off, a_layout, 64),
                                          ("b", b, aligned + 0x8000, b_layout, n)):
        if layout == LAYOUT_NONE:   # chunk-major: all rows of a 16-byte K chunk contiguous
            lbo, sbo = rows * 16 + 64, 128
        else:   # each step 32 bytes further into the swizzled rows
            width = 16 << SWIZZLE_BITS[layout]
            assert 32 * steps <= width
            lbo, sbo = 16, 8 * width
        for s in range(steps):
            start = base + (2 * s * lbo if layout == LAYOUT_NONE else 32 * s)
            addrs = matrix_addresses(rows, 32, start, lbo, sbo, layout)
            place(image, window, np.ascontiguousarray(mat[:, 32 * s:32 * s + 32]), addrs)
            (da if side == "a" else db).append(descriptor(start, lbo, sbo, layout))
    want = a.astype(np.int64) @ b.astype(np.int64).T
    da, db = np.array(da, np.uint64), np.array(db, np.uint64)
    for wait in (1, 0):
        d = np.zeros((64, n), np.int32)
        lib.emu_probe_wgmma(image.ctypes.data, smem, da.ctypes.data, db.ctypes.data, steps, n, wait,
                            d.ctypes.data)
        if wait:
            np.testing.assert_array_equal(d, want)
        else:
            assert (d == 12345).all()


TMA_CASES = [
    # (swizzle, src rows, src cols, box cols, box rows, c0, c1)
    ("64B", 704, 576, 64, 64, 64 * 5, 64 * 10),   # the tower: tap 5 of layer 10
    ("64B", 704, 576, 64, 64, 0, 0),
    ("none", 40, 96, 48, 16, 32, 30),             # rows past the edge read zero
    ("128B", 64, 256, 128, 16, 128, 8),
    ("32B", 33, 64, 32, 8, 32, 29),
]


@pytest.mark.parametrize("swz,rows,cols,box_cols,box_rows,c0,c1", TMA_CASES,
                         ids=["tower_layer10_tap5", "tower_layer0_tap0", "none_edge", "sw128",
                              "sw32_edge"])
def test_emulated_tma_box_matches_swizzle_formula(emulated_tower, swz, rows, cols, box_cols,
                                                  box_rows, c0, c1):
    """The TMA box at (c0, c1) lands byte (r, i) at dst + r * inner + i,
    swizzled by the 16-byte-unit formula, zero past the tensor's edge, and
    nothing else moves; the mbarrier's phase 0 is open before the load and
    complete after it."""
    lib = emulated_tower.lib
    window = lib.emu_probe_smem_window()
    rng = np.random.default_rng(rows + c1)
    src = rng.integers(0, 256, (rows, cols), dtype=np.uint8)
    smem = 1 << 16
    dst = window - window % 1024 + 1024 + 2048   # 1024-aligned
    bar = dst + box_cols * box_rows + 64
    image = np.zeros(smem, np.uint8)
    flags = np.zeros(4, np.int32)
    rc = lib.emu_probe_tma_2d(src.ctypes.data, cols, rows, cols, box_cols, box_rows, TMA_SWIZZLE[swz],
                              c0, c1, dst, bar, image.ctypes.data, smem, flags.ctypes.data)
    assert rc == 0
    assert flags.tolist() == [0, 1, 1, 0]
    r, i = np.meshgrid(np.arange(box_rows), np.arange(box_cols), indexing="ij")
    addrs = dst + r * box_cols + i
    if swz != "none":
        addrs = swizzle(addrs, TMA_SWIZZLE[swz])
    inside = (c1 + r < rows) & (c0 + i < cols)
    want = np.where(inside, src[np.minimum(c1 + r, rows - 1), np.minimum(c0 + i, cols - 1)], 0)
    np.testing.assert_array_equal(image[addrs - window], want)
    rest = np.ones(smem, bool)
    rest[(addrs - window).ravel()] = False
    assert (image[rest] == 0xff).all()


@pytest.mark.parametrize("box_cols,stride,swz", [(128, 576, "64B"), (64, 600, "64B"), (512, 576, "none")],
                         ids=["box_wider_than_swizzle", "stride_not_16", "box_over_256"])
def test_emulated_tensor_map_encoder_refuses(emulated_tower, box_cols, stride, swz):
    """The emulated cuTensorMapEncodeTiled refuses what the driver does:
    a box row wider than the swizzle's span, a row stride not a multiple of
    16 bytes, a box side above 256."""
    lib = emulated_tower.lib
    src = np.zeros((64, 640), np.uint8)
    rc = lib.emu_probe_tma_2d(src.ctypes.data, 576, 64, stride, box_cols, 64, TMA_SWIZZLE[swz], 0, 0,
                              0, 0, None, 1 << 16, np.zeros(4, np.int32).ctypes.data)
    assert rc != 0


def widest_weights(seed: int) -> list:
    """Weights that drive the sums toward their largest magnitude
    (576 * 127 * 127 < 2^24): every tap +127 into output channels 0-31 and
    -127 into 32-63, with a few random entries, so interior cells sum about
    +-4.6e6 once the activations clip."""
    rng = np.random.default_rng(seed)
    ws = []
    for _ in range(int8_tower.N_LAYERS):
        w = np.where(np.arange(int8_tower.CH) < 32, 127, -127).astype(np.int8)[None, :].repeat(576, 0)
        noise = rng.random(w.shape) < 0.05
        w[noise] = rng.integers(-127, 128, noise.sum())
        ws.append(w)
    return ws


def widest_inputs(seed: int, B: int):
    x = np.random.default_rng(seed).uniform(0, 1, (B * 42, 64)).astype(np.float32)
    return x, widest_weights(seed)


@pytest.mark.parametrize(
    "B,seed,low,high",
    [(1, 1, -127, 128), (13, 13, -16, 16), (19, 19, -127, 128), (8, 8, -127, 128),
     (9, 9, -127, 128), (19, 119, -127, 128), (11, 5, None, None)],
    ids=["B1_full_range", "B13_main_weights", "B19_full_range", "B8_one_tile_full_range",
         "B9_tile_plus_one_full_range", "B19_two_tiles_plus_three_seed119", "B11_widest_sums"],
)
def test_emulated_int8_tower_bit_equal_plain(emulated_tower, B, seed, low, high):
    """``az_int8_tower`` (blocks of 8 games) against ``tower_plain``,
    bit-equal: the int8 wgmma on the padded layout with its shifted
    descriptors, the TMA weight ring, the requantizing epilogue (full-range
    weights reach the clip) with its pad rows, the residual carried in
    registers, and no store for the missing games of a tail tile (the output
    buffer runs on for a tile of NaN rows, which must stay NaN).
    ``B11_widest_sums`` (``widest_weights``) drives the sums past 2^22,
    toward the largest that can occur; every sum stays below 2^24, so the
    epilogue's int->float conversion is exact there too."""
    if low is None:
        x, ws = widest_inputs(seed, B)
    else:
        x, ws = int8_fused_tower.random_tower_inputs(seed, B, low, high)
    x = torch.from_numpy(x).clone()
    w = int8_tower.tower_weights_from_jax(ws).clone()
    buf = torch.full(((B + 8) * 42, 64), float("nan"))
    rc = emulated_tower.lib.az_int8_tower(x.data_ptr(), w.data_ptr(), buf.data_ptr(), B, None)
    assert rc == 0
    want = int8_tower.tower_plain(x, w)
    assert torch.equal(bits(buf[:B * 42]), bits(want))
    assert buf[B * 42:].isnan().all()
    if high == 128:
        assert (want * int8_tower.ASCALE > 127).any()
    if low is None:
        widest = []

        def conv_acc(q, wl):
            acc = int8_tower.patches(q).double() @ wl.double().t()
            widest.append(float(acc.abs().max()))
            return acc.float()

        int8_tower.tower(x, w, conv_acc)
        assert 2 ** 22 <= max(widest) < 2 ** 24
