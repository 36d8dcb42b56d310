"""The port's host example store (``alphazero_tpu_torch/native.py`` over
``csrc/example_store.cpp``) against the JAX package's
(``alphazero_tpu/native.py``): the same appends give byte-identical
``.examples`` files, each store reads the other's files bit for bit, a
full store evicts its oldest rows, and a corrupted file is refused by
both."""

import numpy as np
import pytest

from alphazero_tpu import native as jax_native
from alphazero_tpu_torch import native

F, A = 84, 7      # Connect-Four's features and actions

STORES = {"port": native.ExampleStore, "jax": jax_native.ExampleStore}


@pytest.fixture(autouse=True)
def needs_gxx():
    if not native.available() or not jax_native.available():
        pytest.skip("no g++ to build the example stores")


def _rows(n: int, seed: int):
    """``n`` samples with every float bit pattern class a sample can hold:
    0/1 planes, a policy with -0.0 and subnormals, values of both signs."""
    rng = np.random.default_rng(seed)
    feats = (rng.random((n, F)) < 0.3).astype(np.float32)
    pis = rng.random((n, A)).astype(np.float32)
    pis[:, 0] = -0.0
    pis[:, 1] = np.float32(1e-40)
    vals = rng.choice(np.float32([-1.0, 0.0, 1.0, 0.5]), n)
    return feats, pis, vals


def _fill(cls, capacity: int, batches):
    store = cls(capacity, F, A)
    for rows in batches:
        store.append(*rows)
    return store


def _bits(*arrays):
    return [np.ascontiguousarray(a).view(np.uint32) for a in arrays]


def _assert_rows_equal(got, want):
    for g, w in zip(_bits(*got), _bits(*want)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("capacity", [64, 9], ids=["room", "wrapped"])
def test_same_appends_give_the_same_bytes(tmp_path, capacity):
    """Two batches of appends (past the capacity in the wrapped case, so
    the ring cursor is mid-arena): both stores save the same file."""
    batches = [_rows(5, 1), _rows(7, 2)]
    paths = {}
    for name, cls in STORES.items():
        store = _fill(cls, capacity, batches)
        assert len(store) == min(12, capacity) and store.total == 12
        paths[name] = tmp_path / f"{name}.examples"
        store.save(str(paths[name]))
    assert paths["port"].read_bytes() == paths["jax"].read_bytes()
    header = np.frombuffer(paths["port"].read_bytes()[:56], np.uint8)
    assert bytes(header[:8]) == b"OTSUPTZA"     # "AZTPUSTO", little-endian
    assert paths["port"].stat().st_size == 56 + min(12, capacity) * 4 * (F + A + 1)


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_each_store_reads_the_others_file(tmp_path, writer, reader):
    rows = _rows(11, 3)
    path = str(tmp_path / "1.examples")
    _fill(STORES[writer], 32, [rows]).save(path)
    loaded = STORES[reader](32, F, A)
    loaded.load(path)
    assert len(loaded) == 11 and loaded.total == 11
    _assert_rows_equal(loaded.read(0, 11), rows)
    _assert_rows_equal(loaded.read(4, 3), [x[4:7] for x in rows])
    assert [len(x) for x in loaded.read(9, 10)] == [2, 2, 2]
    assert [len(x) for x in loaded.read(11, 1)] == [0, 0, 0]


@pytest.mark.parametrize("name", ["port", "jax"])
def test_a_full_store_evicts_its_oldest_rows(tmp_path, name):
    """FIFO: 3 then 4 rows into 5 slots keep the newest 5, oldest first,
    through a save and a load into a store of another capacity."""
    first, second = _rows(3, 4), _rows(4, 5)
    store = _fill(STORES[name], 5, [first, second])
    assert len(store) == 5 and store.total == 7
    want = [np.concatenate([a[2:], b]) for a, b in zip(first, second)]
    _assert_rows_equal(store.read(0, 5), want)
    path = str(tmp_path / "ring.examples")
    store.save(path)
    small = STORES[name](2, F, A)
    small.load(path)
    assert len(small) == 2 and small.total == 7
    _assert_rows_equal(small.read(0, 2), [x[3:] for x in want])


@pytest.mark.parametrize("name", ["port", "jax"])
@pytest.mark.parametrize("fault,rc", [("payload", 5), ("checksum", 5), ("magic", 3),
                                      ("geometry", 4), ("cut", 2)])
def test_a_damaged_file_is_refused(tmp_path, name, fault, rc):
    """A file written by the port's store, damaged: a flipped payload bit
    or checksum (rc 5), a wrong magic (3), another geometry (4), a cut
    file (2); the JAX store refuses it alike."""
    path = tmp_path / "bad.examples"
    _fill(native.ExampleStore, 16, [_rows(6, 6)]).save(str(path))
    raw = bytearray(path.read_bytes())
    if fault == "payload":
        raw[56 + 4 * F + 3] ^= 0x01
    elif fault == "checksum":
        raw[48] ^= 0x80
    elif fault == "magic":
        raw[0] ^= 0xFF
    elif fault == "cut":
        raw = raw[:-5]
    path.write_bytes(bytes(raw))
    store = STORES[name](16, F + (fault == "geometry"), A)
    with pytest.raises(IOError, match=f"rc={rc}"):
        store.load(str(path))


def test_appends_of_another_width_raise():
    store = native.ExampleStore(4, F, A)
    feats, pis, vals = _rows(2, 7)
    with pytest.raises(ValueError, match="features"):
        store.append(feats[:, 1:], pis, vals)
    assert len(store) == 0 and store.capacity == 4


def test_an_append_of_no_rows_adds_nothing(tmp_path):
    """An iteration whose games were all cut short has no valid sample: the
    port's store takes the empty append (and the coach saves the file as it
    was), where the JAX store's reshape raises (ROADMAP queue 3)."""
    feats, pis, vals = (x[:0] for x in _rows(1, 8))
    store = _fill(native.ExampleStore, 4, [_rows(2, 9), (feats, pis, vals)])
    assert len(store) == 2 and store.total == 2
    with pytest.raises(ValueError, match="reshape"):
        jax_native.ExampleStore(4, F, A).append(feats, pis, vals)
