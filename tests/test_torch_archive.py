"""The port coach's host example archive (``{iteration}.examples``,
``alphazero_tpu_torch/coach.py`` over ``native.ExampleStore``) and
``utils.timing.profiler_trace``, on the CPU.

The archive's rows are held bit for bit against the valid samples of the
coach's own trajectories, and read by the JAX package's store too. Exact
agreement with the JAX coach's files is impossible (the two packages draw
different random numbers), so against the JAX coach on the same config
the files' names, header geometry, shapes and rows per valid sample are
compared. (A mesh of two ranks writes none: the mesh coach's checkpoint
directory holds only checkpoints and metrics,
``tests/test_torch_parallel.py::test_mesh_coach_matches_one_process``.)"""

import dataclasses
import json
import logging
import struct

import numpy as np
import pytest
import torch

from alphazero_tpu import native as jax_native
from alphazero_tpu_torch import native
from alphazero_tpu_torch.coach import Coach
from alphazero_tpu_torch.games import ConnectFour
from alphazero_tpu_torch.models import MLPNet
from alphazero_tpu_torch.utils.timing import profiler_trace
from tests.torch_parity import outer_cfg, port_az_config

ITERATIONS = 3
F, A = 84, 7


def _cfg(checkpoint_dir):
    """``outer_cfg`` without the anchored pass, archiving into
    ``checkpoint_dir`` and saving no checkpoint within the run."""
    return dataclasses.replace(outer_cfg(anchor_interval=None), checkpoint_dir=str(checkpoint_dir),
                               checkpoint_interval=1000)


def _header(path):
    """(magic, version, feat_size, num_actions, count, pos, total) of an
    ``.examples`` file."""
    magic, version, feat, acts, _, count, pos, total, _ = struct.unpack(
        "<QIIIIQQQQ", path.read_bytes()[:56])
    return magic, version, feat, acts, count, pos, total


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The port coach, ``ITERATIONS`` iterations, with every trajectory its
    self-play returned."""
    if not native.available():
        pytest.skip("no g++ to build the example store")
    d = tmp_path_factory.mktemp("port_archive")
    torch.manual_seed(0)
    coach = Coach(ConnectFour(), MLPNet(A, hidden=(16,)), port_az_config(_cfg(d)), device="cpu")
    trajs = []
    play = coach._selfplay

    def recording(*args):
        out = play(*args)
        trajs.append(out[0])
        return out

    coach._selfplay = recording
    records = [coach.run_iteration() for _ in range(ITERATIONS)]
    return d, trajs, records


def _valid_rows(traj):
    valid = traj.valid.reshape(-1)
    n = valid.shape[0]
    return (traj.features.reshape(n, -1)[valid].numpy(), traj.pi.reshape(n, -1)[valid].numpy(),
            traj.value.reshape(-1)[valid].numpy())


def test_archive_holds_each_iterations_valid_rows(port_run):
    """``{i}.examples`` (``i`` the iteration count before the iteration,
    as the JAX coach names them) holds the valid samples of iterations 0
    to ``i``, oldest first, bit for bit, through the port's store and the
    JAX one."""
    d, trajs, records = port_run
    assert sorted(p.name for p in d.glob("*.examples")) == [f"{i}.examples" for i in range(ITERATIONS)]
    for i in range(ITERATIONS):
        want = [np.concatenate(x) for x in zip(*map(_valid_rows, trajs[:i + 1]))]
        n = len(want[2])
        assert n == sum(r["selfplay_moves"] for r in records[:i + 1])   # every game finishes
        for cls in (native.ExampleStore, jax_native.ExampleStore):
            store = cls(1 << 14, F, A)
            store.load(str(d / f"{i}.examples"))
            assert len(store) == n and store.total == n
            for got, w in zip(store.read(0, n), want):
                np.testing.assert_array_equal(got.view(np.uint32), w.view(np.uint32))


def test_archive_matches_the_jax_coachs_files(port_run, tmp_path):
    """The JAX coach on the same config: the same file names, header
    geometry and one row per valid sample, so the same file sizes for the
    same number of moves."""
    from alphazero_tpu.coach import Coach as JaxCoach
    from alphazero_tpu.games import ConnectFour as JaxConnectFour
    from alphazero_tpu.models import MLPNet as JaxMLPNet

    if not jax_native.available():
        pytest.skip("no g++ to build the JAX example store")
    jg = JaxConnectFour()
    coach = JaxCoach(jg, JaxMLPNet(num_actions=A, hidden=(16,)), _cfg(tmp_path))
    jax_records = [coach.run_iteration() for _ in range(2)]
    d, _, records = port_run
    for i, (jr, pr) in enumerate(zip(jax_records, records)):
        jh, ph = _header(tmp_path / f"{i}.examples"), _header(d / f"{i}.examples")
        assert jh[:4] == ph[:4] == (0x415A54505553544F, 1, F, A)
        for h, recs in ((jh, jax_records), (ph, records)):
            moves = sum(r["selfplay_moves"] for r in recs[:i + 1])
            assert h[4] == h[6] == moves and h[5] == moves    # count, total, ring cursor
        size = lambda h: 56 + h[4] * 4 * (F + A + 1)   # noqa: E731
        assert (tmp_path / f"{i}.examples").stat().st_size == size(jh)
        assert (d / f"{i}.examples").stat().st_size == size(ph)
        store = jax_native.ExampleStore(1 << 14, F, A)
        store.load(str(tmp_path / f"{i}.examples"))
        assert [x.shape for x in store.read(0, jh[4])] == [(jh[4], F), (jh[4], A), (jh[4],)]


def test_without_gxx_the_coach_warns_once_and_archives_nothing(monkeypatch, caplog, tmp_path):
    monkeypatch.setattr(native, "available", lambda: False)
    torch.manual_seed(0)
    with caplog.at_level(logging.WARNING, logger="alphazero_tpu_torch.coach"):
        coach = Coach(ConnectFour(), MLPNet(A, hidden=(16,)), port_az_config(_cfg(tmp_path)),
                      device="cpu")
        coach.run_iteration()
    assert coach.example_store is None
    assert [r.getMessage() for r in caplog.records if "g++" in r.getMessage()] == [
        "no g++ on PATH: the host example archive ({iteration}.examples) is not written"]
    assert not list(tmp_path.glob("*.examples"))


@pytest.mark.parametrize("log_dir", [None, ""])
def test_profiler_trace_without_a_directory_is_a_no_op(monkeypatch, tmp_path, log_dir):
    monkeypatch.chdir(tmp_path)
    with profiler_trace(log_dir) as prof:
        torch.ones(4).sum()
    assert prof is None
    assert not list(tmp_path.iterdir())


def test_profiler_trace_writes_a_chrome_trace_of_the_block(tmp_path):
    """On the CPU: one chrome trace in the directory (made if missing)
    holding the block's operators."""
    log_dir = tmp_path / "trace"
    with profiler_trace(str(log_dir)) as prof:
        x = torch.ones(8, 8)
        (x @ x).relu()
    files = list(log_dir.glob("trace_*.json"))
    assert [str(f) for f in files] == [prof.trace_path]
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events if e.get("ph") == "X"}
    assert {"aten::mm", "aten::relu"} <= names


def test_profiler_trace_is_written_when_the_block_raises(tmp_path):
    with pytest.raises(RuntimeError, match="inside"):
        with profiler_trace(str(tmp_path)):
            torch.ones(3).cumsum(0)
            raise RuntimeError("inside")
    (trace,) = tmp_path.glob("trace_*.json")
    assert "aten::cumsum" in trace.read_text()
