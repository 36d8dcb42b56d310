"""The port's multi-process CLI (``alphazero_tpu_torch.examples.
train_multihost``) as tests/test_multihost.py holds the JAX one: two OS
processes, joined into one gloo group on 127.0.0.1 by
``parallel.distributed.launch_local_multihost``, must reproduce the
one-process coach run of the identical config (the CLI's own
``build_cfg`` and ``build_game_and_model``), write a checkpoint that a
new pair resumes, and take the JAX CLI's configuration field by field."""

import concurrent.futures
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from alphazero_tpu_torch.checkpoint import latest_step
from alphazero_tpu_torch.examples import train_multihost as tm
from alphazero_tpu_torch.parallel.distributed import launch_local_multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = [
    "--net", "mlp", "--hidden", "32",
    "--sims", "8", "--max-depth", "16",
    "--batch", "16", "--temp-threshold", "6",
    "--capacity", "2048", "--train-batch", "32", "--train-steps", "4",
    "--arena-games", "8", "--seed", "7",
]
UNUSED = ["--coordinator", "unused", "--num-processes", "1", "--process-id", "0"]


def _launch_pair(extra):
    return launch_local_multihost(TINY + extra, timeout=150, platform="cpu", backend="gloo")


def _reference_record():
    """The one-process coach iteration of the IDENTICAL config."""
    from alphazero_tpu_torch.coach import Coach

    args = tm.parse_args(UNUSED + TINY + ["--iterations", "1"])
    game, model = tm.build_game_and_model(args)
    return Coach(game, model, tm.build_cfg(args), device="cpu").run_iteration()


def test_two_process_coach_matches_single_process(tmp_path):
    ckpt = str(tmp_path / "mh_ckpt")
    # the pair runs while this process runs the reference
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        pair = pool.submit(_launch_pair, ["--iterations", "1", "--checkpoint-dir", ckpt])
        ref = _reference_record()
        records = pair.result()

    got = records[-1]
    for k in (
        "iteration", "model_id", "accepted",
        "arena_wins", "arena_losses", "arena_draws",
        "replay_size", "replay_total", "selfplay_moves",
    ):
        assert got[k] == ref[k], (k, got[k], ref[k])
    assert got["loss_first"] == pytest.approx(ref["loss_first"], abs=1e-5)
    assert got["loss_last"] == pytest.approx(ref["loss_last"], abs=1e-5)

    # rank 0 wrote the checkpoint (and the metrics, once)...
    assert latest_step(ckpt) == 1
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        assert len(f.read().splitlines()) == 1

    # ...that a NEW pair resumes from: the iteration continues at 2
    records2 = _launch_pair(["--iterations", "1", "--checkpoint-dir", ckpt])
    assert records2[-1]["iteration"] == 2
    assert latest_step(ckpt) == 2


def test_build_cfg_matches_the_jax_cli():
    """The port's ``build_cfg`` and model widths are the JAX CLI's, field
    by field, for the test's flags and for the defaults."""
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        import train_multihost as jax_tm
    finally:
        sys.path.pop(0)
    for argv in (UNUSED + TINY, UNUSED, UNUSED + ["--net", "resnet", "--game", "othello"]):
        jargs, pargs = jax_tm.parse_args(argv), tm.parse_args(argv)
        assert {k: v for k, v in vars(pargs).items() if k != "backend"} == vars(jargs)
        assert dataclasses.asdict(tm.build_cfg(pargs)) == dataclasses.asdict(
            jax_tm.build_cfg(jargs))
        jgame, jmodel = jax_tm.build_game_and_model(jargs)
        game, model = tm.build_game_and_model(pargs)
        assert type(game).__name__ == type(jgame).__name__
        assert type(model).__name__ == type(jmodel).__name__
        if pargs.net == "mlp":
            assert model.hidden == tuple(jmodel.hidden)
        else:
            assert (len(model.blocks), model.stem.out_channels) == (jmodel.blocks, jmodel.channels)


def test_one_process_drives_one_device():
    with pytest.raises(SystemExit):
        tm.parse_args(UNUSED + ["--host-devices", "4"])
    assert tm.parse_args(UNUSED + ["--host-devices", "1"]).host_devices == 1
    # only gloo runs on the CPU; the backend is never switched
    from alphazero_tpu_torch.parallel.distributed import initialize

    with pytest.raises(ValueError, match="only gloo runs on the CPU"):
        initialize("localhost:1", 1, 0, platform="cpu", backend="nccl")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            initialize("localhost:1", 1, 0, backend="gloo")


def test_world_of_one_in_process():
    """A one-rank gloo group in this process: the collectives and the
    global-statistics BatchNorm are the identity of the mesh-less values,
    the arena over the mesh plays the mesh-less games, and a model axis
    raises for the ROADMAP item it waits on."""
    import socket

    from alphazero_tpu_torch.arena import make_arena_fn, tie_draws_from
    from alphazero_tpu_torch.config import MCTSConfig
    from alphazero_tpu_torch.games import ConnectFour
    from alphazero_tpu_torch.models import AZResNet, MLPNet, make_uniform_model
    from alphazero_tpu_torch.parallel import (
        distributed,
        make_mesh,
        param_shardings,
        primary_only,
        replicate_host_value,
        replicated,
    )

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    assert distributed.initialize(f"localhost:{port}", 1, 0, platform="cpu") == torch.device("cpu")
    try:
        mesh = make_mesh()
        assert (mesh.rank, mesh.size, mesh.shape, mesh.backend) == (0, 1, {"data": 1, "model": 1},
                                                                    "gloo")
        with pytest.raises(NotImplementedError, match="Tensor parallelism on the `model` axis"):
            make_mesh((1, 2))
        x = torch.arange(6.0).reshape(2, 3)
        assert torch.equal(distributed.all_gather(x, mesh, dim=1), x)
        assert torch.equal(distributed.all_reduce(x, mesh), x)
        assert torch.equal(distributed.broadcast(x > 2, mesh), x > 2)
        assert (distributed.host_copy({"x": x}, mesh)["x"] == x.numpy()).all()
        assert param_shardings(mesh, {"w": x}) == {"w": replicated(mesh)}
        assert torch.equal(replicate_host_value(np.arange(3), mesh), torch.arange(3))
        assert primary_only(lambda: "rank 0")() == "rank 0"

        torch.manual_seed(0)
        model = AZResNet(7, channels=8, blocks=1, dtype=torch.float32)
        feats = torch.rand(6, 6, 7, 2)
        outs = []
        for m in (None, mesh):
            probe = feats.clone().requires_grad_(True)
            logits, v = model(probe, train=True, bn_mesh=m)
            (logits.square().sum() + v.sum()).backward()
            outs.append((logits.detach(), v.detach(), probe.grad))
        for a, b in zip(*outs):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)

        game = ConnectFour()
        torch.manual_seed(1)
        mlp, uni = MLPNet(7, hidden=(16,)), make_uniform_model(game)
        results = [make_arena_fn(game, MCTSConfig(num_sims=4, max_depth=16), 4, device="cpu",
                                 mesh=m)(mlp, uni, tie_draws_from(
                                     torch.Generator().manual_seed(2), 4, 7, "cpu"))
                   for m in (None, mesh)]
        assert results[0] == results[1]
    finally:
        distributed.shutdown()
