"""One rank of tests/test_torch_parallel.py's two-rank gloo group.

Launched by ``parallel.distributed.launch_local_multihost`` with the
launcher's flags and ``--inputs`` (a ``torch.save`` of every case's
inputs, made by the test process: JAX's draws, weights, batches and
configs) and ``--out`` (a directory). It runs every case on the mesh,
writes its outputs to ``{out}/rank{r}.pt`` and, on rank 0, prints one
JSON record. It imports torch and the port only.
"""

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from alphazero_tpu_torch.arena import make_arena_fn  # noqa: E402
from alphazero_tpu_torch.coach import Coach  # noqa: E402
from alphazero_tpu_torch.config import TrainConfig  # noqa: E402
from alphazero_tpu_torch.games import ConnectFour  # noqa: E402
from alphazero_tpu_torch.models import MLPNet, make_uniform_model  # noqa: E402
from alphazero_tpu_torch.parallel import distributed, make_mesh, shard_batch  # noqa: E402
from alphazero_tpu_torch.selfplay import (  # noqa: E402
    make_recycling_selfplay_fn,
    make_selfplay_fn,
)
from alphazero_tpu_torch.train import init_train_state, make_train_step  # noqa: E402

G = ConnectFour()


def scans(mesh, inp) -> dict:
    """The fixed scans (PUCT with Dirichlet noise, Gumbel) and two
    recycling calls, each gathered in global game order."""
    uni = make_uniform_model(G)
    out = {}
    for name in ("scan", "gumbel"):
        case = inp[name]
        play = make_selfplay_fn(G, case["mcts"], case["sp"], device="cpu", mesh=mesh)
        traj, stats = play(uni, lambda t: case["draws"][t])
        out[name] = (distributed.host_copy(traj, mesh, dim=1), distributed.host_copy(stats, mesh))
    case = inp["recycle"]
    init, play = make_recycling_selfplay_fn(G, case["mcts"], case["sp"], device="cpu", mesh=mesh)
    carry = init()
    calls = []
    for draws in case["draws"]:
        carry, traj, stats = play(uni, carry, lambda t: draws[t])
        calls.append((distributed.host_copy(carry.state, mesh),
                      distributed.host_copy(carry.move_count, mesh),
                      distributed.host_copy(carry.frag_features, mesh, dim=1),
                      distributed.host_copy(carry.frag_pi, mesh, dim=1),
                      distributed.host_copy(traj, mesh, dim=1),
                      distributed.host_copy(stats, mesh)))
    out["recycle"] = calls
    return out


def train_steps(mesh, inp) -> dict:
    """One data-parallel step of each model from the given weights on the
    rank's rows of the given batch: the metrics and this rank's state."""
    out = {}
    for kind, case in inp["train"].items():
        model = case["model"]
        state = init_train_state(model, TrainConfig())
        step = make_train_step(TrainConfig(), mesh)
        feats, pi, v = shard_batch(mesh, case["batch"])
        state, metrics = step(state, feats, pi, v)
        out[kind] = ([float(m) for m in metrics],
                     {k: t.clone() for k, t in model.state_dict().items()})
    return out


def learners(mesh, inp) -> dict:
    """Many data-parallel steps of one MLPNet whose hidden layers compute
    in f32 and in bf16: each step's loss and the final parameters."""
    out = {}
    case = inp["learner"]
    for name, model in case["models"].items():
        state = init_train_state(model, TrainConfig())
        step = make_train_step(TrainConfig(), mesh)
        losses = []
        for batch in case["batches"]:
            state, metrics = step(state, *shard_batch(mesh, batch))
            losses.append(float(metrics.loss))
        out[name] = (losses, {k: t.clone() for k, t in model.state_dict().items()})
    return out


def arenas(mesh, inp) -> dict:
    """A gate arena (an MLPNet against the uniform model) and an
    asymmetric-budget rung, the games split over the ranks."""
    case = inp["arena"]
    model = MLPNet(7, hidden=case["hidden"])
    model.load_state_dict(case["weights"])
    uni = make_uniform_model(G)
    out = {}
    for name, (cfg, cfg_inc, cand) in case["runs"].items():
        play = make_arena_fn(G, cfg, case["games"], mcts_cfg_inc=cfg_inc, device="cpu", mesh=mesh)
        out[name] = tuple(play(model if cand else uni, uni, lambda t: case["ties"][t]))
    return out


def coaches(mesh, inp) -> dict:
    """A coach iteration with the anchored pass; a recycling coach that
    checkpoints after its first iteration and that a coach on a new
    process group resumes for its second."""
    out = {}
    case = inp["coach"]
    model = MLPNet(7, hidden=case["hidden"])
    model.load_state_dict(case["weights"])
    coach = Coach(G, model, case["cfg"], mesh=mesh)
    out["anchored"] = [coach.run_iteration() for _ in range(case["iterations"])]
    out["anchored_pool"] = [g for g, _ in coach.pool]
    out["anchored_matches"] = [dict(m) for m in coach.pool_matches]

    case = inp["resume"]
    cfg = case["cfg"]
    model = MLPNet(7, hidden=case["hidden"])
    model.load_state_dict(case["weights"])
    first = Coach(G, model, cfg, mesh=mesh)
    records = first.learn(1)
    import torch.distributed as dist

    mesh2 = make_mesh(group=dist.new_group([0, 1]))
    model2 = MLPNet(7, hidden=case["hidden"])
    model2.load_state_dict(case["weights"])
    second = Coach(G, model2, cfg, mesh=mesh2)
    out["resumed_at"] = second.iteration
    out["resumed_carry_equal"] = all(
        torch.equal(a, b) for a, b in zip(first.actor_carry, second.actor_carry))
    records += second.learn(1)
    out["resume"] = records
    out["files"] = sorted(os.listdir(cfg.checkpoint_dir))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    for flag in ("--coordinator", "--platform", "--backend", "--inputs", "--out"):
        ap.add_argument(flag)
    ap.add_argument("--num-processes", type=int)
    ap.add_argument("--process-id", type=int)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    distributed.initialize(args.coordinator, args.num_processes, args.process_id,
                           platform=args.platform, backend=args.backend)
    try:
        mesh = make_mesh()
        inp = torch.load(args.inputs, weights_only=False)
        out = {"rank": mesh.rank, "size": mesh.size}
        out.update(scans(mesh, inp))
        out["train"] = train_steps(mesh, inp)
        out["learner"] = learners(mesh, inp)
        out["arena"] = arenas(mesh, inp)
        out.update(coaches(mesh, inp))
        torch.save(out, os.path.join(args.out, f"rank{mesh.rank}.pt"))
        distributed.barrier(mesh)
        if mesh.rank == 0:
            print(json.dumps({"out": args.out, "ranks": mesh.size}), flush=True)
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
