"""The port's data-parallel path (``alphazero_tpu_torch.parallel``) on two
gloo ranks on the CPU, against the JAX package's sharded functions and
against the port's one-process run.

Two ranks are spawned once for the whole file (``ranks``: the worker
tests/torch_parallel_worker.py runs every case and saves each rank's
outputs), while the JAX references compile in this process on conftest's
8 virtual devices. Checked:

* the sharded fixed scan (PUCT with Dirichlet noise, and Gumbel) and two
  recycling calls, on Connect-Four with the uniform model (B=16, 8 sims),
  gathered in game order: bit-equal to JAX's ``make_selfplay_fn`` /
  ``make_recycling_selfplay_fn`` with ``mesh=make_mesh()`` under JAX's own
  draws (``torch_parity.jax_scan_draws``);
* playout-cap randomization's sub-batch check, word for word as JAX's;
* one data-parallel train step of an f32 MLPNet (32,) and of an f32
  AZResNet (8 channels, 1 block: BatchNorm over the global batch) against
  JAX's ``make_train_step`` on the sharded batch: the loss within rtol
  1e-6, the parameters within rtol 2e-5 / atol 1e-6
  (tests/test_parallel.py's tolerances), the same on both ranks;
* 16 data-parallel steps of an MLPNet (32, 32) against the port's
  one-process steps: with f32 hidden layers every step's loss within
  1e-5; with bf16 ones the first (the forward over each rank's rows is
  the whole batch's), while the later steps drift, because each rank's
  weight gradient through the bf16 cast is rounded to bf16 before the
  ranks' sum (``test_bf16_weight_gradients_round_per_shard``);
* the sharded arena (a gate and an asymmetric-budget rung) and two coach
  runs (the anchored pass with its pool; recycling with a checkpoint that
  rank 0 writes and a coach on a new process group resumes) against the
  port's one-process run: the integers exactly, the losses within 1e-5.
"""

import concurrent.futures
import copy
import dataclasses
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
from alphazero_tpu.config import SelfPlayConfig as JaxSelfPlayConfig
from alphazero_tpu.config import TrainConfig as JaxTrainConfig
from alphazero_tpu.games import ConnectFour as JaxConnectFour
from alphazero_tpu.models import AZResNet as JaxAZResNet
from alphazero_tpu.models import MLPNet as JaxMLPNet
from alphazero_tpu.models import make_uniform_model as jax_uniform
from alphazero_tpu.parallel import batch_sharding as jax_batch_sharding
from alphazero_tpu.parallel import make_mesh as jax_make_mesh
from alphazero_tpu.selfplay import make_recycling_selfplay_fn as jax_recycling
from alphazero_tpu.selfplay import make_selfplay_fn as jax_selfplay
from alphazero_tpu.train import TrainState as JaxTrainState
from alphazero_tpu.train import make_optimizer as jax_make_optimizer
from alphazero_tpu.train import make_train_step as jax_make_train_step
from alphazero_tpu_torch.arena import make_arena_fn
from alphazero_tpu_torch.coach import Coach
from alphazero_tpu_torch.config import ArenaConfig, MCTSConfig, SelfPlayConfig, TrainConfig
from alphazero_tpu_torch.games import ConnectFour
from alphazero_tpu_torch.models import (
    MLPNet,
    convert_az_resnet,
    convert_mlp,
    make_uniform_model,
    random_az_resnet_variables,
    random_mlp_variables,
)
from alphazero_tpu_torch.models.convert import az_resnet_state_dict, mlp_state_dict
from alphazero_tpu_torch.parallel import Mesh
from alphazero_tpu_torch.parallel.distributed import launch_local_multihost
from alphazero_tpu_torch.selfplay import make_selfplay_fn
from alphazero_tpu_torch.train import init_train_state, make_train_step
from tests.torch_parity import (
    jax_gumbel_scan_draws,
    jax_scan_draws,
    outer_cfg,
    port_az_config,
    random_boards,
)

WORKER = str(Path(__file__).with_name("torch_parallel_worker.py"))
JG, G = JaxConnectFour(), ConnectFour()
A, B, T = 7, 16, 42
TRAIN_ROWS = 64
LEARNER_STEPS = 16
JM = JaxMCTSConfig(num_sims=8, max_depth=16, dirichlet_alpha=1.0)
JM_GUMBEL = JaxMCTSConfig(num_sims=8, max_depth=16, gumbel=True)
JS = JaxSelfPlayConfig(batch_size=B, temp_threshold=6)
JS_RECYCLE = JaxSelfPlayConfig(batch_size=B, temp_threshold=6, recycle=True)
RECYCLE_KEYS = (41, 42)
COACH_KEYS = ("iteration", "model_id", "accepted", "arena_wins", "arena_losses", "arena_draws",
              "replay_size", "replay_total", "selfplay_moves", "selfplay_truncated")


def _port(cfg, cls):
    return cls(**dataclasses.asdict(cfg))


def _train_case(kind: str):
    """``(flax module, flax variables, port f32 model, (feats, pi, v))``."""
    if kind == "resnet":
        variables = random_az_resnet_variables(A, 8, 1, seed=5)
        jm = JaxAZResNet(num_actions=A, channels=8, blocks=1, dtype=jnp.float32)
        model = convert_az_resnet(variables, dtype=torch.float32)
    else:
        variables = random_mlp_variables(A, (32,), seed=5)
        jm = JaxMLPNet(num_actions=A, hidden=(32,), dtype=jnp.float32)
        model = convert_mlp(variables, torch.float32)
    rng = np.random.default_rng(6)
    feats = G.to_features(torch.as_tensor(random_boards(TRAIN_ROWS, 12, seed=6))).numpy()
    pi = rng.dirichlet(np.ones(A), TRAIN_ROWS).astype(np.float32)
    pi[[3, 40]] = 0.0   # value-only rows, one on each rank
    v = rng.choice(np.array([-1.0, 0.0, 1.0], np.float32), TRAIN_ROWS)
    return jm, variables, model, (feats, pi, v)


def _learner_case() -> dict:
    """An MLPNet (32, 32) in f32 and in bf16 from one set of weights, and
    LEARNER_STEPS global batches of TRAIN_ROWS rows."""
    variables = random_mlp_variables(A, (32, 32), seed=7)
    rng = np.random.default_rng(8)
    batches = []
    for s in range(LEARNER_STEPS):
        feats = G.to_features(torch.as_tensor(random_boards(TRAIN_ROWS, 10, seed=100 + s)))
        pi = torch.as_tensor(rng.dirichlet(np.ones(A), TRAIN_ROWS).astype(np.float32))
        v = torch.as_tensor(rng.choice(np.array([-1.0, 0.0, 1.0], np.float32), TRAIN_ROWS))
        batches.append((feats, pi, v))
    return {"models": {"f32": convert_mlp(variables, torch.float32),
                       "bf16": convert_mlp(variables, torch.bfloat16)},
            "batches": batches}


def _coach_cases(tmp: Path) -> dict:
    """The two coach runs: ``outer_cfg``'s anchored pass at B=4 and 4
    arena games; recycling at B=4 with a checkpoint directory."""
    torch.manual_seed(3)
    weights = MLPNet(A, hidden=(16,)).state_dict()
    anchored = port_az_config(outer_cfg(num_games=4))
    anchored = dataclasses.replace(anchored, selfplay=dataclasses.replace(
        anchored.selfplay, batch_size=4))
    recycle = dataclasses.replace(
        anchored, arena=ArenaConfig(num_games=4, update_threshold=0.5, num_sims=2),
        selfplay=SelfPlayConfig(batch_size=4, temp_threshold=6, recycle=True),
        checkpoint_dir=str(tmp / "ranks_ckpt"))
    return {"coach": {"cfg": anchored, "hidden": (16,), "weights": weights, "iterations": 2},
            "resume": {"cfg": recycle, "hidden": (16,), "weights": weights}}


def _inputs(tmp: Path) -> dict:
    mcts, gum = _port(JM, MCTSConfig), _port(JM_GUMBEL, MCTSConfig)
    inp = {
        "scan": {"mcts": mcts, "sp": _port(JS, SelfPlayConfig),
                 "draws": jax_scan_draws(jax.random.key(31), T, B, A, 1.0)},
        "gumbel": {"mcts": gum, "sp": _port(JS, SelfPlayConfig),
                   "draws": jax_gumbel_scan_draws(jax.random.key(32), T, B, A)},
        "recycle": {"mcts": mcts, "sp": _port(JS_RECYCLE, SelfPlayConfig),
                    "draws": [jax_scan_draws(jax.random.key(k), T, B, A, 1.0)
                              for k in RECYCLE_KEYS]},
        "train": {},
    }
    for kind in ("mlp", "resnet"):
        _, _, model, batch = _train_case(kind)
        inp["train"][kind] = {"model": model, "batch": tuple(torch.as_tensor(x) for x in batch)}
    torch.manual_seed(4)
    mlp = MLPNet(A, hidden=(16,))
    gen = torch.Generator().manual_seed(9)
    uni4 = MCTSConfig(num_sims=4, max_depth=16)
    inp["arena"] = {
        "hidden": (16,), "weights": mlp.state_dict(), "games": 8,
        "ties": [torch.rand((8, A), generator=gen) for _ in range(T)],
        "runs": {"gate": (MCTSConfig(num_sims=6, max_depth=16), None, True),
                 "rung": (uni4, dataclasses.replace(uni4, num_sims=12), False)},
    }
    inp["learner"] = _learner_case()
    inp.update(_coach_cases(tmp))
    return inp


def _jax_references() -> dict:
    """JAX's sharded scans, recycling calls and train steps."""
    mesh = jax_make_mesh()
    data_tb = NamedSharding(mesh, P(None, "data"))
    apply = jax_uniform(JG).apply_fn
    out = {}
    for name, jm, seed in (("scan", JM, 31), ("gumbel", JM_GUMBEL, 32)):
        sp = jax_selfplay(JG, apply, jm, JS, mesh=mesh)
        key = jax.random.key(seed)
        shapes = jax.eval_shape(sp, {}, key)
        traj, stats = jax.jit(sp, out_shardings=(
            jax.tree_util.tree_map(lambda _: data_tb, shapes[0]), None))({}, key)
        assert len(traj.pi.sharding.device_set) == 8
        out[name] = jax.device_get((traj, stats))
    init, rec = jax_recycling(JG, apply, JM, JS_RECYCLE, mesh=mesh)
    rec = jax.jit(rec)
    carry, calls = jax.jit(init)(), []
    for k in RECYCLE_KEYS:
        carry, traj, stats = rec({}, carry, jax.random.key(k))
        calls.append(jax.device_get((carry, traj, stats)))
    out["recycle"] = calls
    out["train"] = {}
    bp = jax_batch_sharding(mesh)
    for kind in ("mlp", "resnet"):
        jm, variables, _, batch = _train_case(kind)
        jcfg = JaxTrainConfig()
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        stats = jax.tree_util.tree_map(jnp.asarray, variables.get("batch_stats", {}))
        state = JaxTrainState(params, stats, jax_make_optimizer(jcfg).init(params),
                              jnp.zeros((), jnp.int32))
        state, met = jax.jit(jax_make_train_step(jm, jcfg))(
            state, *(jax.device_put(jnp.asarray(x), bp) for x in batch), jax.random.key(0))
        tree = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
        sd = az_resnet_state_dict(tree) if kind == "resnet" else mlp_state_dict(tree)
        out["train"][kind] = (float(met.loss), {k: v for k, v in sd.items()
                                                if not k.endswith("num_batches_tracked")})
    return out


def _port_references(inp: dict) -> dict:
    """The port's one-process arenas, learner steps and coach runs on the
    same inputs."""
    out = {"arena": {}, "learner": {}}
    for name, model in inp["learner"]["models"].items():
        model = copy.deepcopy(model)
        state = init_train_state(model, TrainConfig())
        step = make_train_step(TrainConfig())
        out["learner"][name] = [float(step(state, *b)[1].loss) for b in inp["learner"]["batches"]]
    uni = make_uniform_model(G)
    for name in ("scan", "gumbel"):
        case = inp[name]
        play = make_selfplay_fn(G, case["mcts"], case["sp"], device="cpu")
        out[name] = play(uni, lambda t: case["draws"][t])
    case = inp["arena"]
    mlp = MLPNet(A, hidden=case["hidden"])
    mlp.load_state_dict(case["weights"])
    uni = make_uniform_model(G)
    for name, (cfg, cfg_inc, cand) in case["runs"].items():
        play = make_arena_fn(G, cfg, case["games"], mcts_cfg_inc=cfg_inc, device="cpu")
        out["arena"][name] = tuple(play(mlp if cand else uni, uni, lambda t: case["ties"][t]))
    for name in ("coach", "resume"):
        case = inp[name]
        model = MLPNet(A, hidden=case["hidden"])
        model.load_state_dict(case["weights"])
        coach = Coach(G, model, dataclasses.replace(case["cfg"], checkpoint_dir=None),
                      device="cpu")
        out[name] = [coach.run_iteration() for _ in range(case.get("iterations", 2))]
        out[name + "_pool"] = [g for g, _ in coach.pool]
        out[name + "_matches"] = [dict(m) for m in coach.pool_matches]
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the two ranks once, with the JAX and one-process references
    computed here meanwhile; the ranks' outputs and the references."""
    tmp = tmp_path_factory.mktemp("ranks")
    inp = _inputs(tmp)
    torch.save(inp, tmp / "inputs.pt")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spawn = pool.submit(launch_local_multihost,
                            ["--inputs", str(tmp / "inputs.pt"), "--out", str(tmp)],
                            num_processes=2, timeout=180, platform="cpu", backend="gloo",
                            entry=[WORKER])
        jax_ref = _jax_references()
        port_ref = _port_references(inp)
        records = spawn.result()
    assert records == [{"out": str(tmp), "ranks": 2}]
    outs = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return types.SimpleNamespace(rank0=outs[0], rank1=outs[1], jax=jax_ref, port=port_ref)


def _equal(jax_tuple, got, what):
    for name, j, t in zip(jax_tuple._fields, jax_tuple, got):
        if hasattr(j, "board"):
            j = j.board
        np.testing.assert_array_equal(np.asarray(j), np.asarray(t), err_msg=f"{what}.{name}")


@pytest.mark.parametrize("name", ["scan", "gumbel"])
def test_sharded_fixed_scan_is_bit_equal_to_jax(ranks, name):
    """Bit-equal to JAX's sharded scan, but Gumbel search's improved
    policy: within 1e-6 of JAX's, as unsharded (exp and log may round an
    ulp apart: tests/test_torch_gumbel_selfplay.py), and bit-equal to the
    port's one-process scan."""
    j_traj, j_stats = ranks.jax[name]
    traj, stats = ranks.rank0[name]
    if name == "gumbel":
        np.testing.assert_allclose(traj.pi, np.asarray(j_traj.pi), rtol=0, atol=1e-6)
        j_traj = j_traj._replace(pi=traj.pi)
    _equal(j_traj, traj, f"{name} traj")
    _equal(j_stats, stats, f"{name} stats")
    one_traj, one_stats = ranks.port[name]
    _equal(one_traj, traj, f"{name} traj against one process")
    _equal(one_stats, stats, f"{name} stats against one process")
    assert traj[0].shape[:2] == (T, B) and stats[2].all() and traj[3].any()
    # every rank gathers the same whole trajectory
    for a, b in zip(ranks.rank1[name][0], traj):
        np.testing.assert_array_equal(a, b)


def test_sharded_recycling_is_bit_equal_to_jax_over_two_calls(ranks):
    for i, (j_call, call) in enumerate(zip(ranks.jax["recycle"], ranks.rank0["recycle"])):
        j_carry, j_traj, j_stats = j_call
        _equal(j_carry, call[:4], f"call {i} carry")
        _equal(j_traj, call[4], f"call {i} traj")
        _equal(j_stats, call[5], f"call {i} stats")
    # the second call resolves the fragments the first carried across
    assert ranks.rank0["recycle"][1][4][3][:G.max_moves].any()


def test_pcr_sub_batches_must_divide_the_ranks_as_in_jax():
    """JAX's check, word for word, on a two-device JAX mesh and a two-rank
    port mesh (built without a process group: the check runs when the
    scan is built)."""
    mesh = Mesh(None, 0, 2, {"data": 2, "model": 1}, "gloo", torch.device("cpu"))
    jmesh = jax_make_mesh(devices=jax.devices()[:2])
    js = JaxSelfPlayConfig(batch_size=16, temp_threshold=6, full_search_prob=0.3, cheap_sims=2)
    with pytest.raises(ValueError) as want:
        jax_selfplay(JG, jax_uniform(JG).apply_fn, JM, js, mesh=jmesh)
    with pytest.raises(ValueError) as got:
        make_selfplay_fn(G, _port(JM, MCTSConfig), _port(js, SelfPlayConfig), device="cpu",
                         mesh=mesh)
    assert str(got.value) == str(want.value)
    assert "round(p*B)=5 of B=16 over 2 shards" in str(got.value)
    # a batch that does not divide the ranks is refused by name
    with pytest.raises(ValueError, match="self-play batch of 15 does not divide over the "
                                         "mesh's 2 ranks"):
        make_selfplay_fn(G, _port(JM, MCTSConfig), SelfPlayConfig(batch_size=15), device="cpu",
                         mesh=mesh)


@pytest.mark.parametrize("kind", ["mlp", "resnet"])
def test_data_parallel_train_step_matches_jax(ranks, kind):
    want_loss, want = ranks.jax["train"][kind]
    for out in (ranks.rank0, ranks.rank1):
        metrics, sd = out["train"][kind]
        np.testing.assert_allclose(metrics[0], want_loss, rtol=1e-6)
        sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
        assert sd.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), rtol=2e-5, atol=1e-6,
                                       err_msg=k)
    # identical parameters and statistics on both ranks
    sd0, sd1 = ranks.rank0["train"][kind][1], ranks.rank1["train"][kind][1]
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)
    if kind == "resnet":
        assert any("running_var" in k for k in sd0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sharded_learner_matches_one_process_over_steps(ranks, dtype):
    """f32 hidden layers: every step's loss within 1e-5 of the one-process
    learner's. bf16 ones: the first step's within 1e-6; later steps see
    the per-rank rounding of the weight gradients
    (``test_bf16_weight_gradients_round_per_shard``). Both ranks end with
    the same parameters."""
    want = ranks.port["learner"][dtype]
    got, sd0 = ranks.rank0["learner"][dtype]
    assert len(got) == len(want) == LEARNER_STEPS
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        assert abs(got[0] - want[0]) <= 1e-6, (got[0], want[0])
    assert ranks.rank1["learner"][dtype][0] == got
    sd1 = ranks.rank1["learner"][dtype][1]
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bf16_weight_gradients_round_per_shard(dtype):
    """Why a bf16 learner's sharded losses drift from the one-process ones
    (README, "Multi-GPU"): the gradient of a hidden layer's weights through
    the bf16 cast comes out of a bf16 product, rounded to bf16 on each
    rank's rows before the ranks' sum, and two rounded halves are not the
    rounded whole. In f32 the halves sum to the whole within 1e-6 of its
    largest entry; the forward is equal row for row in both."""
    model = convert_mlp(random_mlp_variables(A, (32, 32), seed=7), dtype)
    feats = G.to_features(torch.as_tensor(random_boards(TRAIN_ROWS, 10, seed=9)))

    def grads(x):
        model.zero_grad()
        logits, v = model(x, train=True)
        (logits.square().sum() + v.sum()).backward()
        return [d.weight.grad.clone() for d in model.dense_layers()]

    half = TRAIN_ROWS // 2
    whole = grads(feats)
    halves = [a + b for a, b in zip(grads(feats[:half]), grads(feats[half:]))]
    rel = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(halves, whole))
    with torch.no_grad():
        assert torch.equal(model(feats[:half])[0], model(feats)[0][:half])
    if dtype == torch.float32:
        assert rel <= 1e-6, rel
    else:
        assert rel > 1e-4, rel


def test_sharded_arena_matches_one_process(ranks):
    for name, want in ranks.port["arena"].items():
        assert ranks.rank0["arena"][name] == ranks.rank1["arena"][name] == want, name
        assert sum(want) == 8


@pytest.mark.parametrize("name", ["coach", "resume"])
def test_mesh_coach_matches_one_process(ranks, name):
    """The anchored run (two iterations: gate, anchor arenas, pool) and the
    recycling run whose second iteration is a new group's resume."""
    key = "anchored" if name == "coach" else "resume"
    want = ranks.port[name]
    for out in (ranks.rank0, ranks.rank1):
        got = out[key]
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            for k in COACH_KEYS:
                assert g[k] == w[k], (k, g[k], w[k])
            for k in ("loss_first", "loss_last"):
                assert abs(g[k] - w[k]) <= 1e-5, (k, g[k], w[k])
    if name == "coach":
        assert ranks.rank0["anchored_pool"] == ranks.port["coach_pool"]
        assert [m["b"] for m in ranks.rank0["anchored_matches"]] == \
            [m["b"] for m in ranks.port["coach_matches"]]
        assert ranks.rank0["anchored_matches"] == ranks.rank1["anchored_matches"]
        assert "anchored_elo" in ranks.rank0["anchored"][0]
    else:
        assert ranks.rank0["resumed_at"] == 1 and ranks.rank0["resumed_carry_equal"]
        assert ranks.rank1["resumed_carry_equal"]
        # rank 0 wrote each checkpoint once; every rank read it
        assert ranks.rank0["files"] == ["ckpt_000001", "ckpt_000001.json", "ckpt_000002",
                                        "ckpt_000002.json", "metrics.jsonl"]
