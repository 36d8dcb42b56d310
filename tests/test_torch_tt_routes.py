"""Every route of ``MCTSConfig(transposition=True)`` in the port, on the CPU:
the fixed self-play scan against JAX ``make_selfplay_fn`` under JAX's own
draws; the arena against JAX ``make_arena_fn`` on the combined forward;
playout-cap randomization's two sub-batch searches and PUCT reanalyze
replayed through the engine; a cut coach iteration whose gate arena runs on
the engine and whose anchored pass runs on PUCT; and the ``bench_tt``,
``bench_gumbel`` and ``bench_engines`` harnesses at tiny sizes, with the
JAX scripts' JSON keys (read from their source: running them would compile
their whole matches)."""

import ast
import contextlib
import dataclasses
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
from alphazero_tpu.config import SelfPlayConfig as JaxSelfPlayConfig
from alphazero_tpu.games import ConnectFour as JaxConnectFour
from alphazero_tpu.models import MLPNet as JaxMLPNet
from alphazero_tpu.models import make_uniform_model as jax_uniform
from alphazero_tpu.selfplay import make_selfplay_fn as jax_selfplay
from alphazero_tpu_torch import arena as port_arena
from alphazero_tpu_torch import bench_engines, bench_gumbel, bench_tt
from alphazero_tpu_torch import coach as port_coach
from alphazero_tpu_torch.config import MCTSConfig, ReanalyzeConfig, SelfPlayConfig
from alphazero_tpu_torch.games import ConnectFour
from alphazero_tpu_torch.mcts.tt import tt_root_fn
from alphazero_tpu_torch.models import MLPNet, convert_mlp, make_uniform_model
from alphazero_tpu_torch.models import order_free_mlp_variables
from alphazero_tpu_torch.ops import action_probs, sample_draws
from alphazero_tpu_torch.reanalyze import make_reanalyze_fn, position_init, position_insert
from alphazero_tpu_torch.selfplay import make_selfplay_fn
from tests.torch_parity import arena_both, jax_scan_draws, outer_cfg, port_az_config, random_boards

JG, G = JaxConnectFour(), ConnectFour()
A = G.num_actions
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_fixed_scan_matches_jax():
    """B=8, 20 sims, 12 moves, Dirichlet 1.0: moves (the features), values,
    masks and stats bit-equal under the JAX scan's own draws, the policy
    targets within 1e-6."""
    jm = JaxMCTSConfig(num_sims=20, max_depth=48, dirichlet_alpha=1.0, transposition=True)
    js = JaxSelfPlayConfig(batch_size=8, temp_threshold=6, max_moves=12)
    key = jax.random.key(21)
    j_traj, j_stats = jax.jit(jax_selfplay(JG, jax_uniform(JG).apply_fn, jm, js))({}, key)
    draws = jax_scan_draws(key, 12, 8, A, 1.0)
    play = make_selfplay_fn(G, MCTSConfig(**dataclasses.asdict(jm)),
                            SelfPlayConfig(**dataclasses.asdict(js)), device="cpu")
    t_traj, t_stats = play(make_uniform_model(G), lambda t: draws[t])
    for jt, pt in ((j_traj, t_traj), (j_stats, t_stats)):
        for name, j, p in zip(jt._fields, jt, pt):
            if name == "pi":
                # counts^(1 / temp) over their sum: XLA sums the 7 terms in
                # another order, so a target may differ in the last bit
                np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(np.asarray(j), p.numpy(), err_msg=name)
    assert t_stats.done.any() and (t_traj.value[t_traj.valid] != 0).any()


def test_arena_matches_jax():
    """An order-free MLPNet (32,) against the uniform model, 8 games at 15
    sims: both seats search the combined forward on the engine."""
    variables = order_free_mlp_variables(A, (32,), seed=1)
    jnet = JaxMLPNet(num_actions=A, hidden=(32,))
    jparams = jax.tree_util.tree_map(jnp.asarray, variables)
    want, got = arena_both(JG, G, lambda p, f: jnet.apply(p, f), jax_uniform(JG).apply_fn,
                           convert_mlp(variables), make_uniform_model(G), 8, seed=6,
                           jax_params=(jparams, {}), num_sims=15, max_depth=48,
                           transposition=True)
    assert got == want
    assert got.cand_wins + got.inc_wins + got.draws == 8


def test_pcr_sub_batches_ride_the_engine():
    """Playout-cap randomization (p = 0.25): each step's full and cheap
    sub-batch searches are the engine's, the cheap one without noise at the
    cheap budget, the cheap moves' targets zero."""
    cfg = MCTSConfig(num_sims=12, max_depth=48, dirichlet_alpha=1.0, transposition=True)
    sp = SelfPlayConfig(batch_size=8, temp_threshold=6, max_moves=4, full_search_prob=0.25,
                        cheap_sims=4)
    gen = torch.Generator().manual_seed(3)
    draws = [sample_draws(gen, 8, A, 1.0, "cpu", permute=True) for _ in range(4)]
    model = make_uniform_model(G)
    traj, _ = make_selfplay_fn(G, cfg, sp, device="cpu")(model, lambda t: draws[t])
    full = tt_root_fn(G, model.apply_fn, cfg)
    cheap = tt_root_fn(G, model.apply_fn, dataclasses.replace(cfg, num_sims=4,
                                                               dirichlet_alpha=None))
    state = G.init(8, "cpu")
    for t, d in enumerate(draws):
        inv = torch.argsort(d.perm)
        sub = state[d.perm]
        counts = torch.cat([full(sub[:2], d.dirichlet[:2]), cheap(sub[2:])])[inv]
        assert (counts.sum(1) == torch.where(inv < 2, 12.0, 4.0)).all()
        pi = action_probs(counts, 1.0, d.tie)
        assert torch.equal(traj.pi[t], torch.where((inv < 2)[:, None], pi, 0.0))
        state = G.step(state, (torch.log(pi + 1e-12) + d.gumbel).argmax(dim=-1))


def test_puct_reanalyze_rides_the_engine():
    """A reanalyze pass re-searches stored positions noise-free on the
    engine at the pass's budget; the targets are its normalised counts."""
    cfg = MCTSConfig(num_sims=8, max_depth=48, dirichlet_alpha=1.0, transposition=True)
    rz = ReanalyzeConfig(batch_size=6, capacity=16, num_sims=30)
    boards = torch.as_tensor(random_boards(6, 9, seed=4))
    store = position_insert(position_init(G, 16, "cpu"), boards[None], torch.ones(1, 6),
                            torch.ones(1, 6, dtype=torch.bool))
    model = make_uniform_model(G)
    idx = torch.arange(6)
    traj, num, _ = make_reanalyze_fn(G, cfg, rz)(model, store, idx)
    counts = tt_root_fn(G, model.apply_fn, dataclasses.replace(
        cfg, num_sims=30, dirichlet_alpha=None))(store.states[idx])
    assert num == 6
    assert torch.equal(traj.pi[0], counts / counts.sum(-1, keepdim=True).clamp(min=1.0))


def test_coach_gates_on_the_engine_and_anchors_on_puct(monkeypatch):
    """A cut coach iteration with ``transposition=True``: the gate arena
    searches on the engine, the anchored pass (the anchor and the pool
    matches) on exact PUCT without it, as the JAX coach builds them."""
    played = []
    calls = {"tt": 0}
    real_make, real_tt = port_arena.make_arena_fn, port_arena.tt_root_fn

    def counting_tt(*args, **kw):
        calls["tt"] += 1
        return real_tt(*args, **kw)

    def spying_make(game, cfg, num_games, *args, **kw):
        play = real_make(game, cfg, num_games, *args, **kw)

        def wrapped(*a):
            before = calls["tt"]
            out = play(*a)
            played.append((cfg.transposition, calls["tt"] - before))
            return out

        return wrapped

    monkeypatch.setattr(port_arena, "tt_root_fn", counting_tt)
    monkeypatch.setattr(port_coach, "make_arena_fn", spying_make)
    jcfg = outer_cfg()
    jcfg = dataclasses.replace(jcfg, mcts=dataclasses.replace(jcfg.mcts, transposition=True))
    torch.manual_seed(0)
    coach = port_coach.Coach(G, MLPNet(A, hidden=(16,)), port_az_config(jcfg), device="cpu")
    record = coach.run_iteration()
    assert "anchored_elo" in record and np.isfinite(record["loss_last"])
    gate = [n for tt, n in played if tt]
    anchored = [n for tt, n in played if not tt]
    assert gate and all(n > 0 for n in gate)
    assert anchored and all(n == 0 for n in anchored)


def _jax_bench_keys(script: str) -> set:
    """The keys of the JSON line the JAX script prints: its ``out = {...}``
    and ``out.update({...})`` literals, or ``emit``'s for
    ``bench_engines.py``."""
    with open(os.path.join(REPO, script)) as f:
        tree = ast.parse(f.read())
    keys = set()
    for node in ast.walk(tree):
        dicts = []
        targets = [getattr(t, "id", None) for t in getattr(node, "targets", ())]
        if isinstance(node, ast.Assign) and targets == ["out"]:
            dicts = [node.value]
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if getattr(node.func.value, "id", None) == "out" and node.func.attr == "update":
                dicts = node.args
        elif isinstance(node, ast.FunctionDef) and node.name == "emit":
            dicts = [d for d in ast.walk(node) if isinstance(d, ast.Dict)]
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "emit":
            keys |= {k.arg for k in node.keywords}
        for d in dicts:
            keys |= {k.value for k in d.keys if isinstance(k, ast.Constant)}
    return keys


def _run_main(main, argv) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return [json.loads(ln) for ln in buf.getvalue().splitlines()]


@pytest.mark.parametrize("name", ["bench_tt", "bench_gumbel", "bench_engines"])
def test_bench_harness_smoke(name, monkeypatch):
    if name == "bench_engines":
        monkeypatch.setenv("AZ_BENCH_ONLY", "c4_")
        lines = _run_main(bench_engines.main, ["--cpu", "--sims", "4", "--batch", "4"])
        assert [(ln["bench"], ln["engine"]) for ln in lines] == [
            ("c4_uniform_B4096_100sims", "fused"), ("c4_uniform_B4096_100sims", "hybrid"),
            ("c4_uniform_B4096_100sims", "dense"), ("c4_mlp_B4096_100sims", "fused"),
            ("c4_mlp_B4096_100sims", "hybrid"), ("c4_mlp_B4096_100sims", "dense"),
            ("c4_resnet_B4096_100sims", "hybrid"), ("c4_resnet_B4096_100sims", "dense")]
        for ln in lines:
            assert set(ln) == _jax_bench_keys("bench_engines.py") and ln["move_ms"] > 0
        return
    main = {"bench_tt": bench_tt.main, "bench_gumbel": bench_gumbel.main}[name]
    (out,) = _run_main(main, ["--cpu", "--games", "6", "--sims", "6", "--batch", "4",
                              "--seeds", "1", "--max-depth", "16"])
    assert set(out) == _jax_bench_keys(f"{name}.py")
    side = "tt" if name == "bench_tt" else "gumbel"
    other = "pure" if name == "bench_tt" else "puct"
    assert out[f"{side}_wins"] + out[f"{other}_wins"] + out["draws"] == out["games"] == 6
    assert out["selfplay_batch"] == 4 and out[f"{side}_cost_x"] > 0
