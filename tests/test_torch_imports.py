"""The port stands alone: it imports with ``jax`` (and the JAX package)
unavailable, reaches no compiler or library kernel in place of its own,
and its configs are the JAX package's, field for field."""

import dataclasses
import pathlib
import subprocess
import sys

import pytest

from alphazero_tpu import config as jax_config
from alphazero_tpu_torch import config as port_config

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "alphazero_tpu_torch"

_BLOCK = "import sys\nfor m in {mods!r}:\n    sys.modules[m] = None\n"


def _port_sources():
    """The port's Python files (``csrc/`` holds CUDA sources and builds)."""
    return sorted(f for f in PORT.rglob("*.py") if "csrc" not in f.relative_to(PORT).parts)


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )


def test_port_imports_without_jax_or_the_jax_package():
    modules = sorted(
        "alphazero_tpu_torch" + "".join("." + p for p in f.relative_to(PORT).with_suffix("").parts)
        for f in _port_sources()
    )
    modules = [m.removesuffix(".__init__") for m in modules]
    code = _BLOCK.format(mods=["jax", "jaxlib", "flax", "optax", "orbax", "alphazero_tpu"]) + (
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'alphazero_tpu') "
        "and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('alphazero_tpu_torch')]))\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 10


def test_chip_smoke_refuses_without_a_card():
    """No CUDA device: non-zero exit and no result line (and the script
    itself needs neither JAX nor the JAX package to get there)."""
    code = _BLOCK.format(mods=["jax", "jaxlib", "flax", "alphazero_tpu"]) + (
        "import runpy\nrunpy.run_path('chip_smoke.py', run_name='__main__')\n"
    )
    proc = _run(code)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_jax_package_config_is_jax_free():
    """The JAX package's config imports only the standard library."""
    proc = _run(_BLOCK.format(mods=["jax", "jaxlib", "flax"]) + "import alphazero_tpu.config\n")
    assert proc.returncode == 0, proc.stderr


def test_config_mirrors_the_jax_package():
    jf = {f.name: f.default for f in dataclasses.fields(jax_config.MCTSConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(port_config.MCTSConfig)}
    assert jf == pf
    assert port_config.PUCT_EPS == jax_config.PUCT_EPS
    for kw in ({}, {"num_sims": 7}, {"num_sims": 7, "max_nodes": 3}):
        assert port_config.MCTSConfig(**kw).nodes == jax_config.MCTSConfig(**kw).nodes


@pytest.mark.parametrize("name", ["SelfPlayConfig", "ReplayConfig", "TrainConfig"])
def test_loop_configs_mirror_the_jax_package(name):
    """Field for field: names, order, defaults and annotations."""
    jax_cls, port_cls = getattr(jax_config, name), getattr(port_config, name)
    jf = [(f.name, f.default, str(f.type)) for f in dataclasses.fields(jax_cls)]
    pf = [(f.name, f.default, str(f.type)) for f in dataclasses.fields(port_cls)]
    assert jf == pf
    assert dataclasses.asdict(port_cls()) == dataclasses.asdict(jax_cls())


@pytest.mark.parametrize("name", ["ArenaConfig", "ReanalyzeConfig"])
def test_arena_configs_mirror_the_jax_package(name):
    """Field for field: names, order, defaults and annotations."""
    jax_cls, port_cls = getattr(jax_config, name), getattr(port_config, name)
    jf = [(f.name, f.default, str(f.type)) for f in dataclasses.fields(jax_cls)]
    pf = [(f.name, f.default, str(f.type)) for f in dataclasses.fields(port_cls)]
    assert jf == pf
    assert dataclasses.asdict(port_cls()) == dataclasses.asdict(jax_cls())


def test_run_config_mirrors_the_jax_package():
    """``AZConfig``: the same fields in order, the same annotations, the
    same defaults (each sub-config the port's own copy of the JAX one)."""
    def fields(cls):
        out = []
        for f in dataclasses.fields(cls):
            default = f.default
            if default is dataclasses.MISSING:
                default = dataclasses.asdict(f.default_factory())
            out.append((f.name, default, str(f.type)))
        return out

    assert fields(port_config.AZConfig) == fields(jax_config.AZConfig)
    assert dataclasses.asdict(port_config.AZConfig()) == dataclasses.asdict(jax_config.AZConfig())
    for f in dataclasses.fields(port_config.AZConfig):
        if f.default is dataclasses.MISSING:
            assert type(f.default_factory()).__module__ == "alphazero_tpu_torch.config"


def test_the_scan_covers_the_outer_loop():
    """The import scan above reaches the arena, the checkpoints, the coach,
    the utilities and the training CLI."""
    names = {f.relative_to(PORT).as_posix() for f in _port_sources()}
    for want in ("arena.py", "checkpoint.py", "coach.py", "utils/elo.py", "utils/logging.py",
                 "utils/timing.py", "examples/train_connect_four.py"):
        assert want in names


def test_the_scan_covers_the_dense_engine_and_its_clis():
    """The dense engine and the CLIs that search with it are in the scan,
    and running them (their imports inside ``main`` too) needs neither
    JAX nor the JAX package."""
    names = {f.relative_to(PORT).as_posix() for f in _port_sources()}
    clis = ("analyze", "play_connect_four", "play_othello", "play_gomoku", "play_hex")
    for want in ("mcts/tree.py", "mcts/search.py", "examples/boardio.py", "examples/play.py",
                 *(f"examples/{cli}.py" for cli in clis)):
        assert want in names
    code = _BLOCK.format(mods=["jax", "jaxlib", "flax", "optax", "orbax", "alphazero_tpu"]) + (
        "import importlib, io\n"
        f"for cli in {clis!r}:\n"
        "    sys.stdin = io.StringIO('')\n"
        "    main = importlib.import_module('alphazero_tpu_torch.examples.' + cli).main\n"
        "    assert main(['--cpu', '--sims', '2'] + (['--human-first'] if cli != 'analyze' "
        "else [])) == 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'alphazero_tpu') "
        "and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("bye") == 4 and "search best move" in proc.stdout


def test_the_scan_covers_the_training_economy():
    """Gumbel search, playout-cap randomization's draws, reanalyze and the
    CLI options that reach them are in the scan, and a Gumbel search, a
    reanalyze pass and ``analyze --engine gumbel`` run with neither JAX nor
    the JAX package importable."""
    names = {f.relative_to(PORT).as_posix() for f in _port_sources()}
    for want in ("mcts/gumbel.py", "reanalyze.py", "ops/policy.py", "examples/cli.py"):
        assert want in names
    code = _BLOCK.format(mods=["jax", "jaxlib", "flax", "optax", "orbax", "alphazero_tpu"]) + (
        "import torch\n"
        "from alphazero_tpu_torch.config import MCTSConfig, ReanalyzeConfig\n"
        "from alphazero_tpu_torch.examples import analyze\n"
        "from alphazero_tpu_torch.games import ConnectFour\n"
        "from alphazero_tpu_torch.mcts import make_gumbel_search_fn\n"
        "from alphazero_tpu_torch.models import make_uniform_model\n"
        "from alphazero_tpu_torch.ops import sample_draws\n"
        "from alphazero_tpu_torch.reanalyze import make_reanalyze_fn, position_init, "
        "position_insert\n"
        "g, cfg = ConnectFour(), MCTSConfig(num_sims=4, gumbel=True)\n"
        "m = make_uniform_model(g)\n"
        "d = sample_draws(torch.Generator().manual_seed(0), 2, 7, None, 'cpu', permute=True)\n"
        "res = make_gumbel_search_fn(g, m.apply_fn, cfg)(g.init(2, 'cpu'), d.gumbel)\n"
        "assert res.tree.root_counts().sum().item() == 8 and sorted(d.perm.tolist()) == [0, 1]\n"
        "store = position_insert(position_init(g, 4, 'cpu'), g.init(2, 'cpu')[None], "
        "torch.ones(1, 2), torch.ones(1, 2, dtype=torch.bool))\n"
        "rz = make_reanalyze_fn(g, cfg, ReanalyzeConfig(batch_size=2, capacity=4))\n"
        "assert rz(m, store, torch.zeros(2, dtype=torch.long), d.gumbel)[1] == 2\n"
        "assert analyze.main(['--cpu', '--engine', 'gumbel', '--sims', '4']) == 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'alphazero_tpu') "
        "and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "gumbel recommendation (eval mode)" in proc.stdout


def test_only_the_transposition_engine_still_raises():
    """The transposition engine (``mcts/tt.py``) is ported: no raise in the
    port cites "The opt-in engines" any more (the self-play ladder, the
    arena and ``analyze --engine tt`` once did), and the engine's module
    imports with the rest."""
    hits = [f.relative_to(PORT).as_posix() for f in _port_sources()
            if "The opt-in engines" in f.read_text()]
    assert hits == []
    assert (PORT / "mcts" / "tt.py") in _port_sources()


@pytest.mark.parametrize("needle", ["torch.compile", "import triton", "cpp_extension"])
def test_no_compiler_or_library_kernel_stands_in(needle):
    """The hybrid kernels are hand-written CUDA built with nvcc; nothing in
    the port routes them through torch.compile or cpp_extension."""
    hits = [str(f) for f in _port_sources() if needle in f.read_text()]
    assert not hits, hits


def test_the_scan_covers_the_data_parallel_path():
    """The mesh, the collectives, the multi-process CLI and the scaling
    harness are in the import scan, and no raise in the port cites the
    ROADMAP item "`parallel/` → `torch.distributed`" any more (the coach
    and the arena once did)."""
    names = {f.relative_to(PORT).as_posix() for f in _port_sources()}
    for want in ("parallel/__init__.py", "parallel/mesh.py", "parallel/distributed.py",
                 "examples/train_multihost.py", "bench_scaling.py"):
        assert want in names
    hits = [f.relative_to(PORT).as_posix() for f in _port_sources()
            if "`parallel/` → `torch.distributed`" in f.read_text()]
    assert hits == []


def test_the_scan_covers_the_archive_and_the_trace():
    """The host example store and ``profiler_trace`` are in the import scan
    (so neither needs JAX or the JAX package); no raise or docstring cites
    their ROADMAP items, nor "Gomoku boards above 512 cells", any more; the
    refusals that remain cite their items by name: Gomoku boards above 768
    cells (the descend route, the Gomoku CLI, the hybrid engine's
    docstring) and round kernels for K above 16."""
    names = {f.relative_to(PORT).as_posix() for f in _port_sources()}
    assert {"native.py", "utils/timing.py"} <= names
    for gone in ("The host example archive", "Tracing: `profiler_trace`",
                 "Gomoku boards above 512 cells"):
        hits = [f.relative_to(PORT).as_posix() for f in _port_sources() if gone in f.read_text()]
        assert hits == [], gone
    for item, where in (("Gomoku boards above 768 cells",
                         ["examples/train_gomoku.py", "kernels.py", "mcts/hybrid.py"]),
                        ("Round kernels for K above 16", ["kernels.py"])):
        hits = sorted(f.relative_to(PORT).as_posix() for f in _port_sources() if item in f.read_text())
        assert hits == where, item
