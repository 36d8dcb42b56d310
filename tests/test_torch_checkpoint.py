"""The port's whole-state checkpoints (``alphazero_tpu_torch.checkpoint``):
round trips, the write order, leftovers, light classification and
retention, with the JAX package's rules."""

import json
import os

import pytest
import torch

from alphazero_tpu_torch import checkpoint as ckpt


def payload(seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {
        "incumbent": {
            "model": {"w": torch.randn(3, 4, generator=g), "n": torch.tensor(7)},
            "optimizer": {"state": {0: {"step": torch.tensor(2.0)}},
                          "param_groups": [{"lr": 1e-3, "betas": (0.9, 0.999), "params": [0]}]},
            "step": 2,
        },
        "rng": g.get_state(),
        "replay": {"data": torch.randn(16, 5, generator=g), "pos": 3, "size": 9, "total": 25},
    }


def assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
    else:
        assert a == b


def test_round_trip_and_partial(tmp_path):
    p = payload()
    ckpt.save_checkpoint(str(tmp_path), 4, p, sidecar={"iteration": 4, "has_rings": True})
    out, side = ckpt.restore_checkpoint(str(tmp_path), 4, payload(seed=1))
    assert_same(out, p)
    assert side == {"iteration": 4, "has_rings": True}
    # the file reads with weights_only
    assert isinstance(torch.load(tmp_path / "ckpt_000004", weights_only=True), dict)
    # partial: a play tool's weights only
    part, _ = ckpt.restore_checkpoint(str(tmp_path), 4,
                                      {"incumbent": {"model": payload(1)["incumbent"]["model"]}},
                                      partial=True)
    assert part.keys() == {"incumbent"} and part["incumbent"].keys() == {"model"}
    assert torch.equal(part["incumbent"]["model"]["w"], p["incumbent"]["model"]["w"])


def test_template_mismatch_raises(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), 1, payload())
    light = {k: v for k, v in payload().items() if k != "replay"}
    with pytest.raises(ValueError, match="unexpected"):
        ckpt.restore_checkpoint(str(tmp_path), 1, light)          # not partial: extra subtree
    bigger = payload()
    bigger["replay"]["data"] = torch.zeros(32, 5)
    with pytest.raises(ValueError, match="template holds"):
        ckpt.restore_checkpoint(str(tmp_path), 1, bigger)
    ckpt.save_checkpoint(str(tmp_path), 2, light)
    with pytest.raises(ValueError, match="missing"):
        ckpt.restore_checkpoint(str(tmp_path), 2, payload())      # the light file has no ring


def test_sidecar_is_written_before_the_payload(tmp_path, monkeypatch):
    seen = []
    real_save = torch.save

    def spy(obj, f, *a, **kw):
        seen.append(os.path.exists(tmp_path / "ckpt_000003.json"))
        seen.append(os.path.exists(tmp_path / "ckpt_000003"))
        return real_save(obj, f, *a, **kw)

    monkeypatch.setattr(torch, "save", spy)
    ckpt.save_checkpoint(str(tmp_path), 3, payload(), sidecar={"has_rings": False})
    assert seen == [True, False]
    assert ckpt.latest_step(str(tmp_path)) == 3


def test_a_crash_leaves_nothing_latest_step_sees(tmp_path, monkeypatch):
    ckpt.save_checkpoint(str(tmp_path), 1, payload(), sidecar={"iteration": 1})

    def crash(obj, f, *a, **kw):
        f.write(b"half a payload")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", crash)
    with pytest.raises(OSError):
        ckpt.save_checkpoint(str(tmp_path), 2, payload(), sidecar={"iteration": 2})
    # a leftover from a killed process: a temporary file beside the payloads
    (tmp_path / "ckpt_000005.x1y2.tmp").write_bytes(b"partial")
    assert ckpt.latest_step(str(tmp_path)) == 1
    assert ckpt.newest_ring_step(str(tmp_path)) == 1
    assert not [n for n in os.listdir(tmp_path) if n.startswith("ckpt_000002.") and n.endswith(".tmp")]


def test_light_classification_and_exclude(tmp_path):
    d = str(tmp_path)
    assert ckpt.newest_ring_step(d) is None and ckpt.latest_step(d) is None
    ckpt.save_checkpoint(d, 1, payload(), sidecar={"has_rings": True})
    ckpt.save_checkpoint(d, 2, payload(), sidecar={"has_rings": False})
    ckpt.save_checkpoint(d, 3, payload())                        # no sidecar: ring-bearing
    assert ckpt.read_sidecar(d, 2) == {"has_rings": False}
    assert ckpt.read_sidecar(d, 3) is None
    assert ckpt.latest_step(d) == 3
    assert ckpt.newest_ring_step(d) == 3
    assert ckpt.newest_ring_step(d, exclude=3) == 1
    ckpt.save_checkpoint(d, 4, payload(), sidecar={"has_rings": False})
    assert ckpt.newest_ring_step(d) == 3


def test_prune_never_removes_the_newest_ring_step(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 1, payload(), sidecar={"has_rings": True})
    for s in (2, 3, 4):
        ckpt.save_checkpoint(d, s, payload(), sidecar={"has_rings": False})
    assert ckpt.prune_checkpoints(d, 1) == [2, 3]
    names = sorted(os.listdir(d))
    assert names == ["ckpt_000001", "ckpt_000001.json", "ckpt_000004", "ckpt_000004.json"]
    assert ckpt.prune_checkpoints(d, 0) == []
    ckpt.save_checkpoint(d, 5, payload(), sidecar={"has_rings": True})
    assert ckpt.prune_checkpoints(d, 1) == [1, 4]
    assert ckpt.latest_step(d) == 5 and json.loads((tmp_path / "ckpt_000005.json").read_text())
