"""Each loss is one module of ``perfbench/losses/``, found by the
configuration's ``loss`` name, and the datasets a run redraws from its
generator states are the pool's own."""
import json

import _tiny
import pytest
import torch

from perfbench import data, losses, work

CONFIGS = sorted((_tiny.ROOT / "perfbench" / "configs").glob("*.json"))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_every_configured_loss_has_a_module(path):
    mod = losses.load(json.loads(path.read_text())["loss"])
    for name in ("targets", "drift", "prox_flops", "prox_floats", "Prox"):
        assert hasattr(mod, name), name
    assert work.prox_flops(mod.__name__.split(".")[-1], 2, 5) > 0


def test_unknown_loss_is_refused():
    with pytest.raises(ValueError, match="no loss"):
        losses.load("hinge")


@pytest.mark.parametrize("name", ["squared.solve_tol", "logistic.solve_tol"])
def test_redraw_gives_the_pool(name):
    cfg = _tiny.tiny_cell(name, nodes=400).config
    assign = torch.arange(400) // 200
    pool = data.make_pool(cfg, assign, 2**31 + 5, 3)
    states = data.pool_states(cfg, assign, 2**31 + 5, 3)
    w_true = data.true_weights(cfg, assign)
    for p in (2, 0):
        ds = data.redraw(cfg, w_true, states[p])
        assert torch.equal(ds.x, pool[p].x) and torch.equal(ds.y, pool[p].y)
        assert torch.equal(ds.labeled, pool[p].labeled)


def test_first_build_is_reported_apart(tmp_path):
    first = _tiny.run_tiny("squared.solve_tol", tmp_path, calls=1)
    again = _tiny.run_tiny("squared.solve_tol", tmp_path, calls=1)
    assert first["notes"]["first_build_s"] > 0
    assert again["notes"]["first_build_s"] is None
    phases = first["notes"]["setup_phases_s"]
    assert first["metrics"]["setup_s"]["value"] == pytest.approx(
        phases["warm_up"] - first["notes"]["first_build_s"])
