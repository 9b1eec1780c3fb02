"""``BENCHMARK.json`` keeps the benchmark's contract on names, units and
keys, and every configuration, traffic mix, limit and metric it names is
found by its name."""
import json
import re

import _tiny
import pytest

from perfbench import bench

SPEC = json.loads((_tiny.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names))
    for e in SPEC[section]:
        extra = set(e) - KEYS[section]
        assert extra <= ({"workloads"} if section in ("end_to_end",
                                                      "per_layer")
                         else set()), (e["name"], extra)
        assert KEYS[section] <= set(e), e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                    and "\t" not in e[key], (e["name"], key)
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])
        for key in e.get("reduced", []):
            assert NAME.match(key)


def test_metrics_are_wired():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in set(e2e[m["moves"]].get("workloads", cells))
        if m["name"].split(".")[0].endswith("_roofline") or \
                "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cells_found_by_name(cell):
    c = bench.Cell.load(cell)
    assert c.chips in (1, 4)
    assert c.config["name"] in {x["name"] for x in SPEC["configs"]}
    assert bench.kind_module(c.traffic).__name__.endswith(
        c.traffic["kind"])
    limits = bench.load_json(bench.HERE / "limits" / f"{cell}.json")
    assert limits and all(v > 0 for v in limits.values())
    names = {m["name"] for m in c.end_to_end()}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer()
    for m in c.per_layer():
        assert callable(bench.metric_reader(m["name"]))


def test_configs_state_their_cuts():
    for c in SPEC["configs"]:
        assert c["file"].startswith("perfbench/configs/")
        cfg = json.loads((_tiny.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert "assumed" in cfg and cfg["source"] == c["source"]
