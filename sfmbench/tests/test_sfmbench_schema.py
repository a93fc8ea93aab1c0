"""BENCHMARK.json against the benchmark's contract: keys, names and units,
bounds, cells, and a file for every name it uses."""

import json
import re

from conftest import HERE, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "sfmbench/run.py"] and len(b["command"]) <= 32
    assert b["paths"] == ["sfmbench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) <= 64 * 1024
    for word in b["command"]:
        assert LINE.match(word) and not word.startswith("/") and ".." not in word


def test_configs_and_cells():
    b = bench()
    names = [c["name"] for c in b["configs"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("sfmbench/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    cells = b["workloads"]
    assert 1 <= len(cells) <= 24 and len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
    assert {w["config"] for w in cells} == set(names)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)


def test_metrics():
    b = bench()
    e2e, layer = b["end_to_end"], b["per_layer"]
    names = [m["name"] for m in e2e + layer]
    assert len(set(names)) == len(names) and 1 <= len(e2e) <= 16 and 1 <= len(layer) <= 128
    assert "setup_s" in names
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in SOURCES_E2E and 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in b["workloads"]}
    for m in layer:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and LINE.match(m["layer"]) and m["moves"] in {x["name"] for x in e2e}
        assert set(m.get("workloads", cells)) <= cells
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    for m in e2e + layer:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in layer:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_config_names_files_that_exist():
    for c in bench()["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        for net in cfg["nets"]:
            assert (HERE / "weights" / f"{net}.py").is_file()
        for name in cfg["checks"]:
            assert (HERE / "reference" / f"{name}.py").is_file()
        for name in cfg["counted"]:
            assert (HERE / "counts" / f"{name}.py").is_file()
        assert cfg["limits"] and all(v > 0 for v in cfg["limits"].values())
