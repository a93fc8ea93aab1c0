"""Lookup by name: a cell, a configuration's traffic mix and a per-layer
metric added as new files and entries, with no file of the benchmark
edited, are found."""

import hashlib
import json

from conftest import make_tiny_checkout
from sfmb.spec import Spec


def digests(folder):
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_metric_and_traffic_are_found(tmp_path):
    co = make_tiny_checkout(tmp_path)
    before = digests(co / "sfmbench")
    (co / "sfmbench" / "traffic" / "tiny4.json").write_text(json.dumps({"images": 4, "width": 160, "height": 120,
                                                                         "focal": 130.0, "baseline": 0.18,
                                                                         "wedge": True, "texture_res": 256,
                                                                         "pool": 1, "warmup_images": 2}))
    (co / "sfmbench" / "metrics" / "scenes_per_window.py").write_text(
        "def read(run):\n    return float(len(run.scenes))\n")
    bench = json.loads((co / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.rgb4", "config": "tiny", "traffic": "tiny4", "chips": 1, "why": "t"})
    bench["per_layer"].append({"name": "scenes_per_window", "unit": "scenes", "better": "higher",
                               "source": "host_clock", "layer": "mapper", "moves": "frames_per_s",
                               "workloads": ["tiny.rgb4"]})
    (co / "BENCHMARK.json").write_text(json.dumps(bench))
    after = digests(co / "sfmbench")
    assert all(after[k] == v for k, v in before.items())  # nothing edited, only added
    spec = Spec(co, co / "sfmbench")
    cell = spec.cell("tiny.rgb4")
    assert spec.traffic(cell["traffic"])["images"] == 4
    assert spec.config(cell["config"])["name"] == "tiny"
    names = [m["name"] for m in spec.metrics(cell, "per_layer")]
    assert "scenes_per_window" in names and "mfu" in names
    assert "scenes_per_window" not in [m["name"] for m in spec.metrics(spec.cell("tiny.rgb3"), "per_layer")]
    assert spec.module("metrics", "scenes_per_window").read(type("R", (), {"scenes": [1, 2]})) == 2.0
