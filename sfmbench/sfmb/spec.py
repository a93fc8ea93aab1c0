"""Lookup by name: the cell's entry in BENCHMARK.json, its configuration
file, its traffic file, and the per-name modules of the benchmark's folders
(weights/, reference/, counts/, metrics/, faults/). A later cell,
configuration, traffic mix or metric is a new file and a new entry; nothing
here names one."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path


class Spec:
    """The benchmark as the files under `root` (a checkout) describe it."""

    def __init__(self, root: Path, folder: Path | None = None):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self.folder = Path(folder) if folder else self.root / self.bench["paths"][0]
        self._modules = {}

    def cell(self, name):
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name):
        for c in self.bench["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name):
        return json.loads((self.folder / "traffic" / f"{name}.json").read_text())

    def metrics(self, cell, kind):
        """The cell's metrics of one kind (end_to_end or per_layer): those
        without a workloads key, and those that list the cell."""
        return [m for m in self.bench[kind] if cell["name"] in m.get("workloads", [cell["name"]])]

    def module(self, kind, name):
        """sfmbench/<kind>/<name>.py, loaded once under a private name."""
        key = (kind, name)
        if key not in self._modules:
            path = self.folder / kind / f"{name}.py"
            mod_name = "sfmbench_" + re.sub(r"\W", "_", f"{kind}_{name}")
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]
