"""Finding a cell's parts by name: `BENCHMARK.json` at the root of the
checkout names each cell's configuration and traffic mix; the
configuration's file is `configs[].file`, the mix is
`benchmark/traffic/<traffic>.json`, whose `driver` key names the driver,
`benchmark/drivers/<driver>.py`; the configuration's `reference` key
names the plain reference it is checked against,
`benchmark/reference/<reference>.py`; the limits of its comparison are
`benchmark/limits/<cell>.json`, and each per-layer metric is read by
`benchmark/metrics/<metric>.py`. Adding any of them is adding a file and
an entry; nothing here names one."""
from __future__ import annotations

import copy
import importlib.util
import json
import sys
from pathlib import Path


def load(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def deep_merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = deep_merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def cell(root: Path, bench: dict, name: str) -> dict:
    """{workload, config (the file's contents), traffic (the mix's
    parameters)} of the cell `name`; KeyError for a cell, configuration or
    mix that is not there."""
    work = {w["name"]: w for w in bench["workloads"]}[name]
    entry = {c["name"]: c for c in bench["configs"]}[work["config"]]
    traffic = root / "benchmark" / "traffic" / f"{work['traffic']}.json"
    if not traffic.exists():
        raise KeyError(f"no traffic mix {work['traffic']!r}")
    return {"workload": work, "config": json.loads((root / entry["file"]).read_text()),
            "traffic": json.loads(traffic.read_text())}


def applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def metrics(bench: dict, kind: str, cell_name: str) -> list:
    """The `kind` ("end_to_end" or "per_layer") metrics the cell reports."""
    return [m for m in bench[kind] if applies(m, cell_name)]


def _module(path: Path, kind: str):
    if not path.exists():
        raise KeyError(f"no {kind} {path.stem!r}")
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod     # a dataclass looks its module up there
    spec.loader.exec_module(mod)
    return mod


def reader(root: Path, metric: str):
    """`read(rec, ctx)` of benchmark/metrics/<metric>.py."""
    return _module(root / "benchmark" / "metrics" / f"{metric}.py", "metric").read


def driver(root: Path, name: str):
    """The module benchmark/drivers/<name>.py (`harness.program` says what
    it holds)."""
    return _module(root / "benchmark" / "drivers" / f"{name}.py", "driver")


def reference(root: Path, name: str):
    """The module benchmark/reference/<name>.py: a plain reference, with
    `replay(...)` (`harness.check.reference` says how it is called)."""
    return _module(root / "benchmark" / "reference" / f"{name}.py", "reference")
