"""``BENCHMARK.json`` and the files it names. A cell (``workloads``
entry) names a configuration, found as ``configs/<name>.json``, and a
traffic mix, found as ``traffic/<name>.json``; every metric but
``setup_s`` is the reader ``metrics/<name>.py``; a traffic mix's ``kind`` is the request
kind ``kinds/<kind>.py``. Adding any of them is adding files: nothing
here lists them. A configuration's ``server_env`` may set only ``OMPB_*``
variables, as strings, and its ``image`` only what ``fixture.write``
makes."""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

from harness import fixture

BENCH = Path(__file__).resolve().parents[1]  # the benchmark's folder
ROOT = BENCH.parent  # the checkout
SETUP = "setup_s"  # the one metric the harness takes itself; every other has a reader
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_.\-/%]{1,16}$")
SERVER_ENV = re.compile(r"^OMPB_[A-Z0-9_]+$")


class ManifestError(ValueError):
    """``BENCHMARK.json`` or a file it names is missing or malformed."""


def load_module(path: Path, name: str):
    """Import one Python file of the benchmark by its path."""
    if not path.is_file():
        raise ManifestError(f"missing {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """One workload with everything it names, resolved."""

    name: str
    chips: int
    config: dict
    traffic: dict
    kind: object
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, object] = field(default_factory=dict)


def read_manifest(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise ManifestError("no BENCHMARK.json at the root of the checkout")
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(workload: str, root: Path = ROOT) -> Cell:
    """The cell named ``workload`` with its configuration, traffic, request
    kind and the readers of its per-layer metrics."""
    manifest = read_manifest(root)
    bench = root / BENCH.name
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise ManifestError(f"no workload {workload!r} in BENCHMARK.json")
    entry = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    if entry["config"] not in configs:
        raise ManifestError(f"{workload}: no configuration {entry['config']!r}")
    with open(root / configs[entry["config"]]["file"]) as f:
        config = json.load(f)
    env = config.get("server_env", {})
    if not isinstance(env, dict) or not all(
            isinstance(k, str) and SERVER_ENV.match(k) and isinstance(v, str)
            for k, v in env.items()):
        raise ManifestError(f"{entry['config']}: server_env sets only OMPB_* variables "
                            f"to strings: {env!r}")
    bad = fixture.problems(config["image"])
    if bad:
        raise ManifestError(f"{entry['config']}: image: {'; '.join(bad)}")
    traffic_path = bench / "traffic" / f"{entry['traffic']}.json"
    if not traffic_path.is_file():
        raise ManifestError(f"missing {traffic_path.relative_to(root)}")
    with open(traffic_path) as f:
        traffic = json.load(f)
    kind = load_module(bench / "kinds" / f"{traffic['kind']}.py", f"bench_kind_{traffic['kind']}")
    end_to_end = [m for m in manifest["end_to_end"] if _reports(m, workload)]
    per_layer = [m for m in manifest["per_layer"] if _reports(m, workload)]
    readers = {m["name"]: load_module(bench / "metrics" / f"{m['name']}.py",
                                      f"bench_metric_{m['name'].replace('.', '_')}")
               for m in end_to_end + per_layer if m["name"] != SETUP}
    return Cell(workload, int(entry["chips"]), config, traffic, kind, end_to_end,
                per_layer, readers)


def problems(manifest: dict) -> List[str]:
    """What is wrong with a manifest's names, units and cross references
    (empty when nothing is)."""
    out = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in manifest[section]]
        if len(set(names)) != len(names):
            out.append(f"{section}: a name repeats")
        for e in manifest[section]:
            if not NAME.match(e["name"]):
                out.append(f"{section}: bad name {e['name']!r}")
    for e in manifest["end_to_end"] + manifest["per_layer"]:
        if not UNIT.match(e["unit"]):
            out.append(f"{e['name']}: bad unit {e['unit']!r}")
        if e["better"] not in ("lower", "higher"):
            out.append(f"{e['name']}: better is {e['better']!r}")
    for c in manifest["configs"]:
        for key in c["reduced"]:
            if not NAME.match(key):
                out.append(f"{c['name']}: bad reduced key {key!r}")
    for w in manifest["workloads"]:
        for key in ("config", "traffic"):
            if not NAME.match(w[key]):
                out.append(f"{w['name']}: bad {key} {w[key]!r}")
    cells = {w["name"] for w in manifest["workloads"]}
    used = {w["config"] for w in manifest["workloads"]}
    for c in manifest["configs"]:
        if c["name"] not in used:
            out.append(f"configuration {c['name']} has no cell")
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        if m["moves"] not in e2e:
            out.append(f"{m['name']} moves an unknown metric {m['moves']!r}")
            continue
        for cell in m.get("workloads", sorted(cells)):
            if cell not in cells:
                out.append(f"{m['name']}: unknown cell {cell}")
            elif not _reports(e2e[m["moves"]], cell):
                out.append(f"{m['name']}: {cell} does not report {m['moves']}")
    for cell in cells:
        if not any(_reports(m, cell) for m in manifest["per_layer"]):
            out.append(f"{cell} reports no per-layer metric")
    return out
