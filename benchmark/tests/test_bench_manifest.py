"""``BENCHMARK.json``: names and units within their alphabets, every
per-layer metric's cells report the end-to-end metric it moves, every
configuration keeps a cell, every file named exists."""

import copy
import json

import pytest
from conftest import ROOT

from harness import manifest


def test_manifest_is_sound():
    m = manifest.read_manifest()
    assert manifest.problems(m) == []
    assert m["command"] == ["python3", "benchmark/run.py"] and m["paths"] == ["benchmark"]
    for c in m["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
    for w in m["workloads"]:
        cell = manifest.resolve(w["name"])
        assert cell.chips == 1 and cell.readers
    assert {e["name"] for e in m["end_to_end"]} == {"wire_bytes_per_tile", "setup_s"}


@pytest.mark.parametrize("break_it, finding", [
    (lambda m: m["end_to_end"][0].update(name="tiles per s"), "bad name"),
    (lambda m: m["end_to_end"][0].update(unit="tiles per second"), "bad unit"),
    (lambda m: m["per_layer"][0].update(unit="µs"), "bad unit"),
    (lambda m: m["configs"].append(dict(m["configs"][0], name="spare-config")), "has no cell"),
    (lambda m: m["per_layer"][0].update(moves="nothing_ms"), "unknown metric"),
    (lambda m: m["end_to_end"][0].update(workloads=["plane-png-random"]), "does not report"),
    (lambda m: m["configs"][0]["reduced"].append("a key"), "bad reduced key"),
    (lambda m: m["workloads"][1].update(name="plane-png-random"), "a name repeats"),
])
def test_problems_found(break_it, finding):
    m = copy.deepcopy(manifest.read_manifest())
    break_it(m)
    assert any(finding in p for p in manifest.problems(m)), manifest.problems(m)


def test_size_limit():
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    json.loads((ROOT / "BENCHMARK.json").read_text())
