"""A later change adds a configuration, a traffic mix and a per-layer
metric as files and ``BENCHMARK.json`` entries: the harness finds them
with no edit of a file it has."""

import json

from harness import manifest


def test_new_files_are_found(small_root):
    bench = small_root / "benchmark"
    config = json.loads((bench / "configs" / "plane-u16-10k.json").read_text())
    config["image"]["size_c"] = 1
    (bench / "configs" / "throwaway-u16.json").write_text(json.dumps(config))
    mix = json.loads((bench / "traffic" / "tile-png-random.json").read_text())
    mix["clients"] = 3
    (bench / "traffic" / "throwaway-mix.json").write_text(json.dumps(mix))
    (bench / "metrics" / "throwaway_count.py").write_text(
        "def read(ctx):\n    return float(len(ctx.requests))\n")
    m = json.loads((small_root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "throwaway-u16", "source": "a test",
                         "file": "benchmark/configs/throwaway-u16.json", "reduced": [],
                         "why": "a test"})
    m["workloads"].append({"name": "throwaway-cell", "config": "throwaway-u16",
                           "traffic": "throwaway-mix", "chips": 1, "why": "a test"})
    m["per_layer"].append({"name": "throwaway_count", "unit": "requests", "better": "higher",
                           "source": "program_counter", "layer": "a test",
                           "moves": "tiles_per_s", "workloads": ["throwaway-cell"]})
    (small_root / "BENCHMARK.json").write_text(json.dumps(m))
    assert manifest.problems(m) == []
    cell = manifest.resolve("throwaway-cell", small_root)
    assert cell.config["image"]["size_c"] == 1 and cell.traffic["clients"] == 3
    assert "throwaway_count" in cell.readers
    assert cell.readers["throwaway_count"].read(type("C", (), {"requests": [1, 2]})) == 2.0
    # the cells that were there do not report the new metric
    assert "throwaway_count" not in manifest.resolve("plane-png-random", small_root).readers


def test_cell_added_as_data_runs(small_root, capsys):
    """A cell whose mix is new data alone (other clients and grid) runs on
    the CPU with no edit of the harness."""
    import time

    from harness import cell as run_cell

    bench = small_root / "benchmark"
    mix = json.loads((bench / "traffic" / "tile-png-random.json").read_text())
    mix.update(clients=3, align=512)
    (bench / "traffic" / "tile-png-grid.json").write_text(json.dumps(mix))
    m = json.loads((small_root / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": "plane-png-grid", "config": "plane-u16-10k",
                           "traffic": "tile-png-grid", "chips": 1, "why": "a test"})
    (small_root / "BENCHMARK.json").write_text(json.dumps(m))
    rc = run_cell.run(["--workload", "plane-png-grid", "--seed", "4", "--seconds", "3",
                       "--trace", "0"], time.monotonic(), root=small_root, device="cpu",
                      require_chip=False)
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and result["correct"] is True and result["attempted"] > 0
    assert {"tiles_per_s", "p50_ms", "wire_bytes_per_tile", "setup_s"} == set(result["metrics"])
