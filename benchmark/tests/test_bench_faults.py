"""Whole runs of the harness on the CPU at small sizes (the look for a
card skipped): a sound program is judged correct, and the program broken
underneath (``faults/``) is judged not correct, once for each fault a
cell can have: an answer altered where it is produced, half of a batch
left out. (A step that returns its state unchanged and the exchange
between chips have no counterpart in a one-card tile server.)"""

import json
import time

import pytest
from conftest import BENCH

from harness import cell

SECONDS = "3"


def _run(root, capsys, workload, preload=None, seed=5):
    rc = cell.run(["--workload", workload, "--seed", str(seed), "--seconds", SECONDS,
                   "--trace", "0"], time.monotonic(), root=root, device="cpu",
                  require_chip=False, preload=preload)
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    result = json.loads(out.strip().splitlines()[-1])
    assert list(result)[-1] == "checks" and err.strip().splitlines()[-1].startswith("check ")
    return result


@pytest.mark.parametrize("workload", ["plane-png-random", "render-viewport"])
def test_sound_run_is_correct(small_root, capsys, workload):
    result = _run(small_root, capsys, workload, seed=2**31 + 9)
    assert result["correct"] is True, result
    assert result["attempted"] > 0 and result["compared"] > 0
    assert {"wire_bytes_per_tile", "setup_s"} == set(result["metrics"])


@pytest.mark.parametrize("fault, number", [("answer_altered", "wrong_pixels"),
                                           ("half_batch", "bad_answers")])
def test_fault_is_not_correct(small_root, capsys, fault, number):
    result = _run(small_root, capsys, "plane-png-random", BENCH / "tests" / "faults" / f"{fault}.py")
    assert result["correct"] is False
    assert result["checks"][number]["value"] > result["checks"][number]["limit"]
