"""On the card: one short traced run of each cell at its full size,
correct, with every per-layer metric it declares and the device's
timeline. Skips where no card is present (decided inside the test)."""

import json
import subprocess
import sys

import pytest
from conftest import BENCH, ROOT

from harness import manifest


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["plane-png-random", "render-viewport"])
def test_traced_run_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", workload, "--seed",
         "2147483749", "--seconds", "5", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=1500)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
    declared = {m["name"] for m in manifest.resolve(workload).per_layer}
    assert set(result["metrics"]) == declared
    assert 0 < result["metrics"]["filter_roofline"]["value"] <= 105
