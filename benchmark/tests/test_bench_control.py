"""The control of ``correct`` at a size a test run holds: the reference
at the precision below the configuration's (pixels stored as float16) is
judged not correct by the run's own comparison, on three seeds; the
reference itself is judged correct."""

import pytest

from harness import check, fixture, manifest, traffic


@pytest.mark.parametrize("name", ["plane-png-random", "render-viewport"])
def test_control_fails_reference_passes(small_root, name):
    cell = manifest.resolve(name, small_root)
    for seed in (1, 2**31 + 3, 77):
        data = fixture.pixels(cell.config["image"], cell.config["content"], seed, 2)
        streams = [traffic.Client(cell.kind, cell.config, cell.traffic, seed, k)
                   for k in range(cell.traffic["clients"])]
        specs = [s for st in streams for _ in range(2) for s in st.step()]
        control = check.judge_arrays(specs, cell.kind.control, cell.kind, data)
        reference = check.judge_arrays(specs, cell.kind.expected, cell.kind, data)
        assert control["compared"] > 0 and reference["compared"] == control["compared"]
        assert not check.verdict(control) and control["wrong_pixels"] > 1000
        assert check.verdict(reference) and reference["wrong_pixels"] == 0
