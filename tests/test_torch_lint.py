"""The port package under the repo's lint gate (``tools/analyze``), with
no baseline: no finding. Where the JAX package justifies a finding inline
(``# ompb-lint: disable=<rule> -- <why>``), the port's counterpart does
the same; everything else is fixed."""

from tools.analyze import run_paths


def test_port_package_has_no_lint_findings():
    report = run_paths(["omero_ms_pixel_buffer_tpu_torch"], baseline_path=None)
    assert [(f.rule, f.path, f.line, f.message) for f in report.findings] == []
    # the new membership modules are in the analysed set
    paths = {sf.path for sf in report.project.files}
    for module in ("membership", "gossip", "brains"):
        assert f"omero_ms_pixel_buffer_tpu_torch/cluster/{module}.py" in paths
