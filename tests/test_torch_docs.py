"""The port's docs page, docs/torch.rst, builds with tools/docgen.py (which
imports every ``.. automodule::`` target and resolves every ``:members:``
name) and resolves the port's core names."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_torch_page_builds(tmp_path):
    out = tmp_path / "html"
    p = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "docgen.py"),
         "--src", os.path.join(REPO, "docs"), "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert p.returncode == 0, p.stderr
    page = (out / "torch.html").read_text()
    for probe in ("msrouse_logL_sym", "sample_dataset", "FixedkSampler",
                  "msrouse_logL_dense", "GenericGaussianModel", "calibrate_rouse",
                  "load_trajectories_csv", "set_rouse_matmul"):
        assert f'<span class="sig">{probe}' in page or \
            f'<span class="sig">class {probe}' in page, probe
    # the differences table and the benchmark commands
    assert "<table>" in page and "<th>bild_tpu_torch</th>" in page
    assert page.count("<tr>") >= 8
    assert "<code>bench_torch.py</code>" in page and "<code>bench_e2e_torch.py</code>" in page
    assert ":orphan:" not in page
