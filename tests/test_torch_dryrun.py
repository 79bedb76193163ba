"""The port's multi-device dryrun (``cli/dryrun_multichip.py``, after
``__graft_entry__.py::dryrun_multichip``) on 4 CPU devices: dp over 4 gloo
processes, dp × tp and dp × sp over 2 processes of 2 devices, dp × pp on a
(2, 2) grid and fused fold-parallel inference on a 1 × 4 grid each print
their OK line with a finite loss; no leg waits."""

import numpy as np
import pytest

from ball_action_spotting_torch.cli import dryrun_multichip


def test_dryrun_on_four_cpu_devices(capsys):
    rows = dryrun_multichip.main(["--devices", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert [r["leg"] for r in rows] == ["dp", "dp x tp", "dp x sp", "dp x pp",
                                        "fused fold_parallel"]
    for row in rows:
        assert row["ok"]
        if "loss" in row:
            assert np.isfinite(row["loss"])
    assert "loss" in rows[2] and rows[2]["loss"] == pytest.approx(rows[1]["loss"], rel=1e-5)
    for line in ("mesh (data=4, model=1) [dp]", "mesh (data=2, model=2) [dp x tp]",
                 "mesh (data=2, model=2) [dp x sp]", "mesh (data=2, model=2) [dp x pp]",
                 "mesh (data=1, model=4) [fused fold_parallel inference]"):
        assert f"dryrun_multichip OK: {line}" in out
    assert "WAITS" not in out


def test_dryrun_on_one_device_runs_dp_only(capsys):
    rows = dryrun_multichip.dryrun_multichip(1, "cpu")
    assert [r["leg"] for r in rows] == ["dp"] and rows[0]["ok"]
    assert "dryrun_multichip OK: mesh (data=1, model=1) [dp]" in capsys.readouterr().out
