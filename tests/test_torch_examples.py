"""The port's command-line examples (``tpu_locoman_torch.examples``), small
on the CPU: run_mpc (Go2 whole_body_rnea N=6, 20 loops, batch 2) writes
its trajectory dump and its 3D replay, and holds the verify skill's health
criteria at that size (violation median < 0.5, final base height near
Go2's 0.35 m); run_ocp --debug (Go2 centroidal_vel N=6) gives a small
violation and the EOM-against-RNEA check at f32 roundoff."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tpu_locoman_torch.examples import run_mpc, run_ocp  # noqa: E402


def test_run_mpc_writes_dump_and_replay(tmp_path, capsys):
    dump, html = str(tmp_path / "traj.json"), str(tmp_path / "replay.html")
    res = run_mpc.main(["--device", "cpu", "--robot", "go2", "--nodes", "6",
                        "--mpc-loops", "20", "--admm-iters", "15",
                        "--batch", "2", "--dump", dump, "--viz", html])
    out = capsys.readouterr().out
    assert "Tracked vx (m/s):" in out and "Trajectory dumped to" in out
    with open(dump) as f:
        d = json.load(f)
    assert np.asarray(d["x"]).shape == (20, res["mpc"].form.nx)
    assert d["dt"] == pytest.approx(0.01)
    assert os.path.getsize(html) > 3000 and os.path.exists(html + ".json")
    assert res["outs"]["x"].shape[:2] == (20, 2)
    assert res["viol_median"] < 0.5
    assert abs(res["final_pos"][2] - 0.35) < 0.05


def test_run_ocp_debug_eom_check(capsys):
    res = run_ocp.main(["--device", "cpu", "--robot", "go2", "--dynamics",
                        "centroidal_vel", "--nodes", "6", "--sqp-iters", "4",
                        "--admm-iters", "80", "--debug"])
    out = capsys.readouterr().out
    assert "Avg tau_diff:" in out and "Horizon length (s):" in out
    assert res["max_violation"] < 0.05
    assert res["tau_diff"] < 1e-3 and np.isfinite(res["tau_b_norm"])
