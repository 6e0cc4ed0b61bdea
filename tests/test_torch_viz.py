"""The port's visualization (``tpu_locoman_torch.viz``), the counterpart of
tests/test_viz_diag.py's scene test and tests/test_viz_live.py: the
scene's points against the JAX package's ``dump_scene`` on the same
numpy-seeded trajectory within 1e-5 (f32 forward kinematics, summed in
another order), the player page, the trajectory dump and the live viewer's
protocol on localhost."""

import json
import os
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import tpu_locoman as J  # noqa: E402
from tpu_locoman import viz as jviz  # noqa: E402
import tpu_locoman_torch as T  # noqa: E402
from tpu_locoman_torch import viz  # noqa: E402


def _traj(robot, T_=4, seed=0):
    rng = np.random.default_rng(seed)
    q = np.tile(np.asarray(robot.q0, np.float32), (T_, 1))
    quat = rng.normal(size=(T_, 4)).astype(np.float32)
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=-1, keepdims=True)
    q[:, :3] += rng.normal(size=(T_, 3)).astype(np.float32) * 0.1
    q[:, 7:] += rng.normal(size=(T_, robot.model.nj)).astype(np.float32) * 0.3
    return q


@pytest.mark.parametrize("name", ["Go2", "B2G"])
def test_scene_points_match_jax(tmp_path, name):
    robot, jrobot = getattr(T, name)(), getattr(J, name)()
    feet = tuple(robot.FOOT_FRAMES)
    q = _traj(robot)
    mine = viz.dump_scene(str(tmp_path / "port.json"), robot.model, q, 0.01,
                          frame_names=feet, device="cpu")
    ref = jviz.dump_scene(str(tmp_path / "jax.json"), jrobot.model, q, 0.01,
                          frame_names=feet)
    with open(mine) as a, open(ref) as b:
        s, r = json.load(a), json.load(b)
    assert {k: v for k, v in s.items() if k != "points"} == {
        k: v for k, v in r.items() if k != "points"}
    np.testing.assert_allclose(np.asarray(s["points"]),
                               np.asarray(r["points"]), atol=1e-5)
    pts = viz.positions(robot.model, torch.tensor(q), feet, device="cpu")
    assert pts.shape == (4, robot.model.n_links + 4, 3)


def test_player_html_and_trajectory_dump(tmp_path):
    robot = T.Go2()
    q = np.tile(np.asarray(robot.q0, np.float32), (3, 1))
    scene = viz.dump_scene(str(tmp_path / "scene.json"), robot.model, q,
                           0.01, frame_names=tuple(robot.FOOT_FRAMES),
                           device="cpu")
    with open(scene) as f:
        feet_z = np.asarray(json.load(f)["points"])[0, -4:, 2]
    assert np.all(np.abs(feet_z) < 0.1), feet_z  # nominal pose: feet down
    html = viz.write_player_html(str(tmp_path / "replay.html"), scene)
    text = open(html).read()
    assert "const LIVE = false;" in text and '"points"' in text
    assert os.path.getsize(html) > 3000
    path = viz.dump_trajectory(str(tmp_path / "traj.json"),
                               torch.tensor(q), 0.01, v_traj=np.zeros((3, 18)))
    with open(path) as f:
        d = json.load(f)
    assert d["dt"] == 0.01 and np.asarray(d["q"]).shape == (3, 19)
    assert "v" in d and "tau" not in d


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode()


def test_live_viewer_roundtrip():
    robot = T.Go2()
    model = robot.model
    viewer = viz.LiveViewer(model, frame_names=tuple(robot.FOOT_FRAMES),
                            dt=0.02, port=0, device="cpu")
    try:
        status, html = _get(viewer.url)
        assert status == 200 and "const LIVE = true;" in html
        scene = json.loads(_get(viewer.url + "scene")[1])
        n_pts = model.n_links + 4
        assert np.asarray(scene["points"]).shape == (1, n_pts, 3)
        assert _get(viewer.url + "frame?since=0")[0] == 204
        assert viewer.push(torch.tensor(robot.q0)) == 1
        status, body = _get(viewer.url + "frame?since=0")
        frame = json.loads(body)
        assert status == 200 and frame["seq"] == 1
        pts = np.asarray(frame["points"])
        assert pts.shape == (n_pts, 3)
        assert np.all(np.abs(pts[scene["markers"], 2]) < 0.12)
        assert _get(viewer.url + "frame?since=1")[0] == 204
    finally:
        viewer.close()
