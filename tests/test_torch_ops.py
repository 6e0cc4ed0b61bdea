"""The port's ops modules against tpu_locoman's: checkpoint (the .npz
carry, written and read by either package) and diagnostics
(row_group_layout, structure_check, solve_report, spy_plot,
profile_trace), at Go2 N=3 on a split configuration (centroidal_acc) and
a whole-stage one (whole_body_rnea with include_acc=False).

Tolerances: the carry round trip is exact, and a resumed tick equals the
uninterrupted one exactly (the same arithmetic on the same inputs); the
row groups and the structure report's counts equal JAX's, its nonzero
shares within 1% absolute (entries near the 1e-6 threshold may land on
either side of it in f32). JAX's row groups and structure reports are
recorded in tests/data/torch_structure_jax.json, which
``JAX_PLATFORMS=cpu python tests/test_torch_ops.py`` rewrites."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import tpu_locoman as J  # noqa: E402
from tpu_locoman import checkpoint as jck, diagnostics as jdiag  # noqa: E402
import tpu_locoman_torch as T  # noqa: E402
from tpu_locoman_torch import checkpoint, diagnostics  # noqa: E402

CONFIGS = [("centroidal_acc", {}), ("whole_body_rnea", {"include_acc": False})]
# the JAX package's row groups and structure report of each configuration,
# written by running this file as a script
STRUCTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                         "torch_structure_jax.json")
TARGET = [0.1, 0, 0, 0, 0, 0]


def _mpcs(dyn, kw):
    jr, tr = J.Go2(), T.Go2()
    jr.set_gait_sequence("trot", 0.5)
    tr.set_gait_sequence("trot", 0.5)
    cfg = dict(nodes=3, **kw)
    return (J.MPC(jr, dynamics=dyn, config=J.SQPConfig(
                sqp_iters=1, admm=J.ADMMConfig(iters=10)), **cfg),
            T.MPC(tr, dynamics=dyn, config=T.SQPConfig(
                sqp_iters=1, admm=T.ADMMConfig(iters=10)), device="cpu",
                **cfg))


def test_save_load_resume_is_exact(tmp_path):
    _, tm = _mpcs("centroidal_acc", {})
    carry = tm.init_carry(2)
    tg = torch.tensor([TARGET, [0.2, 0, 0, 0, 0, 0.1]])
    for k in range(2):
        carry, _ = tm.step(carry, k * tm.dt_min, tg)
    path = checkpoint.save_carry(tmp_path / "carry", carry)
    assert path.endswith(".npz") and os.path.exists(path)
    restored = checkpoint.load_carry(path, device="cpu")
    for a, b in zip(torch.utils._pytree.tree_leaves(carry),
                    torch.utils._pytree.tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    c1, s1 = tm.step(carry, 2 * tm.dt_min, tg)
    c2, s2 = tm.step(restored, 2 * tm.dt_min, tg)
    assert torch.equal(c1.x_init, c2.x_init)
    assert torch.equal(c1.solver_state.Z, c2.solver_state.Z)
    assert torch.equal(s1["max_violation"], s2["max_violation"])


def test_carry_files_cross_between_packages(tmp_path):
    """The JAX package's carry (one scenario) loads in the port with a
    scenario axis of one; the port's loads in the JAX package with the
    same arrays; the keys are the same. The carry has the step's shapes
    and numpy-seeded values in every entry: the file format is what is
    held here, and a JAX tick to fill it would cost a two-minute compile."""
    jm, _ = _mpcs("centroidal_acc", {})
    rng = np.random.default_rng(7)
    jc = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(
        np.shape(x)).astype(np.float32)), jm.init_carry())
    jpath = jck.save_carry(str(tmp_path / "jax"), jc)
    tc = checkpoint.load_carry(jpath, device="cpu")
    assert tc.x_init.shape == (1,) + np.shape(jc.x_init)
    for a, b in ((tc.x_init, jc.x_init), (tc.solver_state.Z,
                                          jc.solver_state.Z),
                 (tc.solver_state.y_admm, jc.solver_state.y_admm),
                 (tc.tau_prev, jc.tau_prev)):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b))
    tpath = checkpoint.save_carry(str(tmp_path / "port.npz"), tc)
    back = jck.load_carry(tpath)
    np.testing.assert_array_equal(np.asarray(back.solver_state.z_admm),
                                  tc.solver_state.z_admm.numpy())
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files) == sorted(checkpoint.KEYS)


def _structure_key(dyn, kw):
    return dyn + "".join(f",{k}={v}" for k, v in sorted(kw.items()))


@pytest.mark.parametrize("dyn,kw", CONFIGS)
def test_row_groups_and_structure_match_jax(dyn, kw):
    """Against the JAX package's row_group_layout and structure_check of
    the same MPC, recorded in STRUCTURE (JAX's structure_check linearizes
    op by op: two to four minutes of the CPU per configuration)."""
    _, tm = _mpcs(dyn, kw)
    with open(STRUCTURE) as f:
        fix = json.load(f)[_structure_key(dyn, kw)]
    assert diagnostics.row_group_layout(tm.trans) == [
        tuple(g) for g in fix["row_groups"]]
    assert tm.trans.split_ok == (dyn == "centroidal_acc")
    rep, ref = diagnostics.structure_check(tm), fix["structure"]
    assert set(rep) == set(ref)
    for k, v in ref.items():
        if k.endswith("_frac"):
            assert abs(rep[k] - v) <= 0.01, (k, rep[k], v)
        else:
            assert rep[k] == v, k
    assert rep["finite"]


def test_solve_report_and_spy_plot(tmp_path):
    _, tm = _mpcs("whole_body_rnea", {"include_acc": False})
    carry = tm.init_carry(2)
    tg = torch.tensor([TARGET, TARGET])
    carry, _ = tm.step(carry, 0.0, tg)
    rep = diagnostics.solve_report(tm, carry, 0.01, tg, solve=True,
                                   scenario=1)
    assert np.isfinite(rep.max_violation) and np.isfinite(rep.objective)
    assert "dyn:tau_eq" in rep.violation_by_group
    assert "dyn:v_prop" not in rep.violation_by_group
    assert rep.extras["status"] in (0, 1) and "max_violation" in rep.pretty()
    idle = diagnostics.solve_report(tm, carry, 0.01, tg)
    assert np.isnan(idle.alpha)
    out = diagnostics.spy_plot(tm, str(tmp_path / "spy.png"))
    assert os.path.getsize(out["path"]) > 1000
    # no C pattern (include_acc=False): nothing counts as outside it
    assert out["offending_entries"] == 0


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    """The profile holds the program's spans, on its timeline: the tick's
    aten ops lie inside the tick's mpc.step span."""
    from tpu_locoman_torch import trace

    _, tm = _mpcs("centroidal_acc", {})
    carry = tm.init_carry(1)
    with diagnostics.profile_trace(str(tmp_path / "trace")) as d:
        torch.ones(4) @ torch.ones(4)
        tm.step(carry, 0.0, torch.tensor([TARGET]))
    assert not trace.enabled()
    path = os.path.join(d, "trace.json")
    assert os.path.getsize(path) > 0
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    step = [e for e in events if e.get("name") == "mpc.step"]
    assert len(step) == 1 and step[0]["ph"] == "X"
    t0, t1 = step[0]["ts"], step[0]["ts"] + step[0]["dur"]
    ops = [e["ts"] for e in events if e.get("cat") == "cpu_op"]
    inside = sum(t0 <= t <= t1 for t in ops)
    assert inside > 0.9 * len(ops) and inside < len(ops)
    trace.reset()


def _structure_recording():
    """JAX's row groups and structure report of each configuration."""
    out = {}
    for dyn, kw in CONFIGS:
        jm, _ = _mpcs(dyn, kw)
        out[_structure_key(dyn, kw)] = {
            "row_groups": [list(g) for g in jdiag.row_group_layout(jm.trans)],
            "structure": jdiag.structure_check(jm)}
    return out


def _make_structure_fixture():
    """Record _structure_recording in STRUCTURE."""
    with open(STRUCTURE, "w") as f:
        json.dump(_structure_recording(), f, indent=1)
    print("wrote", STRUCTURE)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    _make_structure_fixture()
