"""The formulation variants in the port against tpu_locoman: the four
whose stage the transcription linearizes whole (centroidal_vel,
centroidal_acc and whole_body_acc with include_base=False,
whole_body_rnea with include_acc=False) and the Euler-ZYX base
(use_quaternion=False) on the split path, at Go2 N=3.

- Transcription.linearize (g, G, B, C) against the JAX package's on the
  same iterate, within 2e-4 * (max|ref| + 1), recorded with JAX's
  structure attributes in tests/data/torch_variants_linearize_jax.npz
  (``JAX_PLATFORMS=cpu python tests/test_torch_variants.py`` rewrites it;
  the JAX linearize compiles for one to two minutes per case on a CPU);
- the whole-stage path against the port's own split path where both
  apply (the default formulations), within 1e-4 * (max|ref| + 1);
- rbda.rnea_ad and rbda.frame_kin_ad: their forward-mode rules against
  torch.func.jvp of the plain functions, 2e-4 * (max|ref| + 1) (the
  analytic derivatives reorder the f32 sums), and under the vmap over
  tangents of the whole-stage linearize: one derivative call per
  linearize, on plain (unwrapped) tensors, as a CUDA kernel needs;
- one MPC rollout per variant (3 ticks, batch 2) against the JAX fixture
  tests/data/torch_golden_variants.json (tools/make_torch_golden.py
  --variants; the JAX ticks compile for a minute or more each on a CPU)
  at tests/test_torch_mpc.py's tolerances, and MPC.retract of its last
  solution; ``slow`` adds the same rollouts against a live JAX tick;
- the three B2G N=14 fixtures of chip_smoke.py's variant phases
  replayed on the plain path at the bounds chip_smoke.py applies.
"""

import functools
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import tpu_locoman as J  # noqa: E402
import tpu_locoman_torch as T  # noqa: E402
from tpu_locoman_torch import convert, rbda as tr, rnea_derivs  # noqa: E402

from test_torch_formulations_mpc import _check_retract, _Ref  # noqa: E402
from test_torch_mpc import _check_tick, _hot  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "torch_golden_variants.json")
# the JAX package's linearize of each case (_jax_linearize), written by
# running this file as a script
LINEARIZE = os.path.join(ROOT, "tests", "data",
                         "torch_variants_linearize_jax.npz")
LIN_TOL = 2e-4
# (case, robot keyword arguments, dynamics, formulation keyword arguments)
WHOLE = [("rnea_noacc", {}, "whole_body_rnea", {"include_acc": False}),
         ("acc_nobase", {}, "whole_body_acc", {"include_base": False}),
         ("cacc_nobase", {}, "centroidal_acc", {"include_base": False}),
         ("cvel_nobase", {}, "centroidal_vel", {"include_base": False})]
EULER = [("euler_rnea", {"use_quaternion": False}, "whole_body_rnea", {}),
         ("euler_cacc", {"use_quaternion": False}, "centroidal_acc", {})]
CASES = {c[0]: c[1:] for c in WHOLE + EULER}


def _close(out, ref, rel, err_msg=""):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (err_msg, out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, atol=rel * (np.abs(ref).max() + 1),
                               err_msg=err_msg)


VEL = [0.2, 0.0, 0.0, 0.0, 0.0, 0.1]
FORM_ATTRS = ("nx", "ndx", "nu", "n_dyn", "n_prop_rows", "f_idx", "tau_idx")


def _jax_linearize(case, N=3, t=0.13, seed=3):
    """The JAX package's side of a case on Go2: one warm-started iterate
    plus seeded noise at time t (mixed contact and swing nodes), the
    structure the port must share, and the linearize there (one jitted
    call, which compiles for one to two minutes on a CPU)."""
    robot_kw, dyn, form_kw = CASES[case]
    jrob = J.Go2(**robot_kw)
    jrob.set_gait_sequence("trot", 0.8)
    jm = J.MPC(jrob, dynamics=dyn, nodes=N, **form_kw)
    carry = jm.init_carry()
    vel = jnp.array(VEL)
    shared = jm.make_shared(carry.x_init, vel, tau_prev=carry.tau_prev)
    sp = jm.make_stage_params(jnp.float32(t))
    rng = np.random.default_rng(seed)
    Z = jm.warm_start_Z(carry.solver_state.Z, sp, shared)
    Z = Z + jnp.asarray(rng.normal(size=Z.shape) * 0.02, dtype=jnp.float32)
    g, G, B, C = jax.device_get(jax.jit(
        lambda Z_: jm.trans.linearize(Z_, sp, shared))(Z))
    meta = {"split_ok": bool(jm.trans.split_ok),
            "c_eye_rows": jm.trans.c_eye_rows,
            **{a: getattr(jm.form, a) for a in FORM_ATTRS}}
    return {"meta": np.asarray(json.dumps(meta)), "Z": np.asarray(Z),
            "x_init": np.asarray(carry.x_init),
            "box_slots": np.asarray(jm.trans.box_slots), "g": g, "G": G,
            "B": B, "C": C}


def _linearize_recording():
    """_jax_linearize of every case, as LINEARIZE holds it."""
    return {f"{case}/{k}": v for case in CASES
            for k, v in _jax_linearize(case).items()}


def _record_linearize():
    """Write LINEARIZE."""
    np.savez_compressed(LINEARIZE, **_linearize_recording())
    print("wrote", LINEARIZE)


@functools.lru_cache(maxsize=None)
def _pair(case, N=3, t=0.13):
    """The port MPC of a case on Go2 at the recorded JAX iterate: (JAX's
    structure, JAX's arrays, the MPC, Z, stage and shared parameters,
    JAX's (g, G, B, C))."""
    robot_kw, dyn, form_kw = CASES[case]
    trob = T.Go2(**robot_kw)
    trob.set_gait_sequence("trot", 0.8)
    tm = T.MPC(trob, dynamics=dyn, nodes=N, device="cpu", **form_kw)
    with np.load(LINEARIZE) as d:
        rec = {k.split("/", 1)[1]: d[k] for k in d.files
               if k.startswith(case + "/")}
    meta = json.loads(str(rec["meta"]))
    tsp = tm.make_stage_params(torch.tensor([t], dtype=torch.float32))
    tsh = tm.make_shared(torch.tensor(rec["x_init"])[None], torch.tensor(VEL))
    ref = tuple(rec[k] for k in ("g", "G", "B", "C"))
    return meta, rec, tm, torch.tensor(rec["Z"])[None], tsp, tsh, ref


@pytest.mark.parametrize("case", [c[0] for c in WHOLE + EULER])
def test_linearize_matches_jax(case):
    meta, rec, tm, tZ, tsp, tsh, ref = _pair(case)
    assert tm.trans.split_ok == meta["split_ok"] == case.startswith("euler")
    assert tm.trans.c_eye_rows == meta["c_eye_rows"]
    assert tm.trans.box_slots.tolist() == rec["box_slots"].tolist()
    for attr in FORM_ATTRS:
        assert getattr(tm.form, attr) == meta[attr], attr
    out = tm.trans.linearize(tZ, tsp, tsh)
    for label, o, r in zip(("g", "G", "B", "C"), out, ref):
        _close(o[0], r, LIN_TOL, f"{case} {label}")
    _close(tm.trans.evaluate(tZ, tsp, tsh), out[0], 1e-5, "evaluate")


@pytest.mark.parametrize("dyn", ["whole_body_rnea", "whole_body_acc",
                                 "whole_body_aba", "centroidal_acc"])
@pytest.mark.parametrize("use_quaternion", [True, False])
def test_whole_stage_matches_split(dyn, use_quaternion):
    """Both linearizations of a default formulation agree; on the
    quaternion base the whole stage goes through rnea_ad's rule (K2's
    plain pass here) and the plain kinematics, the split path through the
    analytic blocks."""
    robot = T.Go2(use_quaternion=use_quaternion)
    robot.set_gait_sequence("trot", 0.8)
    tm = T.MPC(robot, dynamics=dyn, nodes=3, device="cpu")
    tr_ = tm.trans
    c = tm.init_carry(2)
    sh = tm.make_shared(c.x_init, torch.tensor([0.2, 0, 0, 0, 0, 0.1]))
    sp = tm.make_stage_params(torch.tensor([0.13, 0.41]))
    g = torch.Generator().manual_seed(5)
    Z = tm.warm_start_Z(c.solver_state.Z, sp, sh) + 0.02 * torch.randn(
        c.solver_state.Z.shape, generator=g)
    split = tr_.linearize(Z, sp, sh)
    whole = tr_._linearize_whole(Z, sp, sh)
    for label, o, r in zip(("g", "G", "B", "C"), whole, split):
        _close(o, r, 1e-4, f"{dyn} {label}")


def _rnea_sample(B=3, seed=0):
    rob = T.Go2()
    m = rob.model
    rng = np.random.default_rng(seed)
    q = np.tile(np.asarray(rob.q0, np.float32), (B, 2, 1))
    quat = rng.normal(size=(B, 2, 4)).astype(np.float32)
    q[..., 3:7] = quat / np.linalg.norm(quat, axis=-1, keepdims=True)
    q[..., 7:] += rng.normal(size=(B, 2, m.nj)).astype(np.float32) * 0.3
    v, a = rng.normal(size=(2, B, 2, m.nv)).astype(np.float32)
    f = rng.normal(size=(B, 2, 12)).astype(np.float32) * 30.0
    dq = rng.normal(size=q.shape).astype(np.float32)
    tan = [dq] + list(rng.normal(size=(2, B, 2, m.nv)).astype(np.float32))
    tan.append(rng.normal(size=f.shape).astype(np.float32))
    return m, [torch.tensor(x) for x in (q, v, a, f)], [
        torch.tensor(x) for x in tan]


def test_rnea_ad_and_frame_kin_ad_jvps():
    """Each rule against torch.func.jvp of the plain function, (B, N)
    leading dims, a coordinate tangent in q (projected to the tangent
    space by the rule, so the plain side takes the tangent of
    integrate)."""
    m, (q, v, a, f), (dq, dv, da, df) = _rnea_sample()
    feet = tuple(T.Go2.FOOT_FRAMES)
    # a coordinate tangent that integrate produces: d/ds integrate(q, s w)
    w = torch.cat([dq[..., :6], dq[..., 7:]], -1)
    _, dqc = torch.func.jvp(lambda s: tr.model_integrate(m, q, s * w),
                            (torch.zeros(()),), (torch.ones(()),))
    tau, dtau = torch.func.jvp(
        lambda *x: tr.rnea_ad(m, x[0], x[1], x[2], feet, x[3]),
        (q, v, a, f), (dqc, dv, da, df))
    tau_ref, dtau_ref = torch.func.jvp(
        lambda *x: tr.rnea(m, x[0], x[1], x[2], feet, x[3]),
        (q, v, a, f), (dqc, dv, da, df))
    _close(tau, tau_ref, 0.0, "tau")
    _close(dtau, dtau_ref, 2e-4, "dtau")
    frames = tuple(feet) + ("base",)
    out, dout = torch.func.jvp(lambda x, y: tr.frame_kin_ad(m, frames, x, y),
                               (q, v), (dqc, dv))

    def plain(x, y):
        R, p, vl = tr.fk_vel(m, x, y)
        vel = torch.stack([tr.frame_velocity_lwa_from(m, fn, R, p, vl)
                           for fn in frames], -2)
        pl = [tr.frame_placement(m, fn, R, p) for fn in frames]
        return (vel, torch.stack([x_[1] for x_ in pl], -2),
                torch.stack([x_[0] for x_ in pl], -3))

    ref, dref = torch.func.jvp(plain, (q, v), (dqc, dv))
    for name, o, r, do, dr in zip(("vel", "pos", "R"), out, ref, dout, dref):
        _close(o, r, 1e-5, name)
        _close(do, dr, 2e-4, "d" + name)


def test_rnea_ad_rule_runs_once_on_plain_tensors(monkeypatch):
    """Under the whole-stage linearize (a vmap over tangents of jvp) the
    rule calls rnea_derivatives once, on tensors free of torch.func's
    wrappers, at the flat batch of nodes: what K2's wrapper needs on a
    CUDA tensor (it reads their storage)."""
    from torch._C import _functorch as fc

    seen = []
    plain = rnea_derivs.rnea_derivatives

    def spy(model, q, *args):
        seen.append([fc.is_functorch_wrapped_tensor(x)
                     for x in (q,) + args if isinstance(x, torch.Tensor)]
                    + [tuple(q.shape), q.is_contiguous()])
        return plain(model, q, *args)

    monkeypatch.setattr(rnea_derivs, "rnea_derivatives", spy)
    _, _, tm, tZ, tsp, tsh, _ = _pair("rnea_noacc")
    tm.trans.linearize(tZ, tsp, tsh)
    assert len(seen) == 1, seen
    assert not any(seen[0][:-2]) and seen[0][-2:] == [(3, 19), True], seen


def _replay_fixture(case):
    gold = convert.load_golden(FIXTURE)
    c = gold["go2_" + case]
    s = c["setup"]
    robot = T.Go2(**s["robot_kwargs"])
    robot.set_gait_sequence(s["gait"], s["gait_period"])
    tm = T.MPC(robot, dynamics=s["dynamics"], nodes=s["nodes"],
               flip_reset=s["flip_reset"], warm_shift=s["warm_shift"],
               config=_hot(T, "cholinv_pb"), device="cpu",
               **s["form_kwargs"])
    tc = convert.carry_from_numpy(c["init"], "cpu")
    targets = torch.tensor(gold["targets"])
    step = T.batched_step(tm)
    assert len(c["ticks"]) == s["ticks"] == 3
    for k, tick in enumerate(c["ticks"]):
        tc, ts = step(tc, torch.tensor(np.float32(k * s["dt_min"])), targets)
        ref = _Ref(tick)
        _check_tick(k, ref, ref.stats, tc, ts)
    return tm, c


@pytest.mark.parametrize("case", list(CASES))
def test_rollout_matches_jax_fixture(case):
    tm, c = _replay_fixture(case)
    if "retract" in c:
        _check_retract(tm, c["retract"])
    else:  # include_acc=False decodes no acceleration, in both packages
        assert tm.form.decode(
            tm.x_nom()[None], torch.zeros(1, tm.form.ndx),
            torch.zeros(1, tm.form.nu))["a"] is None


@pytest.mark.parametrize("name", ["rnea_noacc", "acc_nobase", "euler"])
def test_b2g_variant_fixture_replays_plain_path(name):
    """The B2G N=14 fixture of chip_smoke.py's phase for this variant
    (batch 2, 5 ticks) on the plain path, at the bounds that phase
    applies on the card."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    path = chip_smoke.VARIANT_FIXTURES[name]
    gx, _, grel, ticks, batch = chip_smoke.replay_golden(
        torch.device("cpu"), "cholinv_pb", path)
    tol = chip_smoke.golden_tolerances(convert.load_golden(path))
    assert (ticks, batch) == (5, 2)
    assert gx <= tol[0] and grel <= tol[3]


@pytest.mark.slow
@pytest.mark.parametrize("case", list(CASES))
def test_rollout_matches_live_jax(case):
    """The fixture's rollout against a live JAX tick (compiles for a
    minute or more per case on a CPU)."""
    from tpu_locoman import parallel as jpar

    robot_kw, dyn, form_kw = CASES[case]
    jrob = J.Go2(**robot_kw)
    jrob.set_gait_sequence("trot", 0.8)
    jm = J.MPC(jrob, dynamics=dyn, nodes=3, config=_hot(J, "cholinv"),
               **form_kw)
    trob = T.Go2(**robot_kw)
    trob.set_gait_sequence("trot", 0.8)
    tm = T.MPC(trob, dynamics=dyn, nodes=3, config=_hot(T, "cholinv_pb"),
               device="cpu", **form_kw)
    targets = np.asarray([[0.2, 0, 0, 0, 0, 0], [0.1, 0, 0, 0, 0, 0.2]],
                         np.float32)
    jc = jpar.batched_init(jm, 2)
    tc = convert.carry_from_numpy(jax.device_get(jc), "cpu")
    jstep = jpar.batched_step(jm, donate=False)
    tstep = T.batched_step(tm)
    for k in range(3):
        t = np.float32(k * 0.01)
        jc, js = jstep(jc, jnp.float32(t), jnp.asarray(targets))
        tc, ts = tstep(tc, torch.tensor(t), torch.tensor(targets))
        _check_tick(k, jc, js, tc, ts)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    _record_linearize()
