"""End-to-end: the port's batched MPC tick against tpu_locoman's, tick by
tick, from the same initial carry (carried across by convert.py).

Go2 whole_body_rnea N=6, the SHIPPING.json hot config (1 SQP iteration, 10
ADMM sweeps, corrector 5, 2 line-search trials, flip reset, warm shift)
with JAX factorizer "cholinv" (the math of "cholinv_pb" without the Pallas
interpreter), batch 2 with distinct targets, 5 ticks. The JAX ticks are
recorded in tests/data/torch_jax_rollouts.npz with JAX's initial carry
(``JAX_PLATFORMS=cpu python tests/test_torch_mpc.py`` rewrites it: each
JAX tick compiles for a minute or more on a CPU).

Measured gap on the CPU: x within 1.1e-5, max_violation within 4e-7
absolute. Tolerances: x atol 1e-3 and max_violation 5% relative + 1e-3
absolute (f32 summation order differs in every product; the violation is
the worst row at the ADMM iteration floor); alpha and status equal (the
line search's discrete decisions must not flip).

The B2G N=14 flagship is held against the JAX golden fixture
(tests/data/torch_golden_b2g_n14.json, written by
tools/make_torch_golden.py), and the accurate single-robot path against
tests/data/torch_golden_b2g_n14_accurate.json (``--accurate``);
chip_smoke.py replays both fixtures on the GPU."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import tpu_locoman as J  # noqa: E402
from tpu_locoman import parallel as jpar  # noqa: E402
import tpu_locoman_torch as T  # noqa: E402
from tpu_locoman_torch import convert  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _hot(mod, factorizer):
    return mod.SQPConfig(sqp_iters=1, n_trials=2, corrector_iters=5,
                         admm=mod.ADMMConfig(iters=10, factorizer=factorizer))


# the JAX side of every _rollout_pair rollout the tests run, by key:
# (robot, N, ticks, targets); written by running this file as a script
ROLLOUTS = os.path.join(ROOT, "tests", "data", "torch_jax_rollouts.npz")
RECORDED = {
    "go2_n6": ("Go2", 6, 5, [[0.2, 0, 0, 0, 0, 0], [0.1, 0, 0, 0, 0, 0.2]]),
    "b2g_n3": ("B2G", 3, 1, [[0.2, 0, 0, 0, 0, 0], [0.1, 0, 0, 0, 0, 0]]),
}
_STATS = ("max_violation", "alpha", "status")


def _jax_rollout(name, N, ticks, targets):
    """tpu_locoman's batched rollout on the hot config with "cholinv" (the
    math of "cholinv_pb" without the Pallas interpreter): its initial carry
    and, per tick, x and the stats (each JAX tick compiles for a minute or
    more on a CPU)."""
    jrob = getattr(J, name)()
    jrob.set_gait_sequence("trot", 0.8)
    jm = J.MPC(jrob, dynamics="whole_body_rnea", nodes=N, flip_reset=True,
               warm_shift=True, config=_hot(J, "cholinv"))
    targets = np.asarray(targets, np.float32)
    jc = jpar.batched_init(jm, targets.shape[0])
    c0 = convert.carry_to_numpy(convert.carry_from_numpy(
        jax.device_get(jc), "cpu"))
    out = {"init/" + k: v for k, v in (
        ("x_init", c0["x_init"]), ("tau_prev", c0["tau_prev"]),
        *c0["solver_state"].items())}
    jstep = jpar.batched_step(jm, donate=False)
    for k in range(ticks):
        jc, js = jstep(jc, jnp.float32(np.float32(k * 0.01)),
                       jnp.asarray(targets))
        out[f"{k}/x"] = np.asarray(jc.x_init)
        out.update({f"{k}/{n}": np.asarray(js[n]) for n in _STATS})
    return out


def _rollouts_recording():
    """_jax_rollout of every RECORDED case, as ROLLOUTS holds them."""
    return {f"{key}/{k}": v for key, case in RECORDED.items()
            for k, v in _jax_rollout(*case).items()}


def _record_rollouts():
    """Write ROLLOUTS."""
    np.savez_compressed(ROLLOUTS, **_rollouts_recording())
    print("wrote", ROLLOUTS)


class _Tick:
    """A recorded JAX tick in the shape _check_tick reads."""

    def __init__(self, rec, k):
        self.x_init = rec[f"{k}/x"]
        self.stats = {n: rec[f"{k}/{n}"] for n in _STATS}


def _rollout_pair(name, N, ticks, targets):
    """The port's batched rollout from tpu_locoman's initial carry, tick by
    tick beside the recorded JAX tick: yields (k, JAX tick, JAX stats,
    port carry, port stats)."""
    key = next(k for k, c in RECORDED.items() if c[:3] == (name, N, ticks))
    np.testing.assert_array_equal(targets,
                                  np.asarray(RECORDED[key][3], np.float32))
    with np.load(ROLLOUTS) as d:
        rec = {k[len(key) + 1:]: d[k] for k in d.files
               if k.startswith(key + "/")}
    trob = getattr(T, name)()
    trob.set_gait_sequence("trot", 0.8)
    tm = T.MPC(trob, dynamics="whole_body_rnea", nodes=N, flip_reset=True,
               warm_shift=True, config=_hot(T, "cholinv_pb"), device="cpu")
    tc = convert.carry_from_numpy(
        {"x_init": rec["init/x_init"], "tau_prev": rec["init/tau_prev"],
         "solver_state": {k: rec["init/" + k] for k in ("Z", "z_admm",
                                                         "y_admm")}}, "cpu")
    tstep = T.batched_step(tm)
    for k in range(ticks):
        t = np.float32(k * 0.01)
        tc, ts = tstep(tc, torch.tensor(t), torch.tensor(targets))
        ref = _Tick(rec, k)
        yield k, ref, ref.stats, tc, ts


def _check_tick(k, jc, js, tc, ts):
    np.testing.assert_allclose(tc.x_init.numpy(), np.asarray(jc.x_init),
                               atol=1e-3, err_msg=f"x, tick {k}")
    ref_v = np.asarray(js["max_violation"])
    np.testing.assert_allclose(ts["max_violation"].numpy(), ref_v,
                               rtol=0.05, atol=1e-3,
                               err_msg=f"max_violation, tick {k}")
    np.testing.assert_array_equal(ts["alpha"].numpy(), np.asarray(js["alpha"]))
    np.testing.assert_array_equal(ts["status"].numpy(),
                                  np.asarray(js["status"]))


def test_go2_rollout_matches_jax_tick_by_tick():
    targets = np.array([[0.2, 0, 0, 0, 0, 0], [0.1, 0, 0, 0, 0, 0.2]],
                       np.float32)
    n = 0
    for k, jc, js, tc, ts in _rollout_pair("Go2", 6, 5, targets):
        _check_tick(k, jc, js, tc, ts)
        n += 1
    assert n == 5


def test_golden_flagship_replay_plain_path():
    """The B2G N=14 flagship (batch 2, 5 ticks) with the port's plain
    kernel versions against the JAX golden fixture, at the tolerances
    chip_smoke.py states and applies on the GPU (replay_golden)."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    gx, gv, grel, ticks, batch = chip_smoke.replay_golden(
        torch.device("cpu"), "cholinv_pb")
    assert (ticks, batch) == (5, 2)
    assert gx <= 1e-3 and grel <= 0.1


def test_golden_fixture_setup():
    gold = convert.load_golden(os.path.join(
        ROOT, "tests", "data", "torch_golden_b2g_n14.json"))
    s = gold["setup"]
    assert (s["robot"], s["nodes"], s["dynamics"]) == ("B2G", 14,
                                                      "whole_body_rnea")
    assert gold["init"]["solver_state"]["Z"].shape == (2, 15, 105)
    assert len(gold["ticks"]) == s["ticks"] == 5
    for tick in gold["ticks"]:
        assert np.all(np.isfinite(tick["x"])) and tick["x"].shape == (2, 49)


def test_golden_accurate_fixture_setup():
    """The accurate-mode fixture (tools/make_torch_golden.py --accurate):
    B2G N=14, SQPConfig.accurate() with JAX "cholinv", batch 1, 5 ticks,
    every tick at the accurate preset's gate."""
    gold = convert.load_golden(os.path.join(
        ROOT, "tests", "data", "torch_golden_b2g_n14_accurate.json"))
    s = gold["setup"]
    assert (s["robot"], s["nodes"], s["eq_projection"], s["corrector"],
            s["ls_trials"], s["factorizer"]) == ("B2G", 14, 4, 0, 8, "cholinv")
    assert gold["init"]["solver_state"]["Z"].shape == (1, 15, 105)
    assert len(gold["ticks"]) == s["ticks"] == 5
    for tick in gold["ticks"]:
        assert tick["x"].shape == (1, 49) and np.all(np.isfinite(tick["x"]))
        assert np.all(tick["max_violation"] <= 1e-3)


@pytest.mark.slow
def test_golden_accurate_replay_plain_path():
    """The accurate single-robot path (B2G N=14, batch 1, 5 ticks) with the
    port's factorizer "pallas" (K3's plain version here) against the
    accurate JAX golden fixture, at the tolerances chip_smoke.py states
    and applies on the GPU (replay_golden). Slow: five B2G N=14 ticks with
    four equality projections each, ~10 s on the CPU."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    gx, gv, _, ticks, batch = chip_smoke.replay_golden(
        torch.device("cpu"), "pallas", chip_smoke.GOLDEN_ACC)
    assert (ticks, batch) == (5, 1)
    assert gx <= chip_smoke.ACC_X_TOL and gv <= chip_smoke.ACC_VIOL_TOL


@pytest.mark.slow
@pytest.mark.parametrize("factorizer", ["sequential", "babe"])
def test_golden_accurate_tolerances_hold_for_jax_itself(factorizer):
    """The accurate fixture's own f32 spread: JAX with another factorizer
    (same math, other summation order) against the fixture (JAX
    "cholinv"). Measured on the CPU: x within 1.7e-3 ("sequential") and
    7.8e-4 ("babe"), max_violation within 7.6e-5 and 1.1e-4 per tick;
    chip_smoke.py's accurate tolerances must hold for it too. Slow: a B2G
    N=14 accurate jit, ~1.5 min each."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    gold = convert.load_golden(chip_smoke.GOLDEN_ACC)
    s = gold["setup"]
    robot = J.B2G()
    robot.set_gait_sequence(s["gait"], s["gait_period"])
    mpc = J.MPC(robot, dynamics=s["dynamics"], nodes=s["nodes"],
                config=J.SQPConfig.accurate()._replace(
                    admm=J.ADMMConfig(iters=s["admm_iters"],
                                      factorizer=factorizer)))
    carry = jpar.batched_init(mpc, 1)
    step = jpar.batched_step(mpc, donate=False)
    for k, ref in enumerate(gold["ticks"]):
        carry, st = step(carry, jnp.float32(k * s["dt_min"]),
                         jnp.asarray(gold["targets"]))
        np.testing.assert_allclose(np.asarray(carry.x_init), ref["x"],
                                   atol=chip_smoke.ACC_X_TOL)
        np.testing.assert_allclose(np.asarray(st["max_violation"]),
                                   ref["max_violation"], rtol=0,
                                   atol=chip_smoke.ACC_VIOL_TOL)


@pytest.mark.slow
def test_golden_fixture_reproduces_from_jax():
    """Regenerate the fixture's first two ticks with JAX on the CPU (a
    flagship jit: minutes) and check the committed file is current."""
    gold = convert.load_golden(os.path.join(
        ROOT, "tests", "data", "torch_golden_b2g_n14.json"))
    s = gold["setup"]
    robot = J.B2G()
    robot.set_gait_sequence(s["gait"], s["gait_period"])
    mpc = J.MPC(robot, dynamics=s["dynamics"], nodes=s["nodes"],
                flip_reset=s["flip_reset"], warm_shift=s["warm_shift"],
                config=_hot(J, s["factorizer"]))
    carry = jpar.batched_init(mpc, 2)
    step = jpar.batched_step(mpc, donate=False)
    for k in range(2):
        carry, st = step(carry, jnp.float32(k * s["dt_min"]),
                         jnp.asarray(gold["targets"]))
        np.testing.assert_allclose(np.asarray(carry.x_init),
                                   gold["ticks"][k]["x"], atol=1e-6)


def test_batched_equals_single():
    """Scenario batching: each scenario of a batch-2 tick equals the same
    scenario ticked alone (the port's counterpart of test_parallel)."""
    trob = T.Go2()
    trob.set_gait_sequence("trot", 0.8)
    tm = T.MPC(trob, nodes=4, config=_hot(T, "cholinv_pb"), device="cpu")
    targets = torch.tensor([[0.2, 0, 0, 0, 0, 0], [0.0, 0.1, 0, 0, 0, 0]])
    cb, sb = tm.step(T.batched_init(tm, 2), 0.05, targets)
    for i in range(2):
        c1, s1 = tm.step(T.batched_init(tm, 1), 0.05, targets[i:i + 1])
        np.testing.assert_allclose(cb.x_init[i].numpy(), c1.x_init[0].numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(sb["max_violation"][i].numpy(),
                                   s1["max_violation"][0].numpy(),
                                   rtol=1e-3, atol=1e-5)


def test_carry_round_trip():
    """convert.py carries the JAX MPC state to the port and back exactly."""
    jrob = J.Go2()
    jrob.set_gait_sequence("trot", 0.8)
    jm = J.MPC(jrob, dynamics="whole_body_rnea", nodes=4)
    jc = jax.device_get(jpar.batched_init(jm, 3))
    back = convert.carry_to_numpy(convert.carry_from_numpy(jc, "cpu"))
    np.testing.assert_array_equal(back["x_init"], np.asarray(jc.x_init))
    np.testing.assert_array_equal(back["tau_prev"], np.asarray(jc.tau_prev))
    for k in ("Z", "z_admm", "y_admm"):
        np.testing.assert_array_equal(back["solver_state"][k],
                                      np.asarray(getattr(jc.solver_state, k)))


def _mixed_gait_stage_params(jm, t):
    """Per-scenario JAX StageParams at time t for a trot (the robot's own
    schedule) and GaitSequence("walk", 0.6), as tests/test_parallel.py mixes
    them; returns [trot, walk] as numpy NamedTuples."""
    from tpu_locoman.gait import GaitSequence

    trot = jm.make_stage_params(jnp.float32(t))
    c, s = GaitSequence("walk", 0.6).get_gait_schedule(jnp.float32(t), jm.dts)
    walk = trot._replace(contact=c.T, swing=s.T)
    return [jax.device_get(trot), jax.device_get(walk)]


def _stack_sp(sps):
    return convert.stage_params_from_numpy(
        {k: np.stack([getattr(sp, k) for sp in sps])
         for k in sps[0]._fields}, "cpu")


def test_step_stage_params_mixed_gaits_match_jax():
    """MPC.step(stage_params=..., prev_stage_params=...) on Go2 N=6, a batch
    of two that mixes a trot and a walk: the port runs both as one batch,
    JAX each scenario alone through one jitted step (the vmapped step is
    the same math per scenario). x and max_violation after one tick at
    _check_tick's tolerances; the flip reset reads prev_stage_params. One
    SQP iteration without corrector and with one line-search trial keeps
    the one JAX compile near 25 s."""
    def cfg(mod, factorizer):
        return mod.SQPConfig(sqp_iters=1, n_trials=1, corrector_iters=0,
                             admm=mod.ADMMConfig(iters=10,
                                                 factorizer=factorizer))

    jrob, trob = J.Go2(), T.Go2()
    jrob.set_gait_sequence("trot", 0.8)
    trob.set_gait_sequence("trot", 0.8)
    jm = J.MPC(jrob, dynamics="whole_body_rnea", nodes=6, flip_reset=True,
               warm_shift=True, config=cfg(J, "cholinv"))
    tm = T.MPC(trob, dynamics="whole_body_rnea", nodes=6, flip_reset=True,
               warm_shift=True, config=cfg(T, "cholinv_pb"), device="cpu")
    t = 0.32
    sps = _mixed_gait_stage_params(jm, t)
    prev = _mixed_gait_stage_params(jm, t - jm.dt_min)
    flips = [np.any(s.contact != p.contact, axis=1) for s, p in zip(sps, prev)]
    assert all(f.any() for f in flips)  # the reset acts in both scenarios
    target = np.array([0.2, 0, 0, 0, 0, 0], np.float32)
    jc = jax.device_get(jpar.batched_init(jm, 2))
    # seeded acceleration slots, so that zeroing them at a flip shows
    ndx, na = jm.form.ndx, jm.form.na_opt
    Z = np.array(jc.solver_state.Z)
    Z[:, :, ndx:ndx + na] = np.random.default_rng(6).standard_normal(
        Z[:, :, ndx:ndx + na].shape).astype(np.float32)
    jc = jc._replace(solver_state=jc.solver_state._replace(Z=Z))
    jstep = jax.jit(lambda c, sp, psp: jm.step(
        c, jnp.float32(t), jnp.asarray(target), stage_params=sp,
        prev_stage_params=psp))
    ref_x, ref_v = [], []
    for i in range(2):
        ci = jax.tree.map(lambda x: x[i], jc)
        cn, st = jstep(ci, sps[i], prev[i])
        ref_x.append(np.asarray(cn.x_init))
        ref_v.append(float(st["max_violation"]))
    tc = convert.carry_from_numpy(jc, "cpu")
    tt = torch.tensor(target).expand(2, -1)
    out, ts = tm.step(tc, torch.tensor(np.float32(t)), tt,
                      stage_params=_stack_sp(sps),
                      prev_stage_params=_stack_sp(prev))
    np.testing.assert_allclose(out.x_init.numpy(), np.stack(ref_x), atol=1e-3)
    np.testing.assert_allclose(ts["max_violation"].numpy(), np.array(ref_v),
                               rtol=0.05, atol=1e-3)
    assert not np.allclose(ref_x[0], ref_x[1], atol=1e-6)  # gaits differ
    # stage_params without prev_stage_params skips the reset, as the
    # reference does: the same tick as one whose previous contact never
    # flipped
    a, _ = tm.step(tc, t, tt, stage_params=_stack_sp(sps))
    b, _ = tm.step(tc, t, tt, stage_params=_stack_sp(sps),
                   prev_stage_params=_stack_sp(sps))
    torch.testing.assert_close(a.x_init, b.x_init, rtol=0, atol=0)
    assert not torch.equal(a.x_init, out.x_init)


@pytest.mark.parametrize("field", ["precision", "assemble_precision"])
def test_admm_config_precision_fields(field):
    """The reference's precision fields: "highest" is accepted (bench.py
    passes both); anything else raises, by the port's f32-only rule."""
    cfg = T.ADMMConfig(precision="highest", assemble_precision="highest")
    assert (cfg.precision, cfg.assemble_precision) == ("highest", "highest")
    for bad in ("high", "default", "BF16_BF16_F32_X3"):
        with pytest.raises(ValueError, match="float32 only"):
            T.ADMMConfig(**{field: bad})
    from tpu_locoman_torch.solver import qp as tqp
    with pytest.raises(ValueError, match="float32 only"):
        tqp._check_config(cfg._replace(**{field: "high"}))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    _record_rollouts()
