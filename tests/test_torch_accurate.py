"""Accurate mode in the port against tpu_locoman: ``eq_project``,
``kkt_polish``, the equality-polish phase of ``admm_solve``, the BABE
factorizer, and the accurate single-robot path end to end.

The inputs are made with numpy from a seed and go through both packages on
the CPU, where the port's kernel wrappers run their plain versions (K3's is
the recursion of ``factorize(chol_impl="cholinv")``). Each tolerance is
stated beside the gap measured on the CPU. The accurate rollout's JAX
ticks are recorded in tests/data/torch_accurate_rollout_jax.npz
(``JAX_PLATFORMS=cpu python tests/test_torch_accurate.py`` rewrites
it)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import tpu_locoman as J  # noqa: E402
from tpu_locoman import parallel as jpar  # noqa: E402
from tpu_locoman.solver import qp as jqp  # noqa: E402
from tpu_locoman.solver import sqp as jsqp  # noqa: E402
import tpu_locoman_torch as T  # noqa: E402
from tpu_locoman_torch import convert  # noqa: E402
from tpu_locoman_torch.solver import fac_whole  # noqa: E402
from tpu_locoman_torch.solver import qp as tqp  # noqa: E402
from tpu_locoman_torch.solver import sqp as tsqp  # noqa: E402

# tpu_locoman's Go2 N=6 accurate rollout (_jax_accurate_rollout), written
# by running this file as a script
ACC_ROLLOUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                           "torch_accurate_rollout_jax.npz")


def _random_qps(Bs=2, N=5, m=12, ndx=8, nu=5, seed=0, c_eye=None):
    """Bs stage QPs shaped like tests/test_accurate.py:_random_qp (half
    equality rows, half loose inequalities). With c_eye=k, C is the
    propagation pattern (row r = e_r for r < k) that the port's ADMM
    assembly takes."""
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    G = f32(rng.normal(size=(Bs, N, m, ndx)) * 0.5)
    B = f32(rng.normal(size=(Bs, N, m, nu)) * 0.5)
    if c_eye is None:
        C = f32(rng.normal(size=(Bs, N, m, ndx)) * 0.5)
    else:
        C = np.zeros((Bs, N, m, ndx), np.float32)
        C[:, :, :c_eye, :c_eye] = np.eye(c_eye, dtype=np.float32)
    P = f32(rng.uniform(0.5, 2.0, size=(Bs, N + 1, ndx + nu)))
    q = f32(rng.normal(size=(Bs, N + 1, ndx + nu)))
    eq = f32(rng.normal(size=(Bs, N, m // 2)) * 0.1)
    l = np.concatenate([eq, np.full((Bs, N, m - m // 2), -10.0, np.float32)], 2)
    u = np.concatenate([eq, np.full((Bs, N, m - m // 2), 10.0, np.float32)], 2)
    return G, B, C, P, q, l, u, rng


def _t(*xs):
    return [torch.tensor(x) for x in xs]


def _close(out, ref, rel, err_msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref,
                               atol=rel * (np.abs(ref).max() + 1),
                               err_msg=err_msg)


def test_median_averages_the_middle_pair():
    """The trap at qp.py:986: jnp.median averages the two middle values of
    an even count, torch.median returns the lower one."""
    x = torch.tensor([[[4.0, 1.0], [3.0, 2.0]]])
    assert float(tqp._median(x)) == 2.5 == float(np.median(x.numpy()))
    assert float(torch.median(x.flatten())) == 2.0


@pytest.mark.parametrize("factorizer", ["pallas", "cholinv", "babe",
                                        "sequential", "cyclic"])
def test_eq_project_matches_jax(factorizer):
    """Port (each factorizer; "cyclic" factorizes "sequential" here, as in
    the reference) against JAX "cholinv", Bs=2, (N+1)*s = 78 even, so the
    clamp's median averages the middle pair. Measured gap: at most 1.1e-6
    of max|delta| for every factorizer; held at 1e-4*(max+1)."""
    G, B, C, P, q, l, u, rng = _random_qps()
    Bs, N, m, _ = G.shape
    assert ((N + 1) * P.shape[-1]) % 2 == 0
    W = (rng.uniform(size=(Bs, N, m)) < 0.7).astype(np.float32)
    resid = (rng.normal(size=(Bs, N, m)) * 0.1).astype(np.float32)
    before = fac_whole.launches
    out = tqp.eq_project(*_t(G, B, C, P, resid, W), factorizer=factorizer)
    assert fac_whole.launches == before  # CPU tensors: the plain version
    for b in range(Bs):
        ref = jqp.eq_project(*(jnp.asarray(x[b]) for x in (G, B, C, P, resid,
                                                             W)),
                             factorizer="cholinv")
        _close(out[b].numpy(), ref, 1e-4, f"scenario {b}")
        # and the masked rows are met: A delta = resid where W = 1
        A = np.concatenate([G[b], B[b]], -1)
        D = np.concatenate([C[b], np.zeros_like(B[b])], -1)
        d = out[b].numpy()
        w = np.einsum("nms,ns->nm", A, d[:-1]) + np.einsum("nms,ns->nm", D,
                                                           d[1:])
        assert np.abs((w - resid[b]) * W[b]).max() < 1e-3


def test_kkt_polish_matches_jax():
    """The port's kkt_polish against JAX's, both factorizing with the panel
    Cholesky ("blocked"): the library's Cholesky and XLA's differ in f32
    summation order only. Measured gap at most 1.8e-6 of max|d| (with the
    port's earlier "cholinv" factorization: 1.2e-6); held at
    2e-5*(max+1)."""
    G, B, C, P, q, l, u, rng = _random_qps(seed=3)
    z = np.clip(rng.normal(size=l.shape) * 12, l, u).astype(np.float32)
    out = tqp.kkt_polish(*_t(G, B, C, P, q, l, u, z))
    for b in range(G.shape[0]):
        ref = jqp.kkt_polish(*(jnp.asarray(x[b]) for x in (G, B, C, P, q, l,
                                                             u, z)))
        _close(out[b].numpy(), ref, 2e-5, f"scenario {b}")


def _eq_residual(G, B, C, d, l, m_eq):
    A = np.concatenate([G, B], -1)
    D = np.concatenate([C, np.zeros_like(B)], -1)
    w = (np.einsum("bnms,bns->bnm", A, d[:, :-1])
         + np.einsum("bnms,bns->bnm", D, d[:, 1:]))
    return float(np.abs(w[..., :m_eq] - l[..., :m_eq]).max())


def test_admm_polish_phase_matches_jax():
    """admm_solve with polish_iters=12, polish_boost=30 (as
    test_accurate.py:test_polish_tightens_equalities), port against JAX on
    the propagation-pattern QP. The boosted rho (600 on the equality rows)
    makes the x-update sensitive to f32 roundoff: the port lands within
    5.1e-4 of JAX (max|x| 2.7), JAX "sequential" within 5.6e-4 of JAX
    "cholinv", and the port in f32 within 4.9e-4 of itself in f64. Held:
    1e-4*(max+1) without the polish, 5e-4*(max+1) with it. The polish must
    tighten the equalities as it does in JAX."""
    k = 6
    G, B, C, P, q, l, u, _ = _random_qps(c_eye=k)
    m_eq = l.shape[-1] // 2
    res = {}
    for name, cfg in (("base", dict(iters=12)),
                      ("pol", dict(iters=12, polish_iters=12,
                                   polish_boost=30.0))):
        d, z, y = tqp.admm_solve(*_t(G, B, C, P, q, l, u),
                                 T.ADMMConfig(factorizer="cholinv", **cfg),
                                 c_eye_rows=k)
        tol = 5e-4 if name == "pol" else 1e-4
        for b in range(G.shape[0]):
            ref = jqp.admm_solve(*(jnp.asarray(x[b]) for x in (G, B, C, P, q,
                                                                 l, u)),
                                 jqp.ADMMConfig(factorizer="cholinv", **cfg),
                                 c_eye_rows=k)
            for o, r, what in zip((d, z, y), ref, "dzy"):
                _close(o[b].numpy(), r, tol, f"{name} {what} {b}")
        res[name] = _eq_residual(G, B, C, d.numpy(), l, m_eq)
    assert res["pol"] < 0.2 * res["base"] and res["pol"] < 1e-3, res


@pytest.mark.parametrize("S_", [15, 16, 5])
def test_babe_matches_jax(S_):
    """factorize_babe + solve_babe, port ("babe" and "babe_pb", the latter's
    leaves through K1's plain version here) against JAX, odd and even node
    counts, full and skinny U (as test_qp.py:408-429). Measured gap at most
    3.1e-7 of the largest entry (factor and solve); held at
    1e-4*(max+1)."""
    rng = np.random.default_rng(11)
    Bs, s, k = 2, 9, 4
    H = rng.standard_normal((Bs, S_, s, s)).astype(np.float32)
    H = H @ np.swapaxes(H, -1, -2) + 10 * np.eye(s, dtype=np.float32)
    U = np.zeros((Bs, S_ - 1, s, s), np.float32)
    U[..., :k] = rng.standard_normal((Bs, S_ - 1, s, k))
    b = rng.standard_normal((Bs, S_, s)).astype(np.float32)
    for Uin in (U, U[..., :k]):
        refs = []
        for i in range(Bs):
            jf = jqp.factorize_babe(jnp.asarray(H[i]), jnp.asarray(Uin[i]))
            refs.append((jf, jqp.solve_babe(jf, jnp.asarray(b[i]))))
        for impl in ("cholinv", "cholinv_pb"):
            fac = tqp.factorize_babe(*_t(H, Uin), chol_impl=impl)
            x = tqp.solve_babe(fac, torch.tensor(b)).numpy()
            for i, (jf, jx) in enumerate(refs):
                for name in jqp.BabeFactor._fields:
                    _close(getattr(fac, name)[i].numpy(), getattr(jf, name),
                           1e-4, f"{name} S={S_} {impl}")
                _close(x[i], jx, 1e-4)


def test_babe_admm_matches_cholinv():
    """admm_solve with factorizer "babe" against "cholinv" in the port (as
    test_qp.py:431-449), and "pallas" likewise: the same QP solution."""
    k = 6
    G, B, C, P, q, l, u, _ = _random_qps(c_eye=k, seed=5)
    outs = {}
    for fz in ("cholinv", "babe", "babe_pb", "pallas"):
        cfg = T.ADMMConfig(iters=150, factorizer=fz)
        outs[fz] = tqp.admm_solve(*_t(G, B, C, P, q, l, u), cfg,
                                  c_eye_rows=k)[0].numpy()
    for fz in ("babe", "babe_pb", "pallas"):
        np.testing.assert_allclose(outs[fz], outs["cholinv"], rtol=1e-3,
                                   atol=1e-4, err_msg=fz)


def test_unported_options_still_raise():
    """What stays unported: bf16 storage of the matvec operator and of the
    factor (the port computes in float32 only). The factorizers
    "sequential" and "cyclic" and Ruiz scaling are in."""
    with pytest.raises(NotImplementedError, match="float32"):
        tqp._check_config(T.ADMMConfig(matvec_dtype="bfloat16"))
    with pytest.raises(NotImplementedError, match="float32"):
        tqp._check_config(T.ADMMConfig(factor_dtype="bfloat16"))
    for cfg in (T.ADMMConfig(factorizer="sequential"),
                T.ADMMConfig(factorizer="cyclic"),
                T.ADMMConfig(scaling_iters=2)):
        tqp._check_config(cfg)


def test_accurate_preset_matches_jax():
    """PRESETS["accurate"]() field by field against the JAX preset. The
    ADMM configs share every field the port has, except the default
    factorizer: "auto" in JAX (cholinv_pb on a TPU), "cholinv_pb" here."""
    ref, out = jsqp.PRESETS["accurate"](), tsqp.PRESETS["accurate"]()
    for f in tsqp.SQPConfig._fields:
        if f != "admm":
            assert getattr(out, f) == getattr(ref, f), f
    for f in tqp.ADMMConfig._fields:
        if f != "factorizer":
            assert getattr(out.admm, f) == getattr(ref.admm, f), f
    assert out.admm.factorizer == "cholinv_pb" and ref.admm.factorizer == "auto"
    robot = T.Go2()
    robot.set_gait_sequence("trot", 0.8)
    assert T.MPC(robot, nodes=3, config="accurate",
                 device="cpu").solver.cfg == out


def _accurate_configs(mod, factorizer):
    return mod.SQPConfig.accurate()._replace(
        admm=mod.ADMMConfig(iters=10, factorizer=factorizer))


ACC_TARGETS = np.array([[0.2, 0, 0, 0, 0, 0], [0.1, 0, 0, 0, 0, 0.2]],
                       np.float32)


def _jax_accurate_rollout(ticks=5):
    """tpu_locoman's Go2 N=6 accurate rollout ("cholinv"), batch 2: its
    initial carry and, per tick, x and the stats."""
    jrob = J.Go2()
    jrob.set_gait_sequence("trot", 0.8)
    jm = J.MPC(jrob, dynamics="whole_body_rnea", nodes=6,
               config=_accurate_configs(J, "cholinv"))
    jc = jpar.batched_init(jm, 2)
    c0 = convert.carry_to_numpy(convert.carry_from_numpy(
        jax.device_get(jc), "cpu"))
    out = {"init/" + k: v for k, v in (
        ("x_init", c0["x_init"]), ("tau_prev", c0["tau_prev"]),
        *c0["solver_state"].items())}
    jstep = jpar.batched_step(jm, donate=False)
    for k in range(ticks):
        jc, js = jstep(jc, jnp.float32(np.float32(k * 0.01)),
                       jnp.asarray(ACC_TARGETS))
        out[f"{k}/x"] = np.asarray(jc.x_init)
        out.update({f"{k}/{n}": np.asarray(js[n])
                    for n in ("max_violation", "alpha", "status")})
    return out


def _record_accurate_rollout():
    np.savez_compressed(ACC_ROLLOUT, **_jax_accurate_rollout())
    print("wrote", ACC_ROLLOUT)


def test_go2_accurate_rollout_matches_jax_tick_by_tick():
    """The slice end to end at a small size: Go2 whole_body_rnea N=6,
    SQPConfig.accurate() with the port's factorizer "pallas" (K3's plain
    version here) and JAX's "cholinv" (the same recurrence without the
    interpreter), batch 2 with distinct targets, 5 ticks, from JAX's
    initial carry; JAX's ticks are recorded in ACC_ROLLOUT (one accurate
    JAX tick compiles for over a minute on a CPU). s=78 and m_dense=86,
    so (N+1)*s = 546 is even and every eq_project hits the median trap.

    Measured gap on the CPU: x within 1.5e-4, max_violation within 1.1e-5
    absolute (JAX's own per-tick violations are 1.0e-5 to 2.7e-5). Held: x
    atol 1e-3; max_violation <= 1e-3 on both sides and within 1e-4
    absolute of JAX; alpha and status equal."""
    trob = T.Go2()
    trob.set_gait_sequence("trot", 0.8)
    tm = T.MPC(trob, dynamics="whole_body_rnea", nodes=6,
               config=_accurate_configs(T, "pallas"), device="cpu")
    assert tm.trans.s == 78 and tm.trans.m_dense == 86
    with np.load(ACC_ROLLOUT) as d:
        rec = {k: d[k] for k in d.files}
    tc = convert.carry_from_numpy(
        {"x_init": rec["init/x_init"], "tau_prev": rec["init/tau_prev"],
         "solver_state": {k: rec["init/" + k] for k in ("Z", "z_admm",
                                                         "y_admm")}}, "cpu")
    for k in range(5):
        t = np.float32(k * 0.01)
        tc, ts = tm.step(tc, torch.tensor(t), torch.tensor(ACC_TARGETS))
        np.testing.assert_allclose(tc.x_init.numpy(), rec[f"{k}/x"],
                                   atol=1e-3, err_msg=f"x, tick {k}")
        jv, tv = rec[f"{k}/max_violation"], ts["max_violation"].numpy()
        assert jv.max() <= 1e-3 and tv.max() <= 1e-3, (k, jv, tv)
        np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-4,
                                   err_msg=f"max_violation, tick {k}")
        np.testing.assert_array_equal(ts["alpha"].numpy(), rec[f"{k}/alpha"])
        np.testing.assert_array_equal(ts["status"].numpy(),
                                      rec[f"{k}/status"])

if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    _record_accurate_rollout()
