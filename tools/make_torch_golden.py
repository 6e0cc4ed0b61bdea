"""Write the JAX golden fixtures that the PyTorch port is replayed against.

Runs the JAX tick on the CPU — B2G + Z1 arm, whole_body_rnea, trot 0.8 s,
N=14, flip reset, warm shift, factorizer "cholinv" — over 5 ticks, and
writes the setup, the initial carry, and per tick x, max_violation, alpha
and status:

- default: the hot config (1 SQP iteration, 10 ADMM sweeps, corrector 5,
  2 line-search trials), batch 2 (target vx 0.2 and 0.1), to
  tests/data/torch_golden_b2g_n14.json;
- ``--accurate``: ``SQPConfig.accurate()`` (1 SQP iteration, 10 ADMM
  sweeps, 4 equality-projection passes, no corrector, 8 line-search
  trials), batch 1 (target vx 0.2), to
  tests/data/torch_golden_b2g_n14_accurate.json;
- ``--dynamics whole_body_aba``: the hot config and batch of the default,
  with the forward-dynamics formulation (no flip reset acts: it has no
  acceleration slots), to tests/data/torch_golden_b2g_n14_aba.json;
- ``--formulations``: short rollouts of the other formulations, for the
  CPU tests of the port (tests/test_torch_formulations_mpc.py): Go2 N=3,
  3 ticks, for each of whole_body_aba, whole_body_acc, centroidal_acc and
  centroidal_vel; B2G whole_body_aba N=3, 1 tick; and whole_body_rnea with
  flip_reset="aba", Go2 N=6, 5 ticks. Each on the hot config with
  "cholinv", batch 2 (target vx 0.2 and (0.1, yaw rate 0.2)), with the
  per-tick results and ``MPC.retract`` of scenario 0's last solution, to
  tests/data/torch_golden_formulations.json;
- ``--case sequential``: the hot config with the factorizer "sequential"
  (bench.py's in-code default and the battery's 01_default), batch 2, to
  tests/data/torch_golden_b2g_n14_seq.json;
- ``--case scaled``: examples/run_mpc.py's defaults (2 SQP iterations of
  100 ADMM sweeps, no corrector, 8 line-search trials) with Ruiz scaling
  (scaling_iters=3) and "cholinv", batch 2, 4 ticks, to
  tests/data/torch_golden_b2g_n14_scaled.json;
- ``--case b2``: B2 with the front payload on the hot config with
  "cholinv", batch 2, to tests/data/torch_golden_b2_front_n14.json;
- ``--case rnea_noacc|acc_nobase|euler``: the formulation variants on the
  hot config with "cholinv", batch 2: whole_body_rnea(include_acc=False),
  whole_body_acc(include_base=False) and B2G(use_quaternion=False)
  whole_body_rnea, to tests/data/torch_golden_b2g_n14_NAME.json (their
  surveys over 7 ticks: chip_smoke.py's 2 warm-up and 5 timed);
- ``--variants``: short rollouts of the variants for the CPU tests
  (tests/test_torch_variants.py): Go2 N=3, 3 ticks, batch 2, the four
  whole-stage variants (include_base=False for centroidal_vel,
  centroidal_acc and whole_body_acc; whole_body_rnea with
  include_acc=False) and the Euler base with whole_body_rnea and
  centroidal_acc, with ``MPC.retract`` of scenario 0's last solution where
  the JAX package has one, to tests/data/torch_golden_variants.json;
- ``--parity-go2``: a parity ABI v1 dump of the JAX package
  (tools/parity_check.make_dump, Go2 N=6, hot, 5 ticks) to
  tests/data/torch_parity_go2_n6_hot.json, with the same dump made with
  "cholinv" and "babe" diffed against it, and their largest errors per
  quantity (the spread), under "meta";
- ``--parity-spread T`` (T = 4, see PARITY_B2G_AGAINST): JAX's accurate
  rollouts of tools/golden_b2g_rnea_n14.json's configuration with
  "sequential" and "cholinv" over T ticks, held open loop to that dump's
  states and each diffed against it, with the largest error per
  quantity, to
  tests/data/torch_parity_b2g_n14.json, with "cholinv" diffed against
  "sequential" too, and the "sequential" dump itself to
  tests/data/torch_parity_b2g_n14_jax_seq.json (the bounds and the second
  reference of chip_smoke.py's parity phase);
- ``--agreement NAME``: JAX against itself at batch 8 (targets vx 0 to
  0.3) over a few ticks, for the agreement bounds of chip_smoke.py's new
  phases: "flagship" ("sequential" against "cholinv", N=14, 3 ticks) and
  "n30" ("cyclic" against "sequential", N=30, 3 ticks); written under NAME
  in tests/data/torch_spreads.json.

With ``--case``, ``--against`` also records its result in the fixture's
"spread" (which the replays' bounds are set from), and
``--violation-survey`` records its result under "survey_" + the case in
tests/data/torch_spreads.json (the yardstick of chip_smoke.py's gates).

Two checks that write nothing, for setting a replay's bounds and gates:

- ``--against`` replays the fixture with JAX itself at the factorizer
  AGAINST ("sequential": the same math in another f32 summation order)
  and prints the largest x error, the largest per-tick max_violation
  error (absolute and relative) and the rollout mean's relative error —
  how far JAX lands from itself;
- ``--violation-survey`` runs the fixture's configuration at batch
  SURVEY_BATCH, target vx 0.2 for every scenario, for SURVEY_TICKS ticks,
  and prints the batch-mean max_violation per tick and its mean over the
  ticks after the first two (the chip run's warm-up).

The machine with the GPU has no JAX, so these fixtures are how a run there
is held against the reference (chip_smoke.py replays the B2G N=14 ones; so
do CPU tests, tests/test_torch_mpc.py and
tests/test_torch_formulations_mpc.py). Arrays are stored as base64 of their
float32/int32 bytes; tpu_locoman_torch.convert.load_golden reads them.

    JAX_PLATFORMS=cpu python tools/make_torch_golden.py [--accurate]
        [--dynamics whole_body_aba]
        [--case sequential|scaled|b2|rnea_noacc|acc_nobase|euler]
        [--formulations] [--variants] [--against] [--violation-survey]
        [--parity-go2] [--parity-spread T] [--agreement flagship|n30]
"""

import argparse
import base64
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")

SETUP = {
    "robot": "B2G", "dynamics": "whole_body_rnea", "gait": "trot",
    "gait_period": 0.8, "nodes": 14, "sqp_iters": 1, "admm_iters": 10,
    "corrector": 5, "ls_trials": 2, "flip_reset": True, "warm_shift": True,
    "factorizer": "cholinv", "targets_vx": [0.2, 0.1], "ticks": 5,
    "dt_min": 0.01,
}
# SQPConfig.accurate() with the factorizer named, for one robot
ACCURATE = dict(SETUP, corrector=0, ls_trials=8, eq_projection=4,
                targets_vx=[0.2])
# the forward-dynamics formulation on the hot config
ABA = dict(SETUP, dynamics="whole_body_aba")
# --case: (setup, fixture file name, the violation survey's ticks)
CASES = {
    "sequential": (dict(SETUP, factorizer="sequential"),
                   "torch_golden_b2g_n14_seq.json", 12),
    "scaled": (dict(SETUP, sqp_iters=2, admm_iters=100, corrector=0,
                    ls_trials=8, scaling_iters=3, ticks=4),
               "torch_golden_b2g_n14_scaled.json", 5),
    "b2": (dict(SETUP, robot="B2", robot_kwargs={"payload": "front"}),
           "torch_golden_b2_front_n14.json", 12),
    # the formulation variants, surveyed over chip_smoke.py's ticks of
    # them (2 warm-up and 5 timed)
    "rnea_noacc": (dict(SETUP, form_kwargs={"include_acc": False}),
                   "torch_golden_b2g_n14_rnea_noacc.json", 7),
    "acc_nobase": (dict(SETUP, dynamics="whole_body_acc",
                        form_kwargs={"include_base": False}),
                   "torch_golden_b2g_n14_acc_nobase.json", 7),
    "euler": (dict(SETUP, robot_kwargs={"use_quaternion": False}),
              "torch_golden_b2g_n14_euler.json", 7),
}
SPREADS = os.path.join(DATA, "torch_spreads.json")
# --agreement: (setup, factorizer, against, ticks)
AGREEMENT = {
    "flagship": (dict(SETUP, factorizer="sequential"), "cholinv", 3),
    "n30": (dict(SETUP, nodes=30, factorizer="cyclic"), "sequential", 3),
}
PARITY_GO2 = os.path.join(DATA, "torch_parity_go2_n6_hot.json")
# the factorizers whose dumps set the Go2 dump's spread: the two besides its
# own that take the accurate path's products in another order ("cyclic",
# whose explicit block inverses depart from the others, is left out)
PARITY_GO2_AGAINST = ("cholinv", "babe")
PARITY_B2G = os.path.join(DATA, "torch_parity_b2g_n14.json")
PARITY_B2G_JAX = os.path.join(DATA, "torch_parity_b2g_n14_jax_seq.json")
# the JAX factorizers whose distance from the golden dump sets the parity
# bounds. The rollouts are held open loop (every tick solves from the golden
# dump's state). From tick 4 on, a tick's 6 SQP iterations may take another
# line-search step under another f32 summation order, and x after the tick
# then lands 5-7e-3 from the other runs; before it every run agrees within
# 1.5e-4. So the phase takes T = 4 ticks (--parity-spread 4).
PARITY_B2G_AGAINST = ("sequential", "cholinv")
GOLDEN_DUMP = os.path.join(ROOT, "tools", "golden_b2g_rnea_n14.json")
# --formulations: (case, robot, dynamics, nodes, ticks, flip_reset)
FORM_CASES = [
    ("go2_aba", "Go2", "whole_body_aba", 3, 3, True),
    ("go2_acc", "Go2", "whole_body_acc", 3, 3, True),
    ("go2_cacc", "Go2", "centroidal_acc", 3, 3, True),
    ("go2_cvel", "Go2", "centroidal_vel", 3, 3, True),
    ("b2g_aba", "B2G", "whole_body_aba", 3, 1, True),
    ("go2_rnea_flip_aba", "Go2", "whole_body_rnea", 6, 5, "aba"),
]
FORM_TARGETS = [[0.2, 0, 0, 0, 0, 0], [0.1, 0, 0, 0, 0, 0.2]]
# --variants: (case, robot keyword arguments, dynamics, formulation keyword
# arguments), Go2 N=3, 3 ticks each
VARIANT_CASES = [
    ("go2_rnea_noacc", {}, "whole_body_rnea", {"include_acc": False}),
    ("go2_acc_nobase", {}, "whole_body_acc", {"include_base": False}),
    ("go2_cacc_nobase", {}, "centroidal_acc", {"include_base": False}),
    ("go2_cvel_nobase", {}, "centroidal_vel", {"include_base": False}),
    ("go2_euler_rnea", {"use_quaternion": False}, "whole_body_rnea", {}),
    ("go2_euler_cacc", {"use_quaternion": False}, "centroidal_acc", {}),
]
# --against: the factorizer JAX is held against itself with
AGAINST = "sequential"
# --violation-survey: a small batch, over the ticks of chip_smoke.py's
# whole_body_aba phase (2 warm and 10 timed)
SURVEY_BATCH = 8
SURVEY_TICKS = 12


def pack(x):
    x = np.ascontiguousarray(x)
    return {"dtype": str(x.dtype), "shape": list(x.shape),
            "b64": base64.b64encode(x.tobytes()).decode()}


def fixture_path(accurate, dynamics):
    if accurate:
        return os.path.join(DATA, "torch_golden_b2g_n14_accurate.json")
    if dynamics == "whole_body_aba":
        return os.path.join(DATA, "torch_golden_b2g_n14_aba.json")
    return os.path.join(DATA, "torch_golden_b2g_n14.json")


def make_mpc(s, factorizer=None):
    import tpu_locoman
    from tpu_locoman import MPC, ADMMConfig, SQPConfig

    robot = getattr(tpu_locoman, s["robot"])(**s.get("robot_kwargs", {}))
    robot.set_gait_sequence(s["gait"], s["gait_period"])
    return MPC(robot, dynamics=s["dynamics"], nodes=s["nodes"],
               flip_reset=s["flip_reset"], warm_shift=s["warm_shift"],
               **s.get("form_kwargs", {}),
               config=SQPConfig(sqp_iters=s["sqp_iters"],
                                n_trials=s["ls_trials"],
                                corrector_iters=s["corrector"],
                                eq_projection=s.get("eq_projection", 0),
                                admm=ADMMConfig(
                                    iters=s["admm_iters"],
                                    scaling_iters=s.get("scaling_iters", 0),
                                    factorizer=factorizer or s["factorizer"])))


def rollout(mpc, carry, targets, ticks, dt_min):
    """Yield (tick, carry, stats as numpy) over the ticks."""
    import jax
    import jax.numpy as jnp

    from tpu_locoman.parallel import batched_step

    step = batched_step(mpc, donate=False)
    for k in range(ticks):
        carry, stats = step(carry, jnp.float32(k * dt_min),
                            jnp.asarray(targets))
        yield k, carry, jax.device_get(stats)


def against(path, factorizer=None, record=False):
    """JAX at another factorizer (AGAINST, or "cholinv" for a "sequential"
    fixture) against the fixture at ``path``; with ``record``, the result
    goes into the fixture's "spread"."""
    import jax

    from tpu_locoman_torch.convert import load_golden

    gold = load_golden(path)
    s = gold["setup"]
    if factorizer is None:
        factorizer = "cholinv" if s["factorizer"] == AGAINST else AGAINST
    mpc = make_mpc(s, factorizer)
    carry = _carry(gold["init"])
    gx = gv = gr = 0.0
    vs, refs = [], []
    for k, carry, st in rollout(mpc, carry, gold["targets"], s["ticks"],
                                s["dt_min"]):
        ref = gold["ticks"][k]
        x = np.asarray(jax.device_get(carry.x_init))
        v = np.asarray(st["max_violation"])
        dv = np.abs(v - ref["max_violation"])
        gx = max(gx, float(np.abs(x - ref["x"]).max()))
        gv = max(gv, float(dv.max()))
        gr = max(gr, float((dv / np.abs(ref["max_violation"])).max()))
        vs.append(v)
        refs.append(ref["max_violation"])
        print(k, "x err", float(np.abs(x - ref["x"]).max()), "violation", v,
              "fixture", ref["max_violation"], flush=True)
    mean_rel = abs(float(np.mean(vs)) / float(np.mean(refs)) - 1.0)
    print(f"JAX {factorizer} against the fixture ({s['factorizer']}): x max "
          f"abs err {gx:.6g}, violation max abs err {gv:.6g}, max rel err "
          f"{gr:.6g}, rollout mean rel err {mean_rel:.6g}")
    if record:
        with open(path) as f:
            raw = json.load(f)
        raw["spread"] = {"factorizer": factorizer, "x": gx, "viol_abs": gv,
                         "viol_rel": gr, "mean_rel": mean_rel,
                         "by": "tools/make_torch_golden.py --against"}
        with open(path, "w") as f:
            json.dump(raw, f)
        print("recorded the spread in", path)


def violation_survey(s, batch=SURVEY_BATCH, ticks=SURVEY_TICKS):
    """Batch-mean max_violation per tick at batch ``batch``, target vx 0.2."""
    from tpu_locoman.parallel import batched_init

    mpc = make_mpc(s)
    targets = np.zeros((batch, 6), np.float32)
    targets[:, 0] = 0.2
    per_tick = []
    for k, _, st in rollout(mpc, batched_init(mpc, batch), targets, ticks,
                            s["dt_min"]):
        v = np.asarray(st["max_violation"])
        per_tick.append(float(v.mean()))
        print(k, "max_violation mean", per_tick[-1], "worst", float(v.max()),
              "status", np.asarray(st["status"]).tolist(), flush=True)
    warm = 2 if ticks > 5 else 0
    mean, worst = float(np.mean(per_tick[warm:])), max(per_tick[warm:])
    print(f"{s['dynamics']} batch {batch}: max_violation mean over ticks "
          f"{warm}..{ticks - 1} {mean:.6g}, worst tick {worst:.6g}")
    return {"batch": batch, "ticks": ticks, "from_tick": warm, "mean": mean,
            "worst": worst, "per_tick": per_tick}


def record_spread(name, entry):
    """Put ``entry`` under ``name`` in tests/data/torch_spreads.json."""
    spreads = {}
    if os.path.exists(SPREADS):
        with open(SPREADS) as f:
            spreads = json.load(f)
    spreads[name] = dict(entry, by="tools/make_torch_golden.py")
    with open(SPREADS, "w") as f:
        json.dump(spreads, f, indent=1, sort_keys=True)
    print("recorded", name, "in", SPREADS)


def agreement(name, batch=SURVEY_BATCH):
    """JAX with the case's factorizer against JAX with the other one at
    batch ``batch`` (targets vx 0 to 0.3, as chip_smoke.py's agreement
    checks), over the case's ticks: max |dx| and max |dZ| / (max|Z| + 1)."""
    import jax

    from tpu_locoman.parallel import batched_init

    s, other, ticks = AGREEMENT[name]
    targets = np.zeros((batch, 6), np.float32)
    targets[:, 0] = np.linspace(0.0, 0.3, batch)
    runs = []
    for fz in (s["factorizer"], other):
        mpc = make_mpc(s, fz)
        runs.append([(np.asarray(jax.device_get(c.x_init)),
                      np.asarray(jax.device_get(c.solver_state.Z)))
                     for _, c, _ in rollout(mpc, batched_init(mpc, batch),
                                            targets, ticks, s["dt_min"])])
    ex = max(float(np.abs(a[0] - b[0]).max()) for a, b in zip(*runs))
    ez = max(float(np.abs(a[1] - b[1]).max()) / (float(np.abs(b[1]).max())
                                                  + 1) for a, b in zip(*runs))
    print(f"{name}: JAX {s['factorizer']} against JAX {other}, batch {batch}, "
          f"{ticks} ticks: x {ex:.6g}, Z normalized {ez:.6g}")
    record_spread(name, {"factorizer": s["factorizer"], "against": other,
                         "nodes": s["nodes"], "batch": batch, "ticks": ticks,
                         "x": ex, "Z": ez})


def _jax_dump(out_path, factorizer=None, **kw):
    """tools/parity_check.make_dump, with every ADMMConfig it builds taking
    ``factorizer`` when one is given (its own default is "auto",
    "sequential" off the TPU)."""
    import functools

    import tpu_locoman

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import parity_check

    saved = tpu_locoman.ADMMConfig
    if factorizer is not None:
        tpu_locoman.ADMMConfig = functools.partial(saved,
                                                   factorizer=factorizer)
    try:
        parity_check.make_dump(out_path, **kw)
    finally:
        tpu_locoman.ADMMConfig = saved
    with open(out_path) as f:
        return json.load(f)


def parity_go2(tmp):
    """The Go2 N=6 hot JAX dump ("auto": "sequential" on the CPU), with the
    dumps of PARITY_GO2_AGAINST diffed against it and, per
    quantity, the largest of their max abs errors: the spread of JAX
    against itself."""
    from tpu_locoman_torch import parity

    kw = dict(ticks=5, hot=True, robot_name="go2", nodes=6)
    dump = _jax_dump(PARITY_GO2, **kw)
    against = {fz: parity.diff(_jax_dump(os.path.join(tmp, f"go2_{fz}.json"),
                                         fz, **kw), dump, warn=False)
               for fz in PARITY_GO2_AGAINST}
    dump["meta"] = {
        "by": "tools/make_torch_golden.py --parity-go2 "
              "(tools/parity_check.make_dump, factorizer auto)",
        "against_this": against,
        "spread": {k: max(d[k]["max_abs_err"] for d in against.values())
                   for k in against[PARITY_GO2_AGAINST[0]]}}
    with open(PARITY_GO2, "w") as f:
        json.dump(dump, f)
    print("wrote", PARITY_GO2, json.dumps(dump["meta"]["spread"], indent=1))


def _jax_open_loop(factorizer, golden, ticks):
    """tools/parity_check.make_dump's accurate B2G N=14 rollout of the JAX
    package with ``factorizer``, held open loop: every tick after the first
    solves from ``golden``'s state after the tick before. Returns the ABI
    v1 dump (as parity.make_dump(hold=golden) does in the port)."""
    import jax
    import jax.numpy as jnp

    from tpu_locoman import B2G, MPC, ADMMConfig, SQPConfig
    from tpu_locoman_torch import parity

    robot = B2G()
    robot.set_gait_sequence(parity.GAIT, parity.GAIT_PERIOD)
    cfg = SQPConfig(sqp_iters=6, eq_projection=2,
                    admm=ADMMConfig(iters=400, factorizer=factorizer))
    mpc = MPC(robot, dynamics=parity.DYNAMICS, nodes=14, config=cfg)
    bvd = jnp.asarray(parity.BASE_VEL_DES, dtype=jnp.float32)
    step = jax.jit(lambda c, t: mpc.step(c, t, bvd))
    carry = mpc.init_carry()
    rec = {"x": [], "max_violation": [],
           "node0": {k: [] for k in parity.QUANTITIES},
           "node1": {k: [] for k in parity.QUANTITIES}}
    for k in range(ticks):
        if k > 0:
            carry = carry._replace(x_init=jnp.asarray(golden["x"][k - 1],
                                                      dtype=jnp.float32))
        x_solve = carry.x_init
        carry, stats = step(carry, jnp.float32(k * mpc.dt_min))
        sol = mpc.retract(carry.solver_state.Z, x_solve, num_steps=2)
        rec["x"].append(np.asarray(carry.x_init, np.float64).tolist())
        rec["max_violation"].append(float(stats["max_violation"]))
        for node in (0, 1):
            for q in parity.QUANTITIES:
                rec[f"node{node}"][q].append(
                    np.asarray(sol[q][node], np.float64).tolist())
        print(factorizer, k, rec["max_violation"][-1], flush=True)
    return rec


def parity_spread(ticks):
    """JAX's accurate rollouts with each of PARITY_B2G_AGAINST over
    ``ticks`` ticks, held open loop to the committed golden dump: each
    diffed against it, and per quantity the largest of their max abs
    errors (the spread: the diff entry of the larger); "cholinv" diffed
    against "sequential" (the spread of JAX against its own dump); and
    that "sequential" dump, which the port's is also diffed against."""
    from tpu_locoman_torch import parity

    with open(GOLDEN_DUMP) as f:
        golden = json.load(f)
    by = f"tools/make_torch_golden.py --parity-spread {ticks}"
    out = {"ticks": ticks, "golden": "tools/golden_b2g_rnea_n14.json",
           "open_loop": True, "by": by, "variants": {}}
    dumps = {}
    for fz in PARITY_B2G_AGAINST:
        dumps[fz] = d = _jax_open_loop(fz, golden, ticks)
        out["variants"][fz] = {
            "diff": parity.diff(d, golden, ticks=ticks, warn=False),
            "max_violation": d["max_violation"]}
    diffs = [v["diff"] for v in out["variants"].values()]
    out["spread"] = {k: max((d[k] for d in diffs),
                            key=lambda e: e["max_abs_err"])
                     for k in diffs[0]}
    out["jax_spread"] = parity.diff(dumps["cholinv"], dumps["sequential"],
                                    warn=False)
    with open(PARITY_B2G, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    seq = dict(abi_version=1, config=dict(golden["config"], ticks=ticks),
               solver=golden["solver"],
               t=[k * golden["config"]["dt_min"] for k in range(ticks)],
               **dumps["sequential"],
               meta={"by": by, "factorizer": "sequential",
                     "held_to": "tools/golden_b2g_rnea_n14.json"})
    with open(PARITY_B2G_JAX, "w") as f:
        json.dump(seq, f)
    print("wrote", PARITY_B2G, "and", PARITY_B2G_JAX,
          json.dumps({"spread": out["spread"],
                      "jax_spread": out["jax_spread"]}, indent=1))


def short_rollouts(setups, name):
    """Write {case: {setup, init, ticks[, retract]}} of the setups (batch 2,
    FORM_TARGETS) to tests/data/NAME: the per-tick results and
    ``MPC.retract`` of scenario 0's last solution, where the JAX package
    has one (whole_body_rnea(include_acc=False) decodes no acceleration)."""
    import jax

    from tpu_locoman.parallel import batched_init

    out = {}
    targets = np.asarray(FORM_TARGETS, np.float32)
    for case, s in setups.items():
        mpc = make_mpc(s)
        carry = batched_init(mpc, len(targets))
        init = jax.device_get(carry)
        ticks = []
        for k, carry, st in rollout(mpc, carry, targets, s["ticks"],
                                    s["dt_min"]):
            ticks.append(_tick(carry, st))
            print(case, k, np.asarray(st["max_violation"]), flush=True)
        out[case] = {"setup": s, "init": _init(init), "ticks": ticks}
        if s.get("form_kwargs", {}).get("include_acc", True):
            Z, x0 = carry.solver_state.Z[0], carry.x_init[0]
            ret = jax.device_get(jax.jit(mpc.retract)(Z, x0))
            out[case]["retract"] = {
                "Z": pack(np.asarray(Z, np.float32)),
                "x_init": pack(np.asarray(x0, np.float32)),
                **{k: pack(np.asarray(v, np.float32)) for k, v in ret.items()}}
    out["targets"] = pack(targets)
    path = os.path.join(DATA, name)
    with open(path, "w") as f:
        json.dump(out, f)
    print("wrote", path, os.path.getsize(path), "bytes")


def formulations():
    """The --formulations fixture."""
    targets_vx = [t[0] for t in FORM_TARGETS]
    short_rollouts({
        case: dict(SETUP, robot=robot, dynamics=dyn, nodes=nodes,
                   ticks=n_ticks, flip_reset=flip, targets_vx=targets_vx)
        for case, robot, dyn, nodes, n_ticks, flip in FORM_CASES},
        "torch_golden_formulations.json")


def variants():
    """The --variants fixture: the formulation variants on Go2 N=3."""
    targets_vx = [t[0] for t in FORM_TARGETS]
    short_rollouts({
        case: dict(SETUP, robot="Go2", robot_kwargs=robot_kw, dynamics=dyn,
                   form_kwargs=form_kw, nodes=3, ticks=3,
                   targets_vx=targets_vx)
        for case, robot_kw, dyn, form_kw in VARIANT_CASES},
        "torch_golden_variants.json")


def _tick(carry, st):
    import jax

    return {
        "x": pack(np.asarray(jax.device_get(carry.x_init), np.float32)),
        "max_violation": pack(np.asarray(st["max_violation"], np.float32)),
        "alpha": pack(np.asarray(st["alpha"], np.float32)),
        "status": pack(np.asarray(st["status"], np.int32)),
    }


def _init(init):
    return {
        "x_init": pack(np.asarray(init.x_init, np.float32)),
        "solver_state": {k: pack(np.asarray(getattr(init.solver_state, k),
                                            np.float32))
                         for k in ("Z", "z_admm", "y_admm")},
        "tau_prev": pack(np.asarray(init.tau_prev, np.float32)),
    }


def _carry(init):
    import jax.numpy as jnp

    from tpu_locoman.mpc import MPCCarry
    from tpu_locoman.solver import SolverState

    st = init["solver_state"]
    return MPCCarry(x_init=jnp.asarray(init["x_init"]),
                    solver_state=SolverState(*(jnp.asarray(st[k]) for k in (
                        "Z", "z_admm", "y_admm"))),
                    tau_prev=jnp.asarray(init["tau_prev"]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--accurate", action="store_true",
                    help="write the accurate-mode fixture (batch 1)")
    ap.add_argument("--dynamics", default="whole_body_rnea",
                    choices=("whole_body_rnea", "whole_body_aba"),
                    help="formulation of the hot-config fixture")
    ap.add_argument("--case", choices=tuple(CASES),
                    help="write (or, with --against / --violation-survey, "
                         "check) one of the fixtures of the new paths")
    ap.add_argument("--parity-go2", action="store_true",
                    help="write the Go2 N=6 hot JAX parity dump")
    ap.add_argument("--parity-spread", type=int, metavar="T",
                    help="write JAX's accurate parity spread over T ticks")
    ap.add_argument("--agreement", choices=tuple(AGREEMENT),
                    help="record JAX against itself at batch 8")
    ap.add_argument("--formulations", action="store_true",
                    help="write the short rollouts of the other "
                         "formulations (Go2 and B2G, N=3 and 6)")
    ap.add_argument("--variants", action="store_true",
                    help="write the short rollouts of the formulation "
                         "variants (Go2 N=3)")
    ap.add_argument("--against", action="store_true",
                    help=f"replay the fixture with JAX at factorizer "
                         f"{AGAINST!r} (\"cholinv\" for a {AGAINST!r} "
                         f"fixture) and print the gaps; with --case, record "
                         f"them in the fixture")
    ap.add_argument("--violation-survey", action="store_true",
                    help=f"print the max_violation of the configuration at "
                         f"batch {SURVEY_BATCH}; with --case, record it in "
                         f"tests/data/torch_spreads.json")
    args = ap.parse_args()
    accurate = args.accurate
    out_path = fixture_path(accurate, args.dynamics)
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from tpu_locoman.parallel import batched_init

    s = ACCURATE if accurate else (ABA if args.dynamics == "whole_body_aba"
                                   else SETUP)
    if args.case:
        s, name, survey_ticks = CASES[args.case]
        out_path = os.path.join(DATA, name)
    if args.formulations:
        return formulations()
    if args.variants:
        return variants()
    if args.parity_go2:
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            parity_go2(tmp)
    if args.parity_spread:
        parity_spread(args.parity_spread)
    if args.parity_go2 or args.parity_spread:
        return None
    if args.agreement:
        return agreement(args.agreement)
    if args.against:
        return against(out_path, record=bool(args.case))
    if args.violation_survey:
        if args.case:
            return record_spread("survey_" + args.case,
                                 violation_survey(s, ticks=survey_ticks))
        return violation_survey(s)
    mpc = make_mpc(s)
    batch = len(s["targets_vx"])
    targets = np.zeros((batch, 6), np.float32)
    targets[:, 0] = s["targets_vx"]
    carry = batched_init(mpc, batch)
    init = jax.device_get(carry)
    ticks = []
    for k, carry, st in rollout(mpc, carry, targets, s["ticks"],
                                s["dt_min"]):
        ticks.append(_tick(carry, st))
        print(k, np.asarray(st["max_violation"]), flush=True)
    out = {"setup": s, "targets": pack(targets), "init": _init(init),
           "ticks": ticks}
    os.makedirs(DATA, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f)
    print("wrote", out_path, os.path.getsize(out_path), "bytes")


if __name__ == "__main__":
    main()
