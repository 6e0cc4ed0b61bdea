"""The program's tick is bit for bit the benchmark's plain reference on the
CPU. ``benchmark/reference/`` is a frozen copy of the port's main path
with every kernel replaced by its plain PyTorch version, which is what the
port runs on CPU tensors; so three closed-loop ticks of each of the
benchmark's configurations (B2G + Z1, N=14, the hot solver and accurate
mode) at batch 4, each package from its own carry, agree exactly: a change
to the program that should not move a number (a constant made once on the
device instead of on every call, a tally of the closer) moves none."""

import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from benchmark import build, check, traffic  # noqa: E402
from benchmark.cell import ROOT, load_json  # noqa: E402

CONFIGS = ("b2g_rnea_hot", "b2g_rnea_accurate")
MIX = load_json(os.path.join(ROOT, "benchmark/traffic/fleet_b512.json"))


@pytest.mark.parametrize("config", CONFIGS)
def test_three_closed_loop_ticks_equal_the_reference(config):
    cfg = load_json(os.path.join(ROOT, f"benchmark/configs/{config}.json"))
    dev = torch.device("cpu")
    mpc = build.build_mpc(build.program(), cfg, dev)
    ref = build.build_mpc(build.reference(), cfg, dev)
    inputs = traffic.make(dict(MIX, batch=4), 3141592653, dev)
    assert inputs.per_scenario
    carry, carry_ref = mpc.init_carry(4), ref.init_carry(4)
    for k in range(3):
        t = inputs.time(k, cfg["dt_min"])
        carry, stats = mpc.step(carry, t, inputs.base_vel)
        carry_ref, stats_ref = check.reference_step(ref, carry_ref, t,
                                                    inputs.base_vel)
        s, r = carry.solver_state, carry_ref.solver_state
        for name, a, b in (("x", carry.x_init, carry_ref.x_init),
                           ("Z", s.Z, r.Z), ("z_admm", s.z_admm, r.z_admm),
                           ("y_admm", s.y_admm, r.y_admm),
                           ("max_violation", stats["max_violation"],
                            stats_ref["max_violation"])):
            assert torch.equal(a, b), (
                f"tick {k}: {name} differs by {(a - b).abs().max():.3g}")
