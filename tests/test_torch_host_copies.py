"""No copy from the host inside the tick. Every host value a tick reads (an
index array, a limit, a weight, a gait period) is a tensor on the MPC's
device, made once, so a warm tick turns no host data into a tensor: on the
card it issues no synchronising host-to-device copy, and the host stays
ahead of the device.

Host data becomes a tensor through ``aten.lift_fresh`` (a numpy index, a
Python number assigned into a tensor, ``torch.tensor(...)``,
``torch.as_tensor(ndarray)``; a Python number in arithmetic does not), so
one warm tick under a dispatch mode counts it: the benchmark's
configurations (B2G + Z1, N=14, the hot solver, and accurate mode with the
closer's device tallies) at batch 3, and each of the five formulations at
Go2 N=8 with the hot solver."""

import collections
import os
import traceback

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from benchmark import build, traffic  # noqa: E402
from benchmark.cell import ROOT, load_json  # noqa: E402

HOT = load_json(os.path.join(ROOT, "benchmark/configs/b2g_rnea_hot.json"))
CONFIGS = ("b2g_rnea_hot", "b2g_rnea_accurate")
MIX = load_json(os.path.join(ROOT, "benchmark/traffic/fleet_b512.json"))
FORMULATIONS = ("whole_body_rnea", "whole_body_aba", "whole_body_acc",
                "centroidal_acc", "centroidal_vel")


class HostCopies(TorchDispatchMode):
    """Counts ``aten.lift_fresh`` by the program's source line that made
    it."""

    def __init__(self):
        super().__init__()
        self.sites = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.lift_fresh.default:
            frames = [f for f in traceback.extract_stack()
                      if "tpu_locoman_torch" in f.filename]
            where = (f"{frames[-1].filename.rsplit('tpu_locoman_torch/')[-1]}"
                     f":{frames[-1].lineno}" if frames
                     else "outside the program")
            self.sites[where] += 1
        return func(*args, **(kwargs or {}))


def _config(case):
    if case in CONFIGS:
        path = os.path.join(ROOT, f"benchmark/configs/{case}.json")
        return load_json(path), 3
    return dict(HOT, robot={"class": "Go2", "kwargs": {}}, nodes=8,
                dynamics=case, formulation={}), 2


@pytest.mark.parametrize("case", CONFIGS + FORMULATIONS)
def test_a_warm_tick_copies_nothing_from_the_host(case):
    cfg, batch = _config(case)
    dev = torch.device("cpu")
    mpc = build.build_mpc(build.program(), cfg, dev)
    inputs = traffic.make(dict(MIX, batch=batch), 2718281828, dev)
    carry = mpc.init_carry(batch)
    for k in range(2):
        carry, _ = mpc.step(carry, inputs.time(k, cfg["dt_min"]),
                            inputs.base_vel)
    with HostCopies() as copies:
        mpc.step(carry, inputs.time(2, cfg["dt_min"]), inputs.base_vel)
    assert not copies.sites, dict(copies.sites)
    # the warm shift's index tables sit on the MPC's device
    for x in mpc._shift_index:
        assert x.device == mpc.device


def test_the_counter_sees_a_host_copy():
    """The mode counts what the tick must not do: a numpy index, a Python
    number assigned by index and torch.tensor."""
    import numpy as np

    x = torch.zeros(3, 4)
    with HostCopies() as copies:
        y = x[:, np.array([0, 2])]
        x[:, torch.arange(2)] = 1.0
        torch.tensor([1.0, 2.0]) * y.sum()
        x * 2.0 + torch.arange(3.0)[:, None]
    assert sum(copies.sites.values()) == 3
