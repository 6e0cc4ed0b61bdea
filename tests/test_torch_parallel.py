"""Multi-process sharding of the port (``parallel``, ``distributed``,
``dryrun``), the counterpart of tests/test_parallel.py and
tests/test_distributed.py.

Two gloo processes run the dry run on the CPU (Go2 whole_body_rnea N=3,
batch 4, 2 ticks): each rank's slice of the batch, all-gathered, equals
the unsharded batch at the JAX dry run's bounds (x rtol = atol = 2e-3,
violation rtol 0.3 + 5e-2; measured: 0, one scenario's arithmetic does
not depend on the batch on the CPU), and both ranks agree on the
all-reduced global mean violation within 1e-6. In one process, a
one-rank gloo group: shard_batch, batch_sharding and batched_run over a
mesh against the same calls without one, and per-scenario times."""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import torch.distributed as dist  # noqa: E402

import tpu_locoman_torch as T  # noqa: E402
from tpu_locoman_torch import distributed, dryrun, parallel  # noqa: E402


def test_two_gloo_processes_match_the_unsharded_batch():
    res = dryrun.dryrun_multichip(2, device="cpu", config="tiny",
                                  timeout=300)
    assert res["world"] == 2 and res["backend"] == "gloo"
    assert res["x_gap"] <= dryrun.X_TOL and res["viol_mean"] < 5.0
    means = [float(re.search(r"global mean violation ([0-9.]+)", ln)[1])
             for ln in res["ranks"]]
    assert len(means) == 2 and abs(means[0] - means[1]) < 1e-6, means
    assert abs(means[0] - res["viol_mean_unsharded"]) < 1e-6
    assert "scenarios 0:2" in res["ranks"][0]
    assert "scenarios 2:4" in res["ranks"][1]


def _mpc(iters=3):
    robot = T.Go2()
    robot.set_gait_sequence("trot", 0.5)
    return T.MPC(robot, dynamics="centroidal_acc", nodes=3, device="cpu",
                 config=T.SQPConfig(sqp_iters=1,
                                    admm=T.ADMMConfig(iters=iters)))


@pytest.fixture
def one_rank_group():
    port = dryrun._free_port()
    assert distributed.initialize(num_processes=1) is False  # a no-op
    distributed.init_group("gloo", 1, 0, f"localhost:{port}")
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_mesh_and_batched_run_on_one_rank(one_rank_group):
    assert distributed.warmup_collectives() == 1
    mesh = parallel.make_mesh()
    assert tuple(mesh.shape) == (1,) and mesh.mesh_dim_names == ("dp",)
    two = distributed.host_chip_mesh()
    assert tuple(two.shape) == (1, 1)
    sh = parallel.batch_sharding(two, ("host", "chip"), device="cpu")
    assert (sh.index, sh.count) == (0, 1) and sh.slice(4) == slice(0, 4)
    assert distributed.local_batch_slice(4) == slice(0, 4)
    mpc = _mpc()
    tree = parallel.shard_batch(parallel.batched_init(mpc, 2), mesh,
                                device="cpu")
    assert tree.x_init.shape == (2, mpc.form.nx)
    targets = np.zeros((2, 6), np.float32)
    targets[:, 0] = [0.1, 0.2]
    c1, o1 = parallel.batched_run(mpc, 2, targets, mesh=mesh)
    c2, o2 = parallel.batched_run(mpc, 2, targets)
    assert torch.equal(c1.x_init, c2.x_init)
    assert o1["x"].shape == (2, 2, mpc.form.nx)
    assert torch.equal(o1["max_violation"], o2["max_violation"])


def test_per_scenario_gait_phase_sweep():
    """Each scenario at another gait phase gets other schedules and another
    solution (the gait-sweep axis of BASELINE config #5), at the JAX
    test's 10 sweeps (3 leave every scenario at its start)."""
    mpc = _mpc(10)
    step = T.batched_step(mpc, per_scenario_time=True)
    with pytest.raises(ValueError):
        step(T.batched_init(mpc, 4), 0.0, torch.zeros(4, 6))
    carries, _ = step(T.batched_init(mpc, 4),
                      torch.tensor([0.0, 0.07, 0.13, 0.31]),
                      torch.tensor([[0.1, 0, 0, 0, 0, 0]] * 4))
    x = carries.x_init.numpy()
    assert np.isfinite(x).all() and not np.allclose(x[0], x[3], atol=1e-5)
