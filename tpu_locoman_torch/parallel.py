"""Scenario batching: the port's counterpart of ``batched_init`` and
``batched_step`` in ``tpu_locoman/parallel.py``. The port's MPC already
carries a leading scenario axis, so batching is explicit rather than a
vmap; multi-device sharding waits for a later slice (ROADMAP queue 1,
item 17)."""


def batched_step(mpc, per_scenario_time=False):
    """(carries, t, targets) -> (carries, stats) for a scenario batch. t is
    one time for every scenario, or a (batch,) tensor when
    per_scenario_time."""

    def step(carries, t, base_vel_des):
        if per_scenario_time and getattr(t, "dim", lambda: 0)() != 1:
            raise ValueError("per_scenario_time needs a (batch,) t")
        return mpc.step(carries, t, base_vel_des)

    return step


def batched_init(mpc, batch):
    """The initial carry replicated across a scenario batch."""
    return mpc.init_carry(batch)
