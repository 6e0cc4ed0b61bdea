"""Build an MPC from a configuration file, for the program under test or
for the plain reference: both packages take the same constructor
arguments, so one builder serves the two and neither can drift from the
file."""

from typing import NamedTuple


def build_mpc(pkg, cfg, device):
    """``pkg`` gives ``robots``, ``MPC``, ``SQPConfig`` and ``ADMMConfig``
    (the program's package or ``benchmark.reference``); ``cfg`` is a loaded
    configuration file. Every solver setting comes from the file."""
    robot = getattr(pkg.robots, cfg["robot"]["class"])(**cfg["robot"]["kwargs"])
    robot.set_gait_sequence(cfg["gait"]["type"], cfg["gait"]["period"])
    config = pkg.SQPConfig(admm=pkg.ADMMConfig(**cfg["admm"]), **cfg["sqp"])
    return pkg.MPC(robot, dynamics=cfg["dynamics"], nodes=cfg["nodes"],
                   dt_min=cfg["dt_min"], dt_max=cfg["dt_max"],
                   swing_height=cfg["swing_height"],
                   swing_vel_limits=tuple(cfg["swing_vel_limits"]),
                   config=config, flip_reset=cfg["flip_reset"],
                   warm_shift=cfg["warm_shift"], device=device,
                   **cfg["formulation"])


class Package(NamedTuple):
    """What a run takes from a package: the four names ``build_mpc`` needs,
    and the batched entry points."""

    robots: object
    MPC: type
    SQPConfig: type
    ADMMConfig: type
    batched_step: object  # (mpc, per_scenario_time) -> step
    batched_init: object  # (mpc, batch) -> carry


def program():
    import tpu_locoman_torch as T
    from tpu_locoman_torch import robots

    return Package(robots, T.MPC, T.SQPConfig, T.ADMMConfig, T.batched_step,
                   T.batched_init)


def reference(allow_tf32=False):
    """The plain reference as a package; ``allow_tf32`` makes it the
    control (every product of its tick in TF32)."""
    from . import check
    from .reference import robots
    from .reference.mpc import MPC
    from .reference.solver import ADMMConfig, SQPConfig

    def batched_step(mpc, per_scenario_time=False):
        return lambda carry, t, base_vel: check.reference_step(
            mpc, carry, t, base_vel, allow_tf32)

    return Package(robots, MPC, SQPConfig, ADMMConfig, batched_step,
                   lambda mpc, batch: mpc.init_carry(batch))
