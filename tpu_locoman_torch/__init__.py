"""tpu_locoman_torch: the PyTorch/CUDA port of tpu-locoman.

A second package beside the JAX reference ``tpu_locoman``, with the same
module names. It imports torch and never jax or tpu_locoman, and keeps its
own copies of the robot specs in ``specs/``. The three TPU kernels are
hand-written CUDA for Hopper: K1 (``solver/chol_base.py``), K2
(``rnea_derivs.py``) and K3 (``solver/fac_whole.py``). Entry points run on
the card unless the caller passes ``device="cpu"``; ``make_ocp`` is the
reference-style entry point.
"""

from . import gait, lie, model, rbda, urdf  # noqa: F401
from .dynamics import FORMULATIONS, make_formulation  # noqa: F401
from .dynamics.formulations import DEFAULT_ARGS as OCP_ARGS
from .mpc import MPC, MPCCarry, geometric_dts  # noqa: F401
from .parallel import batched_init, batched_step  # noqa: F401
from .robots import B2, B2G, Go2, Robot  # noqa: F401
from .solver import ADMMConfig, SQPConfig  # noqa: F401

__version__ = "0.1.0"


def make_ocp(dynamics, default_args=None, robot=None, nodes=14,
             solver="sqp", **kwargs):
    """The reference-style factory: a ready ``MPC`` for the dynamics
    formulation ``dynamics``, with its ``OCP_ARGS`` (or ``default_args``)
    updated by ``kwargs``; ``config`` among them is the ``SQPConfig``
    (default ``SQPConfig()``). ``solver`` is accepted and ignored: the SQP
    + ADMM stack is the only solver. ``device`` goes to ``MPC`` through
    ``kwargs``: the card by default, ``device="cpu"`` for a CPU run."""
    assert robot is not None, "make_ocp requires robot="
    args = dict(default_args or OCP_ARGS.get(dynamics, {}))
    args.update(kwargs)
    config = args.pop("config", SQPConfig())
    return MPC(robot, dynamics=dynamics, nodes=nodes, config=config, **args)
