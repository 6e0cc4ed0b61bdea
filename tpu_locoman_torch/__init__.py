"""tpu_locoman_torch: the PyTorch/CUDA port of tpu-locoman.

A second package beside the JAX reference ``tpu_locoman``, with the same
module names. It imports torch and never jax or tpu_locoman, and keeps its
own copies of the robot specs in ``specs/``. The three TPU kernels are
hand-written CUDA for Hopper: K1 (``solver/chol_base.py``), K2
(``rnea_derivs.py``) and K3 (``solver/fac_whole.py``). Entry points run on
the card unless the caller passes ``device="cpu"``.
"""

from . import gait, lie, model, rbda, urdf  # noqa: F401
from .mpc import MPC, MPCCarry, geometric_dts  # noqa: F401
from .parallel import batched_init, batched_step  # noqa: F401
from .robots import B2, B2G, Go2, Robot  # noqa: F401
from .solver import ADMMConfig, SQPConfig  # noqa: F401
