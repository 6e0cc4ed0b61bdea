"""Exported step artifacts: the port's counterpart of ``tpu_locoman/aot.py``.

The deployable artifact is a ``torch.export`` program saved as ``.pt2``
bytes: portable across processes and loadable without the Python
model-construction code. Its ABI is the JAX artifact's with the port's
explicit scenario axis at a fixed batch B:

    step(carry, t (B,), base_vel_des (B, 6), ext_force_des (B, 3),
         arm_vel_des (B, 3)) -> (carry, max_violation (B,))
    retract(Z (B, N+1, s), x_init (B, nx)) -> (q, v, a, forces, tau)

The three kernels enter the program as the custom ops
``tpu_locoman_torch::chol_inv_node``, ``::rnea_derivs`` and ``::fac_whole``
(their CPU implementation the plain version, their CUDA implementation the
kernel), so a program exported on the card launches them when it runs.
The program runs on the device of the ``MPC`` it was exported from.

How it is traced: ``make_fx`` in fake mode first takes the step to ATen
operations, ``torch.func`` transforms included, and ``torch.export`` then
exports that graph. Exported directly, a tensor factory inside a
``torch.func`` transform (``torch.eye``, ``zeros_like``, ... in the Lie
maps under ``rbda.integrate_tangent_map``'s jvp and in the centroidal
``dyn_linearize``'s vjp) is not traced: its fake value is baked into the
graph as a constant and the program computes something else. Fake mode
raises on any branch that depends on a tensor's value, so the artifact
cannot hold a decision taken for the example inputs. Before the trace
every per-device cache of the model is filled with real tensors
(``_fill_caches``), so that tracing leaves no fake tensor behind in the
live ``MPC``; a trace that writes a cache all the same raises. Exporting
launches nothing on the device.
"""

import io

import torch
import torch.utils._pytree as pytree
from torch.fx.experimental.proxy_tensor import make_fx

from .mpc import MPCCarry
from .solver import SolverState
from .solver import chol_base, fac_whole  # noqa: F401  (the ops)
from . import rbda, rnea_derivs

# the pytree nodes that cross the ABI need serialized names (once per
# process), as the JAX package registers them for jax.export
for _t in (SolverState, MPCCarry):
    if _t not in pytree.SUPPORTED_NODES:
        pytree._register_namedtuple(
            _t, serialized_type_name=f"tpu_locoman_torch.{_t.__name__}")


def _fill_caches(mpc):
    """Fill the model's lazily filled per-device caches on the MPC's device
    (its tensors, the local spatial inertias, every frame's placement,
    K2's tree table for the formulation's force frames)."""
    model, dev = mpc.form.model, mpc.device
    rbda.local_inertias(model, dev)
    for name in model.frames:
        rbda._frame_consts(model, name, dev)
    rnea_derivs._topology(model, tuple(mpc.form.ee_frames), dev)


def _cache_keys(model):
    """(device, key) of every entry of the model's per-device caches."""
    return {(d, k) for d, c in model.__dict__.get("_tensor_cache", {}).items()
            for k in c}


def _export(mpc, fn, args, path):
    """Trace ``fn`` at ``args`` (the caches filled first), export,
    serialize."""
    _fill_caches(mpc)
    keys = _cache_keys(mpc.form.model)
    # recording a stack trace per node is a third of the trace's time
    # (torch 2.13 has the switch, 2.11 does not)
    emit = getattr(torch.fx.config, "do_not_emit_stack_traces", None)
    if emit is not None:
        torch.fx.config.do_not_emit_stack_traces = True
    try:
        with torch.no_grad():
            gm = make_fx(fn, tracing_mode="fake",
                         _allow_non_fake_inputs=True)(*args)
            added = _cache_keys(mpc.form.model) - keys
            if added:
                raise RuntimeError(f"the trace filled model caches "
                                   f"{sorted(added)}: fill them first")
            # drops the autograd engine's unused shape checks of the vjps
            gm.graph.eliminate_dead_code()
            gm.recompile()
            ep = torch.export.export(gm, args, strict=False)
    finally:
        if emit is not None:
            torch.fx.config.do_not_emit_stack_traces = emit
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    data = buf.getvalue()
    if path:
        with open(path, "wb") as f:
            f.write(data)
    return data


def _step_args(mpc, batch):
    """The example arguments of the exported step: the initial carry, t = 0
    and zero targets, (batch, ...) on the MPC's device."""
    dev = mpc.device
    return (mpc.init_carry(batch), torch.zeros(batch, device=dev),
            torch.zeros(batch, 6, device=dev),
            torch.zeros(batch, 3, device=dev),
            torch.zeros(batch, 3, device=dev))


def export_mpc_step(mpc, batch, path=None):
    """Export one MPC tick for ``batch`` scenarios; returns the ``.pt2``
    bytes (and writes them to ``path`` if given)."""

    def step(carry, t, base_vel_des, ext_force_des, arm_vel_des):
        new_carry, stats = mpc.step(carry, t, base_vel_des, ext_force_des,
                                    arm_vel_des)
        return new_carry, stats["max_violation"]

    return _export(mpc, step, _step_args(mpc, batch), path)


def export_retract(mpc, batch, num_steps=3, path=None):
    """Export the retraction of the first ``num_steps`` nodes, (Z, x_init)
    -> (q, v, a, forces, tau), the analog of the generated
    retract_solution.c."""

    def retract(Z, x_init):
        sol = mpc.retract(Z, x_init, num_steps=num_steps)
        return sol["q"], sol["v"], sol["a"], sol["forces"], sol["tau"]

    dev = mpc.device
    args = (torch.zeros(batch, mpc.nodes + 1, mpc.trans.s, device=dev),
            mpc.x_nom().expand(batch, -1).clone())
    return _export(mpc, retract, args, path)


def load_artifact(data_or_path):
    """Deserialize an artifact (bytes or a path); returns a callable (the
    ``ca.external`` analog). The op registrations are imported with this
    module, before ``torch.export.load``."""
    if isinstance(data_or_path, (bytes, bytearray)):
        data_or_path = io.BytesIO(data_or_path)
    # the example inputs hold the carry's namedtuples
    with torch.serialization.safe_globals([MPCCarry, SolverState]):
        return torch.export.load(data_or_path).module()
