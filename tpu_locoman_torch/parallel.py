"""Scenario batching and multi-process sharding: the port's counterpart of
``tpu_locoman/parallel.py``.

The port's MPC carries a leading scenario axis, so batching is explicit
rather than a vmap. Sharding follows the torch idiom, one process per
device: a ``DeviceMesh`` over the ranks (``make_mesh``), each rank holding
its slice of every leaf's leading axis on its own device (``shard_batch``),
every scenario solved rank-locally, and results all-gathered so that every
rank sees the whole batch, as JAX's global array does (``batched_run``).
Per-solve data never crosses ranks.
"""

from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree
from torch.distributed.device_mesh import init_device_mesh

from .distributed import mesh_device_type


def make_mesh(axis_names=("dp",), shape=None):
    """DeviceMesh over every rank of the initialized process group. Default:
    1-D data parallel."""
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("provide shape for multi-axis meshes")
        shape = (dist.get_world_size(),)
    return init_device_mesh(mesh_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axis_names))


class BatchSharding(NamedTuple):
    """This rank's share of a leading (scenario) axis split over ``axes``:
    shard ``index`` of ``count``, gathered over ``group``."""

    index: int
    count: int
    group: object
    device: torch.device

    def slice(self, n):
        if n % self.count:
            raise ValueError(f"batch {n} does not split into {self.count} "
                             f"shards")
        per = n // self.count
        return slice(self.index * per, (self.index + 1) * per)


def _rank_device():
    if not torch.cuda.is_available():
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def batch_sharding(mesh, axes=("dp",), device=None):
    """The BatchSharding that splits the leading axis over the mesh axes
    ``axes`` (a single axis, or every axis of the mesh), placed on
    ``device`` (default: the rank's current CUDA device, else the CPU)."""
    names = tuple(mesh.mesh_dim_names)
    axes = tuple(axes)
    coord = mesh.get_coordinate()
    if len(axes) == 1:
        dim = names.index(axes[0])
        index, count = coord[dim], mesh.size(dim)
        group = mesh.get_group(axes[0])
    elif sorted(axes) == sorted(names):
        index, count = 0, 1
        for a in axes:
            dim = names.index(a)
            index, count = index * mesh.size(dim) + coord[dim], (
                count * mesh.size(dim))
        group = dist.group.WORLD
    else:
        raise NotImplementedError("shard over one mesh axis or all of them")
    return BatchSharding(index, count, group,
                         torch.device(device) if device else _rank_device())


def shard_batch(tree, mesh, axes=("dp",), device=None):
    """This rank's slice of the leading (scenario) axis of every leaf, on
    its device."""
    sh = batch_sharding(mesh, axes, device)

    def put(x):
        x = torch.as_tensor(x)
        return x[sh.slice(x.shape[0])].to(sh.device).contiguous()

    return pytree.tree_map(put, tree)


def gather(x, sharding, dim=0):
    """Every shard's ``x`` concatenated along ``dim`` in shard order, on
    ``x``'s device. Gloo has no all-gather of CUDA tensors (several ranks
    sharing one card), so those go through host copies."""
    if sharding.count == 1:
        return x
    host = x.is_cuda and dist.get_backend(sharding.group) == "gloo"
    y = (x.cpu() if host else x).contiguous()
    parts = [torch.empty_like(y) for _ in range(sharding.count)]
    dist.all_gather(parts, y, group=sharding.group)
    out = torch.cat(parts, dim)
    return out.to(x.device) if host else out


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


def batched_run(mpc, n_loops, base_vel_des_batch, mesh=None, axes=("dp",)):
    """A batch of full MPC rollouts, ``(carry, outs)`` with outs stacked
    (n_loops, batch, ...). With a mesh each rank runs its slice of the
    scenarios (on the MPC's device) and every rank returns the whole
    batch."""
    targets = torch.as_tensor(base_vel_des_batch, dtype=torch.float32,
                              device=mpc.device)
    if mesh is None:
        return mpc.run(n_loops, targets, batch=targets.shape[0])
    sh = batch_sharding(mesh, axes, mpc.device)
    local = targets[sh.slice(targets.shape[0])]
    carry, outs = mpc.run(n_loops, local, batch=local.shape[0])
    carry = pytree.tree_map(lambda x: gather(x, sh, 0), carry)
    outs = {k: gather(v, sh, 1) for k, v in outs.items()}
    return carry, outs
