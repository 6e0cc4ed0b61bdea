"""Multi-process setup: the port's counterpart of
``tpu_locoman/distributed.py``.

The torch idiom is one process per GPU: ``torch.distributed`` with NCCL on
the card and gloo on the CPU (or for several processes sharing one card,
whose collectives then go through host copies, see ``parallel.gather``).
Each MPC instance stays on its rank's device; the only cross-rank traffic
is result aggregation.

Usage, one process per rank:

    from tpu_locoman_torch.distributed import initialize, host_chip_mesh
    initialize("localhost:29500", num_processes=world, process_id=rank)
    mesh = host_chip_mesh()
    # this rank's scenarios: parallel.shard_batch(tree, mesh,
    #   axes=("host", "chip"))
"""

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def init_group(backend, world_size, rank, address="localhost:29500"):
    """``init_process_group`` at ``tcp://address``, for any world size (a
    world of 1 too, which the NCCL check on a one-card machine uses).
    A localhost address pins gloo to the loopback interface: gloo's default
    interface may have an address the other processes cannot reach."""
    if (address.split(":")[0] in ("localhost", "127.0.0.1")
            and "GLOO_SOCKET_IFNAME" not in os.environ):
        os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    dist.init_process_group(backend, init_method=f"tcp://{address}",
                            world_size=world_size, rank=rank)


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               backend=None):
    """Process-group bootstrap; a no-op for a world of one process.
    ``backend`` defaults to NCCL where CUDA is available, else gloo."""
    if num_processes is None or num_processes <= 1:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    init_group(backend, num_processes, process_id,
               coordinator_address or "localhost:29500")
    return True


def mesh_device_type():
    """The DeviceMesh device type of the initialized group's backend."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def host_chip_mesh(axis_names=("host", "chip")):
    """2-D (hosts x ranks per host) DeviceMesh over every rank. The ranks
    per host are ``LOCAL_WORLD_SIZE`` (as torchrun sets it), else all
    ranks: on one host it degenerates to (1, world)."""
    world = dist.get_world_size()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return init_device_mesh(mesh_device_type(), (world // per_host, per_host),
                            mesh_dim_names=tuple(axis_names))


def warmup_collectives(mesh=None):
    """One all-reduce over every rank while the processes are in lockstep,
    so the transport's rendezvous happens before the first real
    collective; returns the world size."""
    n = dist.get_world_size()
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if dev == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.ones(1, device=dev)
    dist.all_reduce(x)
    if int(x.item()) != n:
        raise RuntimeError(f"all-reduce of ones gave {x.item()}, not {n}")
    return n


def local_batch_slice(global_batch):
    """The scenario indices this rank owns when the batch is split over
    every rank in rank order."""
    n, r = dist.get_world_size(), dist.get_rank()
    per = global_batch // n
    return slice(r * per, (r + 1) * per)
