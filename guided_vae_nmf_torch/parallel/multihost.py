"""Multi-process runtime over `torch.distributed`.

Counterpart of `guided_vae_nmf_tpu/parallel/multihost.py`. Each process
joins the process group, the utterance list splits across processes
(`sweep.shard_file_list`), and each process's mesh runs the sharded
engines on its local devices:

    from guided_vae_nmf_torch.parallel import multihost, make_mesh
    multihost.initialize()                   # no-op in a single process
    files = shard_file_list(all_files)       # this process's shard
    mesh = make_mesh()                       # this process's cards
    ... enhance_files(files, ..., mesh=mesh) ...

The process group comes from MASTER_ADDR / MASTER_PORT / WORLD_SIZE /
RANK (the JAX package reads JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
JAX_PROCESS_ID); its backend is NCCL when this process has a card and gloo
otherwise. :class:`DistGroup` is the group's `all_sum` for the sharded EM
loop's cross-frame sums.
"""

import os

import torch
import torch.distributed as dist

_initialized = False


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, backend=None, timeout_s=None):
    """Join the process group when one is configured, from the arguments
    or the environment (MASTER_ADDR[:MASTER_PORT], WORLD_SIZE, RANK);
    `coordinator_address` is "host:port". With no address configured it
    is a no-op. backend: default "nccl" with a card, else "gloo"."""
    global _initialized
    if _initialized or dist.is_initialized():
        _initialized = True
        return
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = os.environ["MASTER_ADDR"]
        if os.environ.get("MASTER_PORT"):
            coordinator_address += ":" + os.environ["MASTER_PORT"]
    if coordinator_address is None:
        return                              # a single process
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if timeout_s is not None:
        import datetime

        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, **kw)
    _initialized = True


def shutdown():
    """Leave the process group (a no-op when none was joined)."""
    global _initialized
    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def process_count():
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index():
    return dist.get_rank() if dist.is_initialized() else 0


def is_multihost():
    return process_count() > 1


class DistGroup:
    """`all_sum` across the processes of a `torch.distributed` group (the
    default group when None): `dist.all_reduce` with SUM on a copy, on
    the tensor's device (gloo on the CPU, NCCL on a card)."""

    def __init__(self, group=None):
        self.group = group

    def all_sum(self, t):
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out
