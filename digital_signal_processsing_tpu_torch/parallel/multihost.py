"""Multi-host bring-up: one call a process.

Counterpart of ``digital_signal_processsing_tpu/parallel/multihost.py``.
The mesh code is host-count agnostic: :func:`make_mesh` spans every rank of
the initialised process group, and the sharded path's sends, receives and
gathers cross hosts with no code change.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
) -> dict:
    """Initialise ``torch.distributed``; returns a topology summary.

    With no arguments, reads the environment (``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``, as ``torchrun`` sets them); arguments
    override for manual bring-up (``coordinator_address`` as
    ``tcp://host:port``). ``backend``: NCCL when every rank has its own
    card, gloo for CPU tensors; by default NCCL where CUDA is available.
    The rank's card is ``LOCAL_RANK`` (else the rank) modulo the cards of
    the host.
    """
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", process_id if process_id is not None
                                   else os.environ.get("RANK", 0)))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend,
        init_method=coordinator_address or "env://",
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
    )
    return topology_summary()


def topology_summary() -> dict:
    backend = dist.get_backend()
    return {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "local_devices": torch.cuda.device_count() if backend == "nccl" else 1,
        "global_devices": dist.get_world_size(),
        "platform": "gpu" if backend == "nccl" else "cpu",
        "backend": backend,
    }


def assert_same_across_hosts(value: float, name: str = "value") -> None:
    """Cross-host agreement check by max and min (exact: no reduction rounding;
    the reference's earlier ``psum(v) == v*D`` spelling gave false positives
    at 16 devices, where a sequential float32 all-reduce rounds by ~D/2 ulps)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    dev = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else "cpu"
    hi = torch.tensor([float(value)], dtype=torch.float64, device=dev)
    lo = hi.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    if hi.item() != lo.item():
        raise RuntimeError(f"{name} differs across hosts: max={hi.item()!r} min={lo.item()!r}")


__all__ = ["initialize_multihost", "topology_summary", "assert_same_across_hosts"]
