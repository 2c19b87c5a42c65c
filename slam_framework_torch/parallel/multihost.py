"""Multi-process execution of the distributed optimizers: one rank per process.

Port of slam_framework_tpu/parallel/multihost.py, where `initialize` wires
`jax.distributed` and a mesh spans the devices of several processes. Here the
processes are linked by `torch.distributed` and a `ProcessMesh` is the rank
mesh of `parallel/mesh.py` over them:

  - `initialize(init_method, world_size, rank, device=None)`: one call per
    process. The device is the caller's, else CUDA (`resolve_device`: the CPU
    only when asked for). The backend follows the device: gloo for CPU
    tensors, NCCL for CUDA tensors with one GPU per rank (rank r on cuda:r).
    A CUDA mesh with fewer visible GPUs than ranks raises: CUDA tensors never
    go through gloo and a rank never moves to the CPU. `init_method` is
    `tcp://host:port` or `file:///path` (a FileStore, which needs no port).
  - `ProcessMesh`: `all_reduce_sum` is `dist.all_reduce`, `all_to_all` is
    `dist.all_to_all_single`, `gather` is `dist.all_gather` in rank order.
  - the reference's `place` / `shard_get` are the mesh's `block` (this rank's
    block of a shard-concatenated input that every process holds identically:
    the shard layouts are deterministic host code) and `gather` (the full
    layout of a sharded output, in rank order).

`python -m slam_framework_torch.tools.multihost_demo` spawns N ranks and holds
their results against the single-rank optimizers.
"""

from __future__ import annotations

from typing import Callable, List

import torch
import torch.distributed as dist

from slam_framework_torch import resolve_device
from slam_framework_torch.parallel.mesh import RankMesh


def initialize(init_method: str, world_size: int, rank: int, device=None) -> "ProcessMesh":
    """Join this process to the group as `rank` of `world_size` and return the
    mesh: on CUDA unless `device` is the CPU (no CUDA device and no device
    named raises)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if visible < world_size:
            raise RuntimeError(f"a CUDA mesh of {world_size} ranks needs one GPU per rank; {visible} visible")
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process mesh on {dev}")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    return ProcessMesh(dev)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


class ProcessMesh(RankMesh):
    """This process's rank of an initialized `torch.distributed` group."""

    def __init__(self, device):
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialized: call multihost.initialize first")
        self.size = dist.get_world_size()
        self._rank = dist.get_rank()
        self.device = torch.device(device)
        backend = dist.get_backend()
        if self.device.type == "cuda":
            if backend != "nccl":
                raise ValueError(f"CUDA tensors go through NCCL, not {backend}")
            if torch.cuda.device_count() < self.size:
                raise RuntimeError(f"a CUDA mesh of {self.size} ranks needs one GPU per rank; "
                                   f"{torch.cuda.device_count()} visible")
        elif backend != "gloo":
            raise ValueError(f"CPU tensors go through gloo, not {backend}")

    def __repr__(self) -> str:
        return f"ProcessMesh(rank {self._rank} of {self.size}, {str(self.device)!r})"

    @property
    def ranks(self) -> List[int]:
        return [self._rank]

    @property
    def shard_device(self) -> torch.device:
        return torch.device("cpu")

    def run(self, fn: Callable[[int], object]) -> list:
        return [fn(self._rank)]

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        y = x.contiguous().clone()
        dist.all_reduce(y)
        return y

    def all_to_all(self, buckets: torch.Tensor) -> torch.Tensor:
        if buckets.shape[0] != self.size:
            raise ValueError(f"all_to_all takes ({self.size}, ...) buckets, not {tuple(buckets.shape)}")
        out = torch.empty_like(buckets)
        dist.all_to_all_single(out, buckets.contiguous())
        return out

    def gather(self, parts: List[torch.Tensor]) -> torch.Tensor:
        (part,) = parts
        wire = part.to(torch.uint8) if part.dtype == torch.bool else part.contiguous()
        got = [torch.empty_like(wire) for _ in range(self.size)]
        dist.all_gather(got, wire)
        out = torch.cat(got)
        return out.bool() if part.dtype == torch.bool else out
