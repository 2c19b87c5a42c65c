"""Rank meshes: what `slam_framework_tpu/parallel/` runs its `jax.shard_map`
programs over, for the port.

A mesh of `size` ranks runs one per-shard program on each of its ranks
(`run`). Inside the program a rank holds its block of every shard-concatenated
input (`block`) and the replicated state, and meets the other ranks only in
two collectives:

  - `all_reduce_sum(x)`: the sum of every rank's `x` (`jax.lax.psum`);
  - `all_to_all(buckets)`: (D_dst, ...) buckets in, (D_src, ...) out: bucket d
    of rank s arrives as row s at rank d (`jax.lax.all_to_all`, split and
    concatenated on axis 0).

After the program, `gather` puts the ranks' blocks of an output back in rank
order, so every caller holds the whole layout, as JAX's global arrays do.

Two kinds of mesh share this interface:

  - `LocalMesh(n, device)`: n ranks in one process on one device, the
    counterpart of JAX's n virtual devices (`xla_force_host_platform_device_count`)
    or of one multi-chip `Mesh` in one process. Each rank runs the unchanged
    per-shard program in its own Python thread; the threads meet at a
    `threading.Barrier` whose action, run once per collective by the last
    rank to arrive, stacks the ranks' parts in rank order and sums over
    dimension 0 (or transposes the bucket axes). The order of the sum is
    fixed, so every rank gets the same bits, as `psum` gives. Every rank
    enqueues on ONE CUDA stream, the caller's, so the stream orders each part
    before the reduction that reads it: no event, no host synchronisation. No
    tensor leaves the mesh's device and no collective goes through host memory.
  - `multihost.ProcessMesh`: one rank per process over `torch.distributed`
    (gloo for CPU tensors, NCCL for CUDA tensors with one GPU per rank).

Pitfalls of the thread mesh, each handled in `LocalMesh.run`:

  - PyTorch keeps the grad mode (`no_grad` / `inference_mode`), the current
    CUDA device and the current CUDA stream PER THREAD. A new thread starts
    with grad enabled, on device 0 and on the default stream, so every rank
    thread enters the caller's grad mode, inference mode, device and stream.
  - Threads that all run PyTorch ops fight over the interpreter lock: every
    op releases it around its dispatch, and with eight runnable threads each
    re-acquisition queues behind the others. So the ranks take TURNS: a rank
    holds the mesh's turn lock while it runs and hands it on at each
    collective. The ops of one rank between two
    collectives run without contention; the results do not depend on the
    order of the turns (each rank reads only its own tensors and the
    collectives' results, and a collective runs once every part is in).
  - A rank that raises aborts the barrier, so the ranks waiting in a
    collective fail with `BrokenBarrierError` instead of hanging; `run` then
    re-raises the first rank's own exception. The barrier also has a timeout,
    for a rank that never reaches a collective.
  - The host pays every launch once per rank: a program of N kernels costs
    size x N launches from one host thread at a time (the interpreter lock).
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

import torch

DEFAULT_TIMEOUT_S = 600.0


def canonical_device(device) -> torch.device:
    """torch.device with the CUDA index filled in ("cuda" -> "cuda:<current>"),
    so two names of one device compare equal."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh needs a CUDA device, and none is available")
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class RankMesh:
    """The interface the distributed programs see (module docstring)."""

    size: int
    device: torch.device

    @property
    def ranks(self) -> List[int]:
        """The ranks this process runs, in rank order."""
        raise NotImplementedError

    @property
    def shard_device(self) -> torch.device:
        """Where a caller puts a shard-concatenated input before `run`: the
        mesh's device when the process holds every rank, else the host (each
        rank then copies only its own block to its device)."""
        raise NotImplementedError

    def run(self, fn: Callable[[int], object]) -> list:
        """[fn(rank) for each rank of `ranks`], run as one SPMD program."""
        raise NotImplementedError

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def all_to_all(self, buckets: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def gather(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """The blocks of an axis-0 sharded output (one per rank of `ranks`)
        -> the blocks of ALL ranks, concatenated in rank order."""
        raise NotImplementedError

    def block(self, x: torch.Tensor, rank: int) -> torch.Tensor:
        """Rank `rank`'s block of an axis-0 shard-concatenated tensor, on the
        mesh's device (a view when it is there already)."""
        n = x.shape[0]
        if n % self.size:
            raise ValueError(f"axis 0 of length {n} does not split into {self.size} blocks")
        return x.reshape((self.size, n // self.size) + tuple(x.shape[1:]))[rank].to(self.device)


class LocalMesh(RankMesh):
    """n ranks as n threads of this process on one device (module docstring)."""

    def __init__(self, n: int, device, timeout: float = DEFAULT_TIMEOUT_S):
        if n < 1:
            raise ValueError(f"a mesh needs at least one rank, not {n}")
        self.size = int(n)
        self.device = canonical_device(device)
        self.timeout = timeout
        self._local = threading.local()
        self._program = threading.Lock()  # one SPMD program at a time
        self._turn = threading.Lock()     # held by the one rank that runs Python (module docstring)
        self._barrier: Optional[threading.Barrier] = None
        self._slots: list = [None] * self.size
        self._result: Optional[torch.Tensor] = None

    def __repr__(self) -> str:
        return f"LocalMesh({self.size}, {str(self.device)!r})"

    @property
    def ranks(self) -> List[int]:
        return list(range(self.size))

    @property
    def shard_device(self) -> torch.device:
        return self.device

    def rank(self) -> int:
        """The calling rank thread's rank."""
        r = getattr(self._local, "rank", None)
        if r is None:
            raise RuntimeError("a collective was called outside LocalMesh.run")
        return r

    def run(self, fn: Callable[[int], object]) -> list:
        with self._program:
            grad = torch.is_grad_enabled()
            inference = torch.is_inference_mode_enabled()
            stream = torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None
            self._barrier = threading.Barrier(self.size, action=self._collect, timeout=self.timeout)
            self._slots = [None] * self.size
            results: list = [None] * self.size
            errors: list = []  # (rank, exception), in the order they happened
            errors_lock = threading.Lock()

            def rank_main(rank: int) -> None:
                self._local.rank = rank
                self._turn.acquire()
                try:
                    with torch.inference_mode(inference), torch.set_grad_enabled(grad):
                        if stream is None:
                            results[rank] = fn(rank)
                        else:
                            torch.cuda.set_device(self.device)
                            with torch.cuda.stream(stream):
                                results[rank] = fn(rank)
                except BaseException as e:  # noqa: BLE001 -- handed to the caller below
                    with errors_lock:
                        errors.append((rank, e))
                    self._barrier.abort()
                finally:
                    self._local.rank = None
                    self._turn.release()  # a rank holds its turn whenever it runs

            threads = [threading.Thread(target=rank_main, args=(r,), name=f"mesh-rank-{r}", daemon=True)
                       for r in range(self.size)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            self._barrier = None
            self._slots = [None] * self.size
            self._result = None
            if errors:
                own = [(r, e) for r, e in errors if not isinstance(e, threading.BrokenBarrierError)]
                if own:
                    raise own[0][1]
                rank, err = errors[0]
                raise RuntimeError(f"rank {rank} of {self!r}: a collective was not reached by every rank "
                                   f"within {self.timeout} s") from err
            return results

    # ------------------------------------------------------------------ collectives

    def _collective(self, op: str, x: torch.Tensor) -> torch.Tensor:
        self._slots[self.rank()] = (op, x)
        self._turn.release()
        try:
            self._barrier.wait()
        finally:
            self._turn.acquire()
        return self._result

    def _collect(self) -> None:
        """Barrier action: run by one rank thread once every rank has put its part."""
        ops = {op for op, _ in self._slots}
        if len(ops) != 1:
            raise RuntimeError(f"the ranks of {self!r} called different collectives: {sorted(ops)}")
        parts = [x for _, x in self._slots]
        for r, x in enumerate(parts):
            if x.device != self.device:
                raise RuntimeError(f"rank {r} handed a collective of {self!r} a tensor on {x.device}")
        stacked = torch.stack(parts)
        self._result = stacked.sum(0) if ops == {"sum"} else stacked.transpose(0, 1).contiguous()
        self._slots = [None] * self.size

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        return self._collective("sum", x)

    def all_to_all(self, buckets: torch.Tensor) -> torch.Tensor:
        if buckets.shape[0] != self.size:
            raise ValueError(f"all_to_all takes ({self.size}, ...) buckets, not {tuple(buckets.shape)}")
        return self._collective("all_to_all", buckets)[self.rank()]

    def gather(self, parts: List[torch.Tensor]) -> torch.Tensor:
        if len(parts) != self.size:
            raise ValueError(f"{self!r} gathers {self.size} blocks, not {len(parts)}")
        return torch.cat(parts)
