"""The stages of a frame's device program, replayed as CUDA graphs.

A stage is a body that reads tensors held at fixed addresses and writes its
results into tensors held at fixed addresses (`keep`), so that one capture of
it serves every later frame: the tracker (pipeline/tracker.py) copies each
frame's inputs into the held tensors and replays. On the first call with a key
the body runs eagerly on a side stream, which is that call's result and the
warm-up that capture needs (lazily made handles, workspaces and constants),
and is then captured on the same stream into one memory pool that all the
stages share: nothing a stage leaves behind lives in the pool, so the graphs
may replay in any order. Every later call with the key replays.

Off the card the same bodies run directly over the same held tensors. A copy
of the owner (`copy.deepcopy`, as tools/replay_blackout.py copies a system)
starts with no graph and nothing held, and captures again on its own device.
"""

from __future__ import annotations

import enum
from typing import Callable, Dict, Hashable, Sequence, Tuple

import torch


class Ran(enum.Enum):
    """How a stage ran: replayed, captured (after its eager first run), or eagerly."""

    REPLAY = "replay"
    CAPTURE = "capture"
    EAGER = "eager"


def copy_into(held: Sequence[torch.Tensor], tensors: Sequence[torch.Tensor]) -> None:
    """Copy each of `tensors` into the held tensor beside it; the shapes must agree."""
    for dst, src in zip(held, tensors, strict=True):
        if dst.shape != src.shape:
            raise ValueError(f"a held tensor of shape {tuple(dst.shape)} given one of {tuple(src.shape)}")
        dst.copy_(src)


def hold(held, tensors):
    """`tensors` copied into `held`, which is returned; where nothing is held
    yet (None), contiguous clones of them, as the same named tuple (or a tuple)."""
    if held is not None:
        copy_into(held, tensors)
        return held
    clones = [t.clone(memory_format=torch.contiguous_format) for t in tensors]
    return tensors._make(clones) if hasattr(tensors, "_make") else tuple(clones)


class StageGraphs:
    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.held: Dict[Hashable, Tuple[torch.Tensor, ...]] = {}
        self._graphs: Dict[Hashable, torch.cuda.CUDAGraph] = {}
        self._stream = None
        self._pool = None

    def __deepcopy__(self, memo) -> "StageGraphs":
        return StageGraphs(self.device)

    def keep(self, key: Hashable, tensors: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """Hold `tensors` under `key` (`hold`) and return the held ones."""
        held = self.held[key] = hold(self.held.get(key), tensors)
        return held

    def _capturable(self) -> bool:
        return self.device.type == "cuda"

    def run(self, key: Hashable, body: Callable[[], object]) -> Ran:
        """Run `body`, which reads and writes held tensors only: replay its
        graph, or run it and capture it on the first call with `key`."""
        if not self._capturable():
            body()
            return Ran.EAGER
        graph = self._graphs.get(key)
        if graph is not None:
            graph.replay()
            return Ran.REPLAY
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            body()
        current.wait_stream(self._stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream, capture_error_mode="thread_local"):
            body()
        self._graphs[key] = graph
        return Ran.CAPTURE
