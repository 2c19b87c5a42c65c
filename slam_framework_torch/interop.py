"""Carry the reference package's state into the port's tensors.

The JAX package's `FrameData`, `DeviceTrackState`, `PointBlock`, `BAProblem`,
`KFBlock`, `DeviceKFStore`, `Vocabulary`, `PoseGraphProblem`, `GlobalBAProblem`
and `MapArena` are handed over as numpy arrays (any object whose fields have
the same names, e.g. the JAX NamedTuples after `np.asarray`). Descriptors, uint32 there, become
int32 tensors with the same bits. This module never imports the reference.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from slam_framework_torch.bow.vocabulary import Vocabulary
from slam_framework_torch.config import CapacityConfig
from slam_framework_torch.map.arena import MapArena
from slam_framework_torch.optim.global_ba import GlobalBAProblem
from slam_framework_torch.optim.local_ba import BAProblem
from slam_framework_torch.optim.pose_graph import PoseGraphProblem
from slam_framework_torch.pipeline.frame import FrameData
from slam_framework_torch.pipeline.kf_store import DeviceKFStore
from slam_framework_torch.pipeline.mapping_ops import KFBlock
from slam_framework_torch.pipeline.track_ops import PointBlock
from slam_framework_torch.pipeline.tracker import DeviceTrackState


def to_tensor(a, device=None) -> torch.Tensor:
    """numpy-convertible array -> tensor; uint32 arrays keep their bits as int32."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def _named(cls, src, device):
    return cls(*[to_tensor(getattr(src, name), device) for name in cls._fields])


def frame_data(src, device=None) -> FrameData:
    return _named(FrameData, src, device)


def track_state(src, device=None) -> DeviceTrackState:
    return _named(DeviceTrackState, src, device)


def point_block(src, device=None) -> PointBlock:
    return _named(PointBlock, src, device)


def ba_problem(src, device=None) -> BAProblem:
    return _named(BAProblem, src, device)


def pose_graph_problem(src, device=None) -> PoseGraphProblem:
    """A reference PoseGraphProblem, whole or sharded (`dist_pose_graph.shard_problem`:
    the edge arrays are the concatenation of the shard blocks, as the port's)."""
    return _named(PoseGraphProblem, src, device)


def global_ba_problem(src, device=None) -> GlobalBAProblem:
    """A reference GlobalBAProblem, whole or sharded (`dist_ba.shard_problem`:
    point and observation arrays concatenated by shard, cam_obs_slots (D, C, Oc),
    as the port's `parallel/dist_ba.shard_problem` lays them out). A sharded
    jax.Array of a mesh in this process converts as a whole."""
    return _named(GlobalBAProblem, src, device)


def vocabulary(src) -> Vocabulary:
    """A host copy of a reference vocabulary (its tables are numpy arrays)."""
    return Vocabulary(**{f.name: copy.deepcopy(getattr(src, f.name)) for f in dataclasses.fields(Vocabulary)})


def kf_block(src, device=None) -> KFBlock:
    return _named(KFBlock, src, device)


def kf_store(src, device=None) -> DeviceKFStore:
    """A keyframe store holding the blocks of a reference store (its `packs`,
    `descs` and `present` as numpy-convertible arrays)."""
    packs = np.asarray(src.packs)
    store = DeviceKFStore(packs.shape[0], packs.shape[1], device=device)
    store.packs.copy_(to_tensor(packs))
    store.descs.copy_(to_tensor(src.descs))
    store.present[:] = np.asarray(src.present)
    return store


def to_numpy(t: torch.Tensor, uint32: bool = False) -> np.ndarray:
    """Tensor -> numpy; uint32=True views int32 descriptor words as uint32."""
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if uint32 else a


def arena(src) -> MapArena:
    """Copy a reference MapArena field by field (host numpy, so a deep copy)."""
    fields = {f.name: copy.deepcopy(getattr(src, f.name)) for f in dataclasses.fields(MapArena)}
    fields["cap"] = CapacityConfig(**dataclasses.asdict(src.cap))
    return MapArena(**fields)
