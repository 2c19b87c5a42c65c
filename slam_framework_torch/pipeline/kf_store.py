"""Device-resident mirror of the arena's per-keyframe feature blocks.

Port of slam_framework_tpu/pipeline/kf_store.py. The mapper's triangulation and
fusion programs consume whole keyframe feature blocks (xy/ur/octave/angle/desc).
The tracking chunk produces those blocks on the device, so the store keeps one
copy of every keyframe's block there, written once:

  - chunk-path keyframes: a device-to-device copy of the chunk's per-frame
    pack/desc outputs (no host traffic);
  - the initial keyframe: one upload from the arena via `ensure()`.

Consumers gather neighbour blocks by index (`mapping_ops.block_from_store`), so
a dispatch ships only indices, poses and candidate masks. The two tensors are
preallocated at full capacity and written in place by index.

Pack row layout (the tracker's per-frame pack, pipeline/tracker.py
`_track_core`): [x, y, u_right, depth, octave, angle, valid, slot, fuse]; only
fields 0-5 are read by consumers. Descriptors are int32 words holding the
arena's uint32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_framework_torch import resolve_device

PACK_W = 9


class DeviceKFStore:
    def __init__(self, max_keyframes: int, max_features: int, device=None):
        """device: None means the first CUDA device, an error when there is none."""
        self.device = resolve_device(device)
        K, N = max_keyframes, max_features
        self.packs = torch.zeros((K, N, PACK_W), dtype=torch.float32, device=self.device)
        self.descs = torch.zeros((K, N, 8), dtype=torch.int32, device=self.device)
        self.present = np.zeros(K, bool)

    def set_from_device(self, k: int, pack: torch.Tensor, desc: torch.Tensor) -> None:
        """Write keyframe k's block from the chunk's outputs on the device
        (pack: (N, PACK_W) f32, desc: (N, 8) int32)."""
        self.packs[k] = pack
        self.descs[k] = desc
        self.present[k] = True

    def set_from_host(self, k: int, xy, ur, depth, octave, angle, desc) -> None:
        """One-off upload for keyframes created outside the chunk path."""
        N = self.packs.shape[1]
        pack = np.zeros((N, PACK_W), np.float32)
        n = xy.shape[0]
        pack[:n, 0:2] = xy
        pack[:n, 2] = ur
        pack[:n, 3] = depth
        pack[:n, 4] = octave
        pack[:n, 5] = angle
        d = np.zeros((N, 8), np.uint32)
        d[:n] = desc
        self.set_from_device(
            k, torch.from_numpy(pack).to(self.device), torch.from_numpy(d.view(np.int32)).to(self.device)
        )

    def ensure(self, kfs, arena) -> None:
        """Upload any keyframes the chunk path did not populate."""
        for k in np.unique(np.asarray(kfs, np.int64)):
            if not self.present[k]:
                self.set_from_host(
                    int(k), arena.kf_xy[k], arena.kf_ur[k], arena.kf_depth[k],
                    arena.kf_octave[k].astype(np.float32), arena.kf_angle[k],
                    arena.kf_desc[k],
                )
