"""Map checkpoint / resume.

Port of slam_framework_tpu/io/checkpoint.py: the map is arrays and masks
(map/arena.py), so a checkpoint is one compressed npz holding the arena, the
trajectory records and the (possibly online-trained) vocabulary. The keys and
`FORMAT_VERSION` are the reference's, so a file written by either package loads
in the other. `SlamSystem.load_map` rebuilds a system that relocalizes against
the saved map.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from slam_framework_torch.bow.vocabulary import Vocabulary
from slam_framework_torch.config import CapacityConfig
from slam_framework_torch.map.arena import MapArena

FORMAT_VERSION = 1

_ARENA_SCALARS = ("num_kfs", "num_pts", "next_point_id")


def save_map(path: str, arena: MapArena, records=None, vocab: Optional[Vocabulary] = None) -> None:
    """Write the full map state (+ optional trajectory records and vocabulary)."""
    blob = {"format_version": np.int64(FORMAT_VERSION)}
    for f in dataclasses.fields(arena):
        v = getattr(arena, f.name)
        if isinstance(v, np.ndarray):
            blob[f"arena/{f.name}"] = v
    for name in _ARENA_SCALARS:
        blob[f"arena/{name}"] = np.int64(getattr(arena, name))
    for f in dataclasses.fields(arena.cap):
        blob[f"cap/{f.name}"] = np.asarray(getattr(arena.cap, f.name))
    if records is not None:
        n = len(records)
        rel = np.full((n, 4, 4), np.nan, np.float64)
        pose = np.full((n, 4, 4), np.nan, np.float32)
        meta = np.zeros((n, 3), np.float64)  # frame_id, timestamp, ref_kf
        lost = np.zeros(n, bool)
        for i, r in enumerate(records):
            meta[i] = (r.frame_id, r.timestamp, r.ref_kf)
            lost[i] = r.lost
            if r.pose is not None:
                pose[i] = r.pose
            if r.rel_pose is not None:
                rel[i] = r.rel_pose
        blob.update({"rec/meta": meta, "rec/lost": lost, "rec/pose": pose, "rec/rel": rel})
    if vocab is not None:
        blob.update({
            "vocab/k": np.int64(vocab.k),
            "vocab/depth": np.int64(vocab.depth),
            "vocab/levelsup": np.int64(vocab.levelsup),
            "vocab/node_desc": vocab.node_desc,
            "vocab/node_children": vocab.node_children,
            "vocab/node_weight": vocab.node_weight,
            "vocab/node_word": vocab.node_word,
        })
    np.savez_compressed(path, **blob)


def load_map(path: str):
    """Read a checkpoint -> (arena, records, vocab); records / vocab may be None."""
    from slam_framework_torch.pipeline.tracker import FrameRecord

    with np.load(path, allow_pickle=False) as z:
        version = int(z["format_version"])
        if version > FORMAT_VERSION:
            raise ValueError(f"checkpoint format {version} is newer than supported {FORMAT_VERSION}")
        cap_kwargs = {}
        arrays = {}
        scalars = {}
        for key in z.files:
            if key.startswith("cap/"):
                v = z[key]
                cap_kwargs[key[4:]] = v.item() if v.ndim == 0 else v
            elif key.startswith("arena/"):
                name = key[6:]
                if name in _ARENA_SCALARS:
                    scalars[name] = int(z[key])
                else:
                    arrays[name] = z[key]
        arena = MapArena(cap=CapacityConfig(**cap_kwargs), **arrays, **scalars)

        records = None
        if "rec/meta" in z.files:
            meta, lost = z["rec/meta"], z["rec/lost"]
            pose, rel = z["rec/pose"], z["rec/rel"]
            records = []
            for i in range(len(meta)):
                p = None if np.isnan(pose[i]).any() else pose[i]
                rl = None if np.isnan(rel[i]).any() else rel[i]
                records.append(FrameRecord(int(meta[i, 0]), float(meta[i, 1]), p, bool(lost[i]),
                                           int(meta[i, 2]), rl))

        vocab = None
        if "vocab/node_desc" in z.files:
            vocab = Vocabulary(
                k=int(z["vocab/k"]), depth=int(z["vocab/depth"]),
                node_desc=z["vocab/node_desc"], node_children=z["vocab/node_children"],
                node_weight=z["vocab/node_weight"], node_word=z["vocab/node_word"],
                levelsup=int(z["vocab/levelsup"]),
            )
    return arena, records, vocab
