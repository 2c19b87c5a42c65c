"""KITTI odometry sequence IO.

Replaces the reference's example loaders (reference: examples/main_stereo.cpp:16-49,
examples/main_mono.cpp:18-51): a sequence directory holds `times.txt` and image
folders `image_2/` (left) + `image_3/` (right) of zero-padded 6-digit PNGs; ground
truth poses live in `<dataset>/ground_truth_poses/poses/<seq>.txt` (KITTI 3x4 rows,
Twc of the left camera — tools/python_plot.py:17-24).

Grayscale KITTI sequences (image_0/image_1) are auto-detected as a fallback.

Copy of slam_framework_tpu/io/kitti.py that reads its images with io/png.py
instead of cv2.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional, Tuple

import numpy as np

from slam_framework_torch.io.png import imread_gray


@dataclasses.dataclass
class KittiSequence:
    """Lazy stereo sequence: images are read (and grayscaled) per access."""

    left_paths: list
    right_paths: list
    timestamps: np.ndarray  # (F,) seconds

    def __len__(self) -> int:
        return len(self.left_paths)

    @property
    def num_frames(self) -> int:
        return len(self.left_paths)

    def _read_gray(self, path: str) -> np.ndarray:
        return imread_gray(path)

    def stereo_pair(self, f: int) -> Tuple[np.ndarray, np.ndarray]:
        return self._read_gray(self.left_paths[f]), self._read_gray(self.right_paths[f])

    def mono(self, f: int) -> np.ndarray:
        return self._read_gray(self.left_paths[f])

    def frames(self) -> Iterator[Tuple[int, float, np.ndarray, np.ndarray]]:
        for f in range(len(self)):
            l, r = self.stereo_pair(f)
            yield f, float(self.timestamps[f]), l, r


def load_sequence(seq_dir: str) -> KittiSequence:
    """Load a KITTI odometry sequence directory (examples/main_stereo.cpp:16-49)."""
    times_path = os.path.join(seq_dir, "times.txt")
    timestamps = np.loadtxt(times_path).reshape(-1)
    for left_name, right_name in (("image_2", "image_3"), ("image_0", "image_1")):
        left_dir = os.path.join(seq_dir, left_name)
        right_dir = os.path.join(seq_dir, right_name)
        if os.path.isdir(left_dir):
            break
    else:
        raise FileNotFoundError(f"no image_2/ or image_0/ under {seq_dir}")
    n = len(timestamps)
    left = [os.path.join(left_dir, f"{i:06d}.png") for i in range(n)]
    if os.path.isdir(right_dir):
        right = [os.path.join(right_dir, f"{i:06d}.png") for i in range(n)]
    else:
        right = list(left)  # mono-only sequence
    missing = [p for p in (left[0], left[-1]) if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(missing[0])
    return KittiSequence(left_paths=left, right_paths=right, timestamps=timestamps)


def load_ground_truth(dataset_root: str, seq: str) -> Optional[np.ndarray]:
    """Ground-truth Twc poses (F, 4, 4) or None if absent (python_plot.py:17-24)."""
    path = os.path.join(dataset_root, "ground_truth_poses", "poses", f"{seq}.txt")
    if not os.path.exists(path):
        # also accept the plain KITTI layout poses/<seq>.txt
        path = os.path.join(dataset_root, "poses", f"{seq}.txt")
        if not os.path.exists(path):
            return None
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    out = np.tile(np.eye(4), (len(rows), 1, 1))
    out[:, :3, :] = rows
    return out
