"""KITTI odometry dataset loading (single canonical implementation).

Replaces the three duplicated loaders in the reference
(/root/reference/visual_odometry_solution_methods.py:9-33,
tracking.py:5-7, visual_odometry.py:31-56). Host-side numpy only; images
are padded to the static canvas and streamed to device by the
caller (or by the native C++ prefetcher in native/, when built).
"""

from __future__ import annotations

import os
from typing import Iterator, Tuple

import numpy as np

from slam1_tpu.ops.camera import StereoCamera


def load_calib(path: str) -> Tuple[StereoCamera, np.ndarray, np.ndarray]:
    """Parse KITTI calib.txt -> (StereoCamera, P_left, P_right).

    (ref load_calib, visual_odometry_solution_methods.py:9-18 returns
    raw K/P matrices; here the rectified-rig parameters are extracted.)
    """
    with open(path) as f:
        lines = [l.strip() for l in f if l.strip()]
    mats = {}
    for line in lines:
        if ":" in line:
            name, vals = line.split(":", 1)
        else:
            name, vals = line.split(" ", 1)
        mats[name.strip()] = np.fromstring(vals, sep=" ").reshape(3, 4)
    P0 = mats.get("P0", mats.get("P_rect_00"))
    P1 = mats.get("P1", mats.get("P_rect_01"))
    fx, fy = P0[0, 0], P0[1, 1]
    cx, cy = P0[0, 2], P0[1, 2]
    # Right-camera baseline from P1's translation term: tx = -fx * B.
    baseline = -P1[0, 3] / P1[0, 0]
    cam = StereoCamera.create(fx, fy, cx, cy, baseline)
    return cam, P0.astype(np.float32), P1.astype(np.float32)


def load_poses(path: str) -> np.ndarray:
    """GT poses: rows of 3x4 -> (N,4,4) (ref load_poses, :20-29)."""
    data = np.loadtxt(path).reshape(-1, 3, 4)
    n = data.shape[0]
    out = np.tile(np.eye(4, dtype=np.float64), (n, 1, 1))
    out[:, :3, :4] = data
    return out.astype(np.float32)


def list_images(image_dir: str) -> list:
    return sorted(
        os.path.join(image_dir, f) for f in os.listdir(image_dir)
        if f.endswith((".png", ".jpg", ".pgm")))


def load_image(path: str) -> np.ndarray:
    """Grayscale float32 [0,1]."""
    try:
        import cv2
        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise IOError(path)
    except ImportError:  # pragma: no cover
        from PIL import Image
        img = np.asarray(Image.open(path).convert("L"))
    return img.astype(np.float32) / 255.0


def pad_to_canvas(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Zero-pad an image up to the static canvas."""
    h, w = img.shape
    out = np.zeros((height, width), np.float32)
    out[:min(h, height), :min(w, width)] = img[:height, :width]
    return out


class KittiSequence:
    """Iterator over a KITTI odometry sequence directory:
    <root>/image_0/*.png, image_1/*.png, calib.txt[, poses.txt]."""

    def __init__(self, root: str, canvas_hw: Tuple[int, int],
                 poses_path: str = None, max_frames: int = None):
        self.root = root
        self.canvas = canvas_hw
        self.cam, self.P0, self.P1 = load_calib(
            os.path.join(root, "calib.txt"))
        self.lefts = list_images(os.path.join(root, "image_0"))
        self.rights = list_images(os.path.join(root, "image_1"))
        if max_frames:
            self.lefts = self.lefts[:max_frames]
            self.rights = self.rights[:max_frames]
        self.gt = None
        if poses_path and os.path.exists(poses_path):
            self.gt = load_poses(poses_path)[:len(self.lefts)]

    def __len__(self):
        return len(self.lefts)

    def frames(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        h, w = self.canvas
        for lp, rp in zip(self.lefts, self.rights):
            yield (pad_to_canvas(load_image(lp), h, w),
                   pad_to_canvas(load_image(rp), h, w))
