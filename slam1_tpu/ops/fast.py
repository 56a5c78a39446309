"""FAST-9 corner scoring, fully vectorized over the image.

Replaces cv2.ORB's FAST stage and cv2.FastFeature (reference
orb.py:28-38, visual_odometry.py:86-96). Instead of a
per-pixel branchy scan, the 16 Bresenham-circle taps are visited as 16
shifted slices of the edge-padded image, in circular order and then 8
more, counting the current run of brighter (darker) taps at every
pixel: a pixel is a corner when a run reaches `arc`. Everything is
elementwise on slices of one input, so XLA compiles the whole score
into one fusion that reads the image once and writes the score once.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# Bresenham circle of radius 3, 16 taps in circular order: (dy, dx).
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
BORDER = 3


@functools.partial(jax.jit, static_argnames=("arc",))
def fast_score(img, threshold, arc: int = 9):
    """FAST corner score map.

    Args:
      img: (H,W) float32 grayscale.
      threshold: intensity delta for brighter/darker classification.
      arc: required contiguous arc length (9 = FAST-9).
    Returns:
      (H,W) float32 score map; 0 at non-corners. Score is the sum of
      above-threshold absolute differences over the dominant polarity
      (OpenCV's FAST score variant, good for NMS ranking).
    """
    h, w = img.shape
    pad = jnp.pad(img, BORDER)
    run_b = run_d = jnp.zeros((h, w), jnp.int32)
    corner = jnp.zeros((h, w), bool)
    score_b = score_d = jnp.zeros((h, w), img.dtype)
    # 16 + arc - 1 taps: a run that wraps past tap 15 is still counted.
    for t in range(len(CIRCLE) + arc - 1):
        dy, dx = CIRCLE[t % len(CIRCLE)]
        diff = pad[BORDER + dy:BORDER + dy + h,
                   BORDER + dx:BORDER + dx + w] - img
        run_b = jnp.where(diff > threshold, run_b + 1, 0)
        run_d = jnp.where(diff < -threshold, run_d + 1, 0)
        corner = corner | (run_b >= arc) | (run_d >= arc)
        if t < len(CIRCLE):
            score_b = score_b + jnp.maximum(diff - threshold, 0.0)
            score_d = score_d + jnp.maximum(-diff - threshold, 0.0)
    score = jnp.where(corner, jnp.maximum(score_b, score_d), 0.0)
    # No full circle within BORDER of the edge.
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    inside = ((ys >= BORDER) & (ys < h - BORDER)
              & (xs >= BORDER) & (xs < w - BORDER))
    return jnp.where(inside, score, 0.0)


def nms(score, radius: int = 2):
    """Local-maximum suppression: keep pixels equal to the window max."""
    k = 2 * radius + 1
    neigh = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (k, k), (1, 1), "SAME")
    return jnp.where((score >= neigh) & (score > 0.0), score, 0.0)
