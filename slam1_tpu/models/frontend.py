"""Stereo frontend: detect both images, match L<->R, triangulate.

Covers the reference chain orb_detector_using_tiles ->
track_keypoints_left_to_right_new -> triangulate_points_local
(/root/reference/main.py:79-86, keypoint.py:35-80, Point3D.py:14-19).

The reference filters L-R matches with cv2.findFundamentalMat(LMedS);
on a rectified rig the fundamental matrix is known a-priori ([e]_x), so
the geometrically identical but trivially parallel filter is the epipolar gate
|y_l - y_r| < eps plus a disparity window — pure elementwise masking.
(The general 8-point RANSAC F-estimator for non-rectified input lives in
ops/epipolar.py and is used by the calibration-free path.)
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from slam1_tpu.config import SlamConfig
from slam1_tpu.ops import detector, hamming, triangulate
from slam1_tpu.ops.camera import StereoCamera
from slam1_tpu.types import Features, StereoObservations


@functools.partial(jax.jit, static_argnames=("cfg",))
def stereo_frontend(left, right, cam: StereoCamera,
                    cfg: SlamConfig) -> Tuple[Features, StereoObservations]:
    """-> (left Features, StereoObservations aligned to left's capacity)."""
    # One vmapped launch for both images: doubles the batch of every
    # frontend contraction instead of running two half-sized programs.
    feats2 = jax.vmap(lambda im: detector.detect_pyramid(
        im, cfg.detector, cfg.image.valid_height,
        cfg.image.valid_width))(jnp.stack([left, right]))
    feats_l = jax.tree.map(lambda a: a[0], feats2)
    feats_r = jax.tree.map(lambda a: a[1], feats2)

    # Epipolar-band-constrained matching: the band is applied to the
    # distance matrix BEFORE best/second-best selection, so the Lowe
    # ratio compares against geometrically-plausible rivals only (see
    # hamming.match_epipolar — post-hoc gating of a global match loses
    # most true stereo pairs on self-similar imagery).
    m = hamming.match_epipolar(
        feats_l.desc, feats_r.desc, feats_l.xy, feats_r.xy,
        feats_l.mask, feats_r.mask,
        ratio=cfg.matcher.ratio,
        max_distance=cfg.matcher.max_hamming,
        dy_tol=cfg.matcher.epipolar_dy,
        min_disparity=cfg.matcher.min_disparity,
        max_disparity=cfg.matcher.max_disparity,
        cross_check=cfg.matcher.cross_check)

    uv_l = feats_l.xy
    uv_r = feats_r.xy[m.idx]
    valid = m.mask

    xyz, tri_ok = triangulate.stereo_rectified(
        cam, uv_l, uv_r, min_disparity=cfg.matcher.min_disparity)
    valid = valid & tri_ok

    obs = StereoObservations(
        uv_l=uv_l,
        uv_r=jnp.where(valid[:, None], uv_r, 0.0),
        xyz=jnp.where(valid[:, None], xyz, 0.0),
        desc=feats_l.desc,
        mask=valid,
        score=feats_l.score,
    )
    return feats_l, obs
