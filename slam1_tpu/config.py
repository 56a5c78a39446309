"""Typed configuration tree.

Replaces the reference's scattered hardcoded constants (SURVEY.md §5
"Config / flag system": /root/reference/main.py:34-40,75,90-106,
orb.py:4, keypoint.py:48, BundleAdjustment.py:17,124-141,182,
visual_odometry.py:19-29,89-153) with one frozen dataclass tree.

All shape-determining fields are static Python ints so that jitted
functions specialize on them (XLA static shapes).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ImageConfig:
    # KITTI odometry grayscale is 1226x370 (ref XXXport_files.py:51),
    # padded to a 376x1280 canvas (multiples of 8 and 128). The padding
    # is kept as the canvas every cell runs at; nothing on the GPU path
    # needs it.
    height: int = 376
    width: int = 1280
    # Valid region inside the padded canvas (pixels outside are masked).
    valid_height: int = 370
    valid_width: int = 1226


@dataclass(frozen=True)
class DetectorConfig:
    # Tiled detection for spatial spread (ref orb.py:4 uses 5x10 tiles
    # with 50% overlap; we use a non-overlapping grid + per-tile top-k,
    # which achieves the same spread with static shapes). The grid
    # gives a max_kp (= rows*cols*kp) that is a multiple of 128, the
    # column tile of the fused Hamming kernel (8*16*16 = 2048).
    grid_rows: int = 8
    grid_cols: int = 16
    kp_per_tile: int = 16          # per-tile top-k  (ref: 200 nfeatures/tile)
    # Scale pyramid (ref orb.py:29-33: 8 levels, scaleFactor 1.2). This
    # design uses fewer, coarser octaves with STATIC per-level
    # canvases and grids: level l is the image downsampled by
    # scale_factor**l, detected with a grid shrunk by the same factor
    # (constant tile size in pixels), coordinates mapped back to the
    # full-resolution frame. Defaults keep max_kp a multiple of 128
    # ((128+32+8)*16 = 2688), the Hamming kernel's column tile.
    num_levels: int = 3
    scale_factor: float = 2.0      # power-of-2 levels use exact avg-pool
    # Images are float32 in [0,1] everywhere in this framework (the
    # KITTI loader divides by 255). 0.08 ~ the classic "20/255" delta.
    fast_threshold: float = 0.08   # FAST-9 intensity delta threshold
    fast_arc: int = 9              # contiguous arc length for a corner
    nms_radius: int = 2            # local-max suppression window radius
    patch_size: int = 33           # descriptor/orientation patch edge
    brief_pairs: int = 256         # rBRIEF descriptor length in bits
    brief_radius: float = 13.0     # sampling pattern support radius
    blur_sigma: float = 1.4        # pre-descriptor Gaussian blur
    pattern_seed: int = 1234       # fixed rBRIEF sampling pattern seed

    def level_grid(self, level: int):
        """(grid_rows, grid_cols) of pyramid level `level`."""
        s = self.scale_factor ** level
        return (max(1, round(self.grid_rows / s)),
                max(1, round(self.grid_cols / s)))

    @property
    def max_kp(self) -> int:
        raw = sum(gr * gc * self.kp_per_tile
                  for gr, gc in (self.level_grid(l)
                                 for l in range(self.num_levels)))
        if self.num_levels == 1:
            return raw
        # Multi-level output is padded to a 128 multiple (masked slots),
        # as detector.detect_pyramid pads it.
        return -(-raw // 128) * 128


@dataclass(frozen=True)
class MatcherConfig:
    ratio: float = 0.8             # Lowe ratio test (ref keypoint.py:48: 0.7)
    max_hamming: int = 64          # absolute descriptor distance gate
    cross_check: bool = True       # mutual best match requirement
    # Rectified-stereo epipolar gate (replaces ref's FM_LMedS filter,
    # keypoint.py:59-66, which on rectified KITTI reduces to row + disparity
    # consistency):
    epipolar_dy: float = 2.0       # |y_l - y_r| tolerance in px
    min_disparity: float = 0.25
    max_disparity: float = 96.0


@dataclass(frozen=True)
class TrackingConfig:
    # Temporal 2D<->3D association + PnP (ref Point3D.py:33-53,
    # transformation.py:5-19, main.py:90-95).
    max_point_range: float = 500.0  # ref max_Distance (main.py:90)
    close_range: float = 70.0       # ref close_def_in_m (main.py:92)
    ransac_iters: int = 256         # vmapped hypothesis count
    ransac_sample: int = 6          # points per hypothesis (ref VO uses 6)
    ransac_px_thresh: float = 3.0   # inlier reprojection threshold
    gn_iters_hypo: int = 5          # GN iterations per hypothesis
    gn_iters_polish: int = 10       # GN iterations on inlier set
    min_track_points: int = 8       # fall back to previous motion below this
    huber_delta: float = 2.0        # robust loss scale in polish, px
    # Prediction-gated temporal matching: only features within this
    # radius of a prev point's constant-velocity-predicted projection
    # may match it (hamming.match_windowed). 0 disables (global match).
    gate_radius_px: float = 48.0
    # Close/far point weighting. The reference computes close/far masks
    # and then ignores them (sort_3D_points, main.py:92 — SURVEY C8);
    # here far points can be down-weighted in the PnP polish (far points
    # constrain rotation well but translation poorly). 1.0 = off.
    far_weight: float = 1.0


@dataclass(frozen=True)
class FlowConfig:
    # Pyramidal LK temporal tracking (ref visual_odometry.py:26-29 LK
    # params, :98-111 err<4 gate on [0,255] images -> 4/255 here).
    win: int = 11
    levels: int = 3
    iters: int = 10
    max_err: float = 4.0 / 255.0
    blur_sigma: float = 1.0         # pre-LK smoothing


@dataclass(frozen=True)
class DisparityConfig:
    # Dense stereo disparity (ref SGBM block=11, 32 disparities,
    # visual_odometry.py:19-23; KITTI needs more range, default 64).
    max_disp: int = 64
    radius: int = 5                 # block = 2*radius+1 (ref block=11)
    sgm: bool = True                # 2-pass semi-global aggregation
    p1: float = 0.03
    p2: float = 0.45
    lr_check: bool = True
    lr_tol: float = 1.0
    uniq_ratio: float = 0.98


@dataclass(frozen=True)
class MappingConfig:
    # Fixed-capacity world map with voxel-hash dedup (replaces the ref's
    # per-frame KDTree rebuild, keypoint.py:102-122).
    capacity: int = 1 << 17         # max landmarks in the map table
    hash_size: int = 1 << 18        # voxel hash buckets
    voxel_size: float = 0.5         # metres
    merge_radius: float = 0.5       # merge-if-closer threshold, metres
    merge_desc_gate: int = 64       # max Hamming distance (of 256 bits)
                                    # for a positional hash merge; 0 = off
    probes: int = 2                 # linear probes on hash collision.
                                    # Probe gathers dominate insert (the
                                    # batched probe is (N, 8*probes)
                                    # rows); at 2^18 buckets vs ~1e5
                                    # landmarks chains beyond 2 are rare
                                    # — halving probes saves ~1.7 ms per
                                    # insert for <<1% extra duplicates
    obs_per_frame: int = 512        # observation record slots per frame
    # Keyframe policy (the lifecycle /root/reference/local_mapping.py:2-7
    # only sketches; ref main.py:121 promotes every frame): a frame is a
    # keyframe when `keyframe_every` frames passed since the last one OR
    # translation since the last keyframe exceeds keyframe_trans (m).
    keyframe_every: int = 1
    keyframe_trans: float = 0.0     # 0 disables the motion trigger
    # Landmark culling: drop landmarks seen < cull_min_obs times once
    # they are > cull_max_age frames stale. 0 disables.
    cull_min_obs: int = 2
    cull_max_age: int = 60
    cull_every: int = 32            # host cadence of the cull pass
    max_frames: int = 8192          # trajectory buffer capacity


@dataclass(frozen=True)
class BowConfig:
    # Bag-of-visual-words place recognition (ref bag_of_words.py:10-53).
    num_words: int = 64             # vocabulary size (ref: 50 KMeans clusters)
    train_iters: int = 12           # Lloyd iterations
    query_exclude: int = 100        # don't match frames newer than this
                                    # (ref bow_threshold, main.py:40)
    # Loop trigger threshold. The reference compares chi^2 of RAW-COUNT
    # histograms against 45 (main.py:100); our histograms are
    # L1-normalized, bounding chi^2 to [0,2], so the equivalent gate is
    # a fraction of that range. Deliberately LOOSE (genuine revisits
    # from a slightly different viewpoint score ~0.17-0.22 on the test
    # clips, barely under the ~0.2-0.26 noise floor): recall comes from
    # the trigger, precision from progression-consistent confirmation +
    # geometric RANSAC verification (min_loop_inliers).
    chi2_accept: float = 0.22
    rearm_frames: int = 100         # re-arm delay after a closure (main.py:106)
    # Geometric-verification precision gates. A loop edge is weighted
    # ~1000x in the pose graph (BAConfig.pg_loop_weight), so acceptance
    # must be much stricter than frame-to-frame tracking's
    # min_track_points=8: require >= min_loop_inliers PnP inliers AND a
    # PROGRESSION-CONSISTENT candidate across `confirm_polls`
    # consecutive polls before verification fires. Progression
    # consistency: on a genuine revisit the BoW candidate ADVANCES with
    # the camera (~poll-gap frames between polls, either direction), so
    # consecutive polls must show some candidate pair whose index
    # difference matches the elapsed frames within +-candidate_tol —
    # NOT the same index (that would reject every moving revisit).
    # Observed margins (600-frame bench clip): genuine loop pairs score
    # 17-205 RANSAC inliers, spurious BoW candidates 0-2 — 15 keeps a
    # wide precision margin while recovering offset revisits whose
    # viewpoint difference halves the match count.
    min_loop_inliers: int = 15
    confirm_polls: int = 2
    candidate_tol: int = 2
    # A hit FAR below the accept threshold (near-exact revisit) skips
    # the multi-poll confirmation: it cannot plausibly be histogram
    # noise, and end-of-sequence closures may only ever see one poll.
    chi2_strong: float = 0.05
    backfill_desc_per_frame: int = 2048  # descriptor sample per frame; ALL
                                    # DB rows (live + backfilled) build
                                    # their histogram from this sample so
                                    # every row has the same chi^2 noise
                                    # floor ~(num_words-1)/(2*this).
                                    # 2048 puts the floor (~0.015) well
                                    # under a genuine-but-offset revisit
                                    # (~0.02-0.03) — at 1024 the floor
                                    # EQUALS the genuine score and the
                                    # argmin is a coin flip
    loop_poll_every: int = 4        # host polls the device trigger flag
                                    # every N frames (avoids a per-frame
                                    # device->host sync)
    # Brute-force place recognition (models/loop_closure.place_query):
    # at each drain the newest keyframe's snapshot is matched against
    # every stored keyframe snapshot; the BoW histogram path
    # below remains as the per-frame trigger/telemetry and as the
    # retrieval for small-canvas configs where the exhaustive product
    # is slower than its recall is worth (tiny_config disables this).
    place_query: bool = True
    place_thresh: int = 32          # per-descriptor Hamming accept
                                    # (genuine correspondences sit at
                                    # ~5-20 bits, lookalike noise at 40+)
    place_topk: int = 3             # candidates verified per drain
    place_nms_frames: int = 50      # min frame gap between candidates
    # Batched-drain mode switch. > 0: per-frame metrics accumulate in
    # the DEVICE-side ring (SlamState.rows) and a fetch thread reads the
    # ring as ONE array per poll_max_pending frames, so the camera loop
    # never waits on a device->host read. 0 = drain at every poll
    # (synchronous, deterministic; the tests' configuration).
    # finalize() and checkpoints force-drain.
    poll_lag_s: float = 0.05
    # Force-drain backstop on queue depth: the fetcher's device reads
    # queue behind the continuously-streaming step dispatches, so
    # without a bound they can be deferred to finalize() and every loop
    # closure with them. A small bound forces one blocking mini-drain
    # (~a pipeline bubble) per poll_max_pending frames so
    # detection/verification/PGO run LIVE, lagging the camera by at
    # most this many frames — within verify_loop_pair's lag tolerance
    # by design.
    poll_max_pending: int = 64
    sample_desc_per_frame: int = 128  # descriptors sampled per frame for vocab


@dataclass(frozen=True)
class BAConfig:
    # Backend optimization (ref BundleAdjustment.py).
    window: int = 5                 # local BA keyframe window
    local_every: int = 5            # run windowed local BA every N keyframes
                                    # inside SlamSystem (0 disables)
    local_lm_iters: int = 4         # LM iterations for the local window
    lm_iters: int = 15              # Levenberg-Marquardt outer iterations
    lm_lambda0: float = 1e-3
    lm_lambda_up: float = 4.0
    lm_lambda_down: float = 2.0
    huber_delta: float = 2.0        # robust reprojection loss, px
    # Hard IRLS rejection: observations whose residual norm exceeds this
    # (px) get weight 0 for the iteration (Huber alone leaves gross
    # outliers a constant gradient pull; the reference's dormant BA
    # clamps them the same way, BundleAdjustment.py:339-350). 0 = off.
    outlier_px: float = 16.0
    pg_iters: int = 25              # pose-graph GN iterations
    pg_loop_weight: float = 1000.0  # loop constraint weight (ref :140-141)
    # Pose-prior weights for GLOBAL BA (models/ba BAProblem.pe_*): the
    # odometry-chain prior pins the reprojection-soft global modes
    # (reprojection curvature per camera ~ 2e5 per unit twist^2 at
    # KITTI scale; 1e4 regularizes the soft modes without fighting
    # locally-informative observations), the loop prior pins verified
    # closures hard. Without them a global BA measurably UNDOES the
    # pose graph: cost 699 -> 29M while keyframe ATE went 3.1 -> 4.9 m
    # (r5 config-4 experiment). The reference's active backend is the
    # pose-only special case of this (BundleAdjustment.py:107-183).
    prior_odo_weight: float = 1e4
    prior_loop_weight: float = 1e6
    # One-shot pre-solve association gate for GLOBAL BA (px): zero the
    # weight of observations whose initial residual norm exceeds this
    # before the solve. The observation store carries a ~0.1% garbage
    # tail (mis-inherited identities, voxel-merge gluings, z-clamped
    # points with 1e6+ px residuals) that holds 99% of the initial
    # reprojection cost and wrecks LM (see pipeline.global_ba_step).
    # 256 px keeps drift-informative cross-lap observations (measured
    # p99.9 of genuine residuals ~138 px post-PGO) while removing the
    # catastrophic tail. 0 = off.
    global_trim_px: float = 256.0
    # per-axis motion-prior weights, ref BundleAdjustment.py:124-129
    motion_prior: tuple = (1.0, 1.0, 5e-4, 0.5, 0.05, 1.0)
    cg_iters: int = 64              # CG iterations for the reduced camera system


@dataclass(frozen=True)
class RuntimeConfig:
    dtype: str = "float32"
    seed: int = 0
    log_every: int = 50
    profile: bool = False
    checkpoint_every: int = 0       # frames; 0 disables
    checkpoint_dir: str = "checkpoints"


@dataclass(frozen=True)
class SlamConfig:
    image: ImageConfig = field(default_factory=ImageConfig)
    detector: DetectorConfig = field(default_factory=DetectorConfig)
    matcher: MatcherConfig = field(default_factory=MatcherConfig)
    flow: FlowConfig = field(default_factory=FlowConfig)
    disparity: DisparityConfig = field(default_factory=DisparityConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)
    bow: BowConfig = field(default_factory=BowConfig)
    ba: BAConfig = field(default_factory=BAConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)

    def replace(self, **kw) -> "SlamConfig":
        return dataclasses.replace(self, **kw)


def tiny_config() -> SlamConfig:
    """Small config for unit tests / CPU: small images, few keypoints."""
    return SlamConfig(
        image=ImageConfig(height=128, width=256, valid_height=128,
                          valid_width=256),
        detector=DetectorConfig(grid_rows=2, grid_cols=4, kp_per_tile=24,
                                num_levels=1),
        mapping=MappingConfig(capacity=1 << 12, hash_size=1 << 13,
                              obs_per_frame=192, max_frames=512),
        bow=BowConfig(num_words=64, train_iters=6, query_exclude=10,
                      sample_desc_per_frame=64, backfill_desc_per_frame=192,
                      poll_lag_s=0.0,
                      # CPU-test scale: the brute-force place query is
                      # a large matrix product (a 275-GFLOP scan per
                      # query at even a 512-row bucket) — the BoW
                      # trigger path retrieves fine at 36-72-frame clip
                      # scale and keeps the suite fast.
                      place_query=False,
                      # Calibrated to test-canvas data richness: at
                      # fx~150 the triangulated depth noise is metres
                      # (sigma_z ~ z^2 sigma_d / (fx b)), so genuine
                      # pairs land ~10-20 inliers under the 3 px RANSAC
                      # gate (10 when the anchor keyframe is a couple
                      # of frames off the hit) while spurious
                      # candidates stay at 0-4 — 9 keeps a >2x margin,
                      # the same ratio the production 15 has at full
                      # resolution; test_pipeline_no_false_loops guards
                      # the precision side.
                      min_loop_inliers=9),
        # Wider prediction gate: the tiny test clips turn 10-50 deg per
        # frame, so the constant-velocity prediction misses by far more
        # than at KITTI-like motion.
        tracking=TrackingConfig(ransac_iters=64, gate_radius_px=96.0),
        disparity=DisparityConfig(max_disp=32, radius=3),
    )
