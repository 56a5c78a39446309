"""slam1_tpu — a stereo visual SLAM framework in JAX, run on an NVIDIA GPU.

A from-scratch rebuild of the capabilities of the reference pipeline
(DavidHan008/SLAM-1, see SURVEY.md): fixed-capacity masked tensors,
jit/vmap geometry, a Pallas kernel for descriptor matching, batched
Schur-complement bundle adjustment, and keyframe/landmark sharding
across device meshes.

Layers (bottom-up), mirroring SURVEY.md §1's logical layer map:
  ops/      — SE(3)/camera math, FAST/BRIEF kernels, Hamming matcher,
              RANSAC/PnP, LM/GN solvers, KMeans        (replaces L1-L2)
  models/   — frontend, tracker, mapping, BoW, loop closure, BA,
              full pipeline driver                      (replaces L3-L6)
  parallel/ — mesh construction, sharded frontend, distributed BA
  utils/    — KITTI + synthetic data, ATE/RPE eval, checkpointing,
              structured metrics                        (replaces L0, L7)
"""

__version__ = "0.1.0"

from slam1_tpu import runtime  # noqa: F401  (config side effects)
from slam1_tpu.config import SlamConfig  # noqa: F401
