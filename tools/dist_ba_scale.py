"""Distributed BA on the REAL config-4 problem (r4 VERDICT missing #3).

Loads a config-4 checkpoint (the 1000-keyframe problem produced by
tools/global_ba_scale.py --ckpt), partitions it with
`partition_problem_device` over an 8-device mesh, runs
`distributed_bundle_adjust`, and compares the LM cost trajectory and
final poses against the single-chip `bundle_adjust` on the SAME problem:

  - asserts n_dropped == 0 at full per-shard headroom,
  - asserts relative final-cost parity < 5e-2 (final poses are
    reported, not asserted: reprojection-only soft modes, see below),
  - reports both cost traces side by side.

The graduated outlier cut (BAConfig.outlier_px) exists only in the
single-chip LM loop, so both sides run with outlier_px=0 here — the
point is solver parity at scale, not robustness tuning.

Backend: --devices virtual CPU devices. `python chip_smoke.py --cards 4`
runs the same comparison on four cards, on a problem made from a seed.

Usage:
  python tools/dist_ba_scale.py --ckpt .scratch/gba2000.npz \
      [--out PATH.json] [--lm-iters 6] [--cg-iters 32]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", type=str, default=".scratch/gba2000.npz")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--lm-iters", type=int, default=6)
    ap.add_argument("--cg-iters", type=int, default=32)
    ap.add_argument("--devices", type=int, default=8)
    args = ap.parse_args()
    os.chdir(_REPO)

    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={args.devices}")
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from slam1_tpu.models import pipeline
    from slam1_tpu.models.ba import bundle_adjust
    from slam1_tpu.parallel.dist_ba import (distributed_bundle_adjust,
                                            partition_problem_device)
    from slam1_tpu.parallel.mesh import make_mesh
    from tools.global_ba_scale import make_scale_world, scale_config

    assert len(jax.devices()) >= args.devices, (
        f"need {args.devices} devices, have {len(jax.devices())}")

    cfg = scale_config()
    # Parity config: no graduated outlier cut (single-chip-only feature)
    ba_cfg = dataclasses.replace(cfg.ba, lm_iters=args.lm_iters,
                                 cg_iters=args.cg_iters, outlier_px=0.0)

    sys_ = pipeline.SlamSystem.resume(
        args.ckpt, make_scale_world(8).cam, cfg)
    st = sys_.state
    n_kf = int(st.kf.n)
    bucket = next((b for b in (128, 512, 1024, 2048, 8192) if b >= n_kf),
                  n_kf)
    bucket = min(bucket, st.kf.xyz.shape[0])
    n_obs_real = int(np.asarray(jnp.sum(st.map.obs_count[:bucket])))
    obs_bucket = 1 << max(int(np.ceil(np.log2(max(n_obs_real, 1)))), 10)
    prob, _frames = pipeline.build_global_problem(st, bucket, obs_bucket)
    n_obs = int(np.asarray(jnp.sum(prob.w > 0)))
    print(f"problem: {n_kf} keyframes, {n_obs} observations "
          f"(bucket {obs_bucket}), L={prob.points.shape[0]}",
          file=sys.stderr)

    mesh = make_mesh(args.devices, lm_axis=args.devices)
    shards = mesh.shape["lm"]
    # Full per-shard headroom: landmark blocks are insertion-ordered and
    # spatially clustered, so per-shard observation counts are far from
    # uniform at SLAM scale.
    t0 = time.perf_counter()
    sharded, orig, n_dropped = partition_problem_device(
        prob, shards, obs_per_shard=obs_bucket)
    n_dropped = int(n_dropped)
    t_part = time.perf_counter() - t0
    assert n_dropped == 0, (
        f"partitioner dropped {n_dropped} observations at full headroom")

    world_cam = sys_.cam     # kitti_default: frame-count independent
    t0 = time.perf_counter()
    out_d, cost_d, trace_d = distributed_bundle_adjust(
        sharded, world_cam, ba_cfg, mesh, return_trace=True)
    trace_d = np.asarray(trace_d)
    t_dist = time.perf_counter() - t0

    t0 = time.perf_counter()
    out_s, cost_s, trace_s = bundle_adjust(prob, world_cam, ba_cfg,
                                           return_trace=True)
    trace_s = np.asarray(trace_s.cost)
    t_single = time.perf_counter() - t0

    rel = abs(float(cost_d) - float(cost_s)) / max(float(cost_s), 1.0)
    # Pose difference is REPORTED, not asserted: without pose priors the
    # reprojection-only objective has globally-soft modes (only camera 0
    # is gauge-pinned), and two differently-inexact LM paths that agree
    # on cost to ~2% can sit metres apart along them (same effect
    # measured for the single-chip solver with/without priors).
    pose_err = float(jnp.abs(out_d.poses[:, :3, 3]
                             - out_s.poses[:, :3, 3]).max())
    print(f"dist cost trace:   {[round(float(c), 1) for c in trace_d]}",
          file=sys.stderr)
    print(f"single cost trace: {[round(float(c), 1) for c in trace_s]}",
          file=sys.stderr)
    print(f"final: dist {float(cost_d):.1f} vs single "
          f"{float(cost_s):.1f} (rel {rel:.2e}), max pose t-err "
          f"{pose_err:.2e} m", file=sys.stderr)
    assert rel < 5e-2, f"cost parity {rel} >= 5e-2"

    out = {
        "keyframes": n_kf,
        "observations": n_obs,
        "landmark_capacity": int(prob.points.shape[0]),
        "shards": shards,
        "n_dropped": n_dropped,
        "partition_wall_s": round(t_part, 3),
        "lm_iters": args.lm_iters,
        "cg_iters": args.cg_iters,
        "cost_trace_dist": [round(float(c), 1) for c in trace_d],
        "cost_trace_single": [round(float(c), 1) for c in trace_s],
        "final_cost_dist": round(float(cost_d), 1),
        "final_cost_single": round(float(cost_s), 1),
        "rel_cost_parity": rel,
        "max_pose_t_err_m": pose_err,
        "dist_wall_s": round(t_dist, 2),
        "single_wall_s": round(t_single, 2),
        "backend": jax.default_backend(),
        "note": f"{args.devices} virtual CPU devices",
    }
    print(json.dumps(out))
    if args.out:
        json.dump(out, open(args.out, "w"), indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
