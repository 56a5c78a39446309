"""Bring-up smoke test of the SLAM pipeline on an NVIDIA GPU.

    python chip_smoke.py            # one card: phases 1-6 below
    python chip_smoke.py --cards 4  # four cards: distributed BA and
                                    # sharded PGO against one card, only

One card, one process, in order; any failure exits non-zero:

  1. device     platform, kind and count as JAX reports them, and the
                card's name and power limit from nvidia-smi; anything
                but a GPU stops here
  2. compile    every jitted step of the main path at production width
                (SlamConfig: 376x1280 canvas, 3 levels, max_kp 2688,
                2^17-landmark map), with compiled.memory_analysis()
  3. parity     the fused Hamming kernel against the plain reference on
                the same card (exact), and rBRIEF descriptors on the
                card against the CPU
  4. pipeline   SlamSystem over the 600-frame two-lap synthetic clip,
                then finalize(): finite poses, >= 1 loop closure, ATE
                <= 5 m without alignment
  5. ba         `slam ba --state` on a checkpoint of that system
  6. tests      the tests marked `gpu`, in this process

The last line of standard output is {"ok": true, "device": {...}}.
Times printed here include compilation and are information only.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

_REPO = os.path.dirname(os.path.abspath(__file__))
BLOCK = 32                 # frames per slam_step_block program
CLIP_FRAMES = 600
ATE_BOUND_M = 5.0
# Share of rBRIEF bits allowed to differ between the card and the CPU on
# one production frame. The patch and pattern selections run at DEFAULT
# precision, TF32 on the card: a sampled pixel is rounded to 11 bits, and
# a bit flips only where its two samples lie within that rounding. 1% is
# 2.6 of 256 bits, against a match gate of 64 (MatcherConfig.max_hamming).
DESC_BIT_TOL = 0.01


def _memory(compiled) -> str:
    m = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes",
              "generated_code_size_in_bytes")
    return " ".join(f"{f.replace('_size_in_bytes', '')}="
                    f"{getattr(m, f) / 2**20:.1f}MiB" for f in fields)


def phase_compile(cfg, cam):
    """Lower and compile each jitted step of the main path at
    production width, without running it."""
    import jax
    import jax.numpy as jnp

    from slam1_tpu.models import pipeline
    from slam1_tpu.models.loop_closure import place_query, verify_loop_slate

    h, w = cfg.image.height, cfg.image.width
    sds = jax.ShapeDtypeStruct
    img = sds((h, w), jnp.float32)
    state = jax.eval_shape(
        lambda l, r: pipeline._init_state(l, r, cam, cfg, 0), img, img)
    blk = sds((BLOCK, h, w), jnp.float32)
    i32 = sds((), jnp.int32)
    e = pipeline.MAX_LOOP_EDGES
    loop_rows = (sds((e,), jnp.int32), sds((e,), jnp.int32),
                 sds((e, 4, 4), jnp.float32), sds((e,), jnp.float32))
    kf_rows = state.kf.frame_of_row.shape[0]
    n_kf = min(1024, kf_rows)        # the config-4 keyframe bucket
    slate = pipeline.SlamSystem.SLATE_K
    steps = {
        "slam_step_block": lambda: pipeline.slam_step_block.lower(
            state, blk, blk, cam, cfg),
        "local_ba_step": lambda: pipeline.local_ba_step.lower(
            state, cam, cfg, i32),
        f"global_ba_step[{n_kf} kf, 2^18 obs]":
            lambda: pipeline.global_ba_step.lower(
                state, cam, cfg, n_kf=n_kf, obs_bucket=1 << 18,
                loop_rows=loop_rows),
        "_pgo_step": lambda: pipeline._pgo_step.lower(
            state.traj, state.rel, state.rel_mask, state.kf.frame_of_row,
            sds((kf_rows,), jnp.bool_), *loop_rows, i32, state.map.xyz,
            state.map.last_frame, state.map.valid,
            bucket=max(b for b in pipeline.PGO_BUCKETS
                       if b <= state.traj.shape[0]), iters=cfg.ba.pg_iters,
            cg_iters=cfg.ba.cg_iters),
        f"place_query[{n_kf} rows]": lambda: place_query.lower(
            state.kf, i32, i32, n_kf, k=cfg.bow.place_topk,
            thresh=cfg.bow.place_thresh,
            nms_frames=cfg.bow.place_nms_frames),
        "verify_loop_slate": lambda: verify_loop_slate.lower(
            sds((slate, 2), jnp.uint32), state.kf,
            sds((slate,), jnp.int32), sds((slate,), jnp.int32), cam, cfg),
    }
    for name, lower in steps.items():
        t0 = time.perf_counter()
        compiled = lower().compile()
        print(f"[2 compile] {name}: {time.perf_counter() - t0:.1f}s "
              f"{_memory(compiled)}", flush=True)


def _check_top2(name, got, d):
    """Exact agreement of a kernel top-2 with the dense distances d."""
    d = np.asarray(d)
    d1, d2, idx, col_best = (np.asarray(x) for x in got)
    srt = np.sort(d, axis=1)
    rows, cols = np.arange(d.shape[0]), np.arange(d.shape[1])
    checks = {
        "d1": np.array_equal(d1, srt[:, 0]),
        "d2": np.array_equal(d2, srt[:, 1]),
        "d[idx]==d1": np.array_equal(d[rows, idx], d1),
        "d[col_best]==colmin": np.array_equal(d[col_best, cols],
                                              d.min(axis=0)),
    }
    n_valid = int((srt[:, 0] < (1 << 20)).sum())
    print(f"[3 parity] hamming {name} {d.shape[0]}x{d.shape[1]}: "
          f"rows with a candidate={n_valid} "
          + " ".join(f"{k}={'ok' if v else 'FAIL'}"
                     for k, v in checks.items()), flush=True)
    if not all(checks.values()):
        raise AssertionError(f"hamming kernel parity failed: {name}")


def phase_parity(cfg, world):
    """Hamming kernel vs the plain reference on the card, and the
    card's rBRIEF descriptors vs the CPU's for one production frame."""
    import jax
    import jax.numpy as jnp

    from slam1_tpu.ops import detector, hamming
    from slam1_tpu.ops.brief import unpack_bits_pm1
    from slam1_tpu.ops.pallas_kernels import hamming_top2
    from slam1_tpu.utils.synthetic import render_frame

    h, w = cfg.image.height, cfg.image.width
    det = jax.jit(lambda im: detector.detect_pyramid(
        im, cfg.detector, cfg.image.valid_height, cfg.image.valid_width))
    l0, r0 = render_frame(world, 0, h, w)
    l1, _ = render_frame(world, 1, h, w)
    fl, fr, fn = det(l0), det(r0), det(l1)
    mc, radius = cfg.matcher, cfg.tracking.gate_radius_px
    forms = {
        "stereo": (fl, fr, dict(uv_a=fl.xy, uv_b=fr.xy,
                                dy_tol=mc.epipolar_dy,
                                dx_lo=mc.min_disparity,
                                dx_hi=mc.max_disparity)),
        "windowed": (fl, fn, dict(uv_a=fl.xy, uv_b=fn.xy, dy_tol=radius,
                                  dx_lo=-radius, dx_hi=radius)),
        "ungated": (fl, fn, {}),
    }
    kern = jax.jit(hamming_top2, static_argnames=("dy_tol", "dx_lo",
                                                  "dx_hi"))
    for name, (a, b, gate) in forms.items():
        d = hamming.gated_distances(a.desc, b.desc, a.mask, b.mask, **gate)
        got = kern(unpack_bits_pm1(a.desc), unpack_bits_pm1(b.desc),
                   a.mask, b.mask, **gate)
        _check_top2(name, got, d)
        plain = hamming.top2_plain(d)
        assert all(np.array_equal(np.asarray(x), np.asarray(y))
                   for x, y in zip(got[:2], plain[:2])), name

    # Loop-slate shape: keyframe snapshots, vmapped as verify_loop_slate
    # runs the matcher.
    from slam1_tpu.models.pipeline import KF_FEATURES, SlamSystem
    k = SlamSystem.SLATE_K
    rng = np.random.default_rng(0)
    sa, sb = (jnp.asarray(np.stack([
        rng.permutation(fl.mask.shape[0])[:KF_FEATURES]
        for _ in range(k)])) for _ in range(2))
    da, ma, db, mb = fl.desc[sa], fl.mask[sa], fn.desc[sb], fn.mask[sb]
    got = jax.jit(jax.vmap(lambda a, b, x, y: hamming_top2(
        unpack_bits_pm1(a), unpack_bits_pm1(b), x, y)))(da, db, ma, mb)
    for s in range(k):
        _check_top2(f"loop-slate[{s}]", [g[s] for g in got],
                    hamming.distance_matrix(da[s], db[s], ma[s], mb[s]))

    # rBRIEF on the card vs the CPU: the patch and pattern contractions
    # run at DEFAULT precision, which is TF32 on the card.
    cpu = jax.devices("cpu")[0]
    f_cpu = det(jax.device_put(l0, cpu))
    same = (np.asarray(f_cpu.mask) & np.asarray(fl.mask)
            & np.all(np.asarray(f_cpu.xy) == np.asarray(fl.xy), axis=1))
    bits_gpu = np.unpackbits(np.asarray(fl.desc)[same], axis=1)
    bits_cpu = np.unpackbits(np.asarray(f_cpu.desc)[same], axis=1)
    share = float(np.mean(bits_gpu != bits_cpu)) if same.any() else 0.0
    print(f"[3 parity] rBRIEF card vs cpu: {int(same.sum())} of "
          f"{int(np.asarray(fl.mask).sum())} keypoints at equal positions, "
          f"differing bits {share:.5f} (bound {DESC_BIT_TOL})", flush=True)
    assert same.sum() > 0.9 * np.asarray(fl.mask).sum()
    assert share <= DESC_BIT_TOL


def phase_pipeline(cfg, world, card):
    """SlamSystem over the two-lap clip, fed in blocks as bench.py does."""
    import jax
    import jax.numpy as jnp

    from slam1_tpu.models import pipeline
    from slam1_tpu.utils.evalmetrics import ate_rmse
    from slam1_tpu.utils.synthetic import render_frame

    h, w = cfg.image.height, cfg.image.width
    t0 = time.perf_counter()
    lefts, rights = jax.lax.map(
        lambda i: render_frame(world, i, h, w), jnp.arange(CLIP_FRAMES),
        batch_size=8)
    jax.block_until_ready(lefts)
    t_render = time.perf_counter() - t0

    sys_ = pipeline.SlamSystem(world.cam, cfg, bow_train_frame=30)
    t0 = time.perf_counter()
    sys_.process(lefts[0], rights[0])
    for i in range(1, CLIP_FRAMES, BLOCK):
        j = min(i + BLOCK, CLIP_FRAMES)
        sys_.process_block(lefts[i:j], rights[i:j])
    poses = sys_.finalize()
    wall = time.perf_counter() - t0
    ate = float(ate_rmse(poses, np.asarray(world.poses), align=False))
    peak = (jax.devices()[0].memory_stats() or {}).get(
        "peak_bytes_in_use", 0)
    print(f"[4 pipeline] {CLIP_FRAMES} frames: ATE {ate:.4f} m (no "
          f"alignment), loop closures {len(sys_.loop_edges)}, verified "
          f"slates {len(sys_.loop_events)}, render {t_render:.1f}s, "
          f"process+finalize {wall:.1f}s incl. compilation, peak "
          f"{peak / 2**30:.2f} GiB on {card}", flush=True)
    assert np.isfinite(poses).all(), "non-finite poses"
    assert sys_.loop_edges, "no loop closure accepted"
    assert ate <= ATE_BOUND_M, f"ATE {ate} m > {ATE_BOUND_M} m"
    return sys_


def phase_ba(sys_, tmp):
    from slam1_tpu import cli
    ckpt = os.path.join(tmp, "smoke.npz")
    sys_.save_checkpoint(ckpt)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["ba", "--state", ckpt,
                       "--out", os.path.join(tmp, "ba.npy")])
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    print(f"[5 ba] slam ba --state: rc={rc} {res} "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    assert rc == 0 and np.isfinite(res["final_cost"]), res


def phase_tests():
    import pytest
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(_REPO, "tests")])
    print(f"[6 tests] pytest -m gpu: exit {int(rc)}", flush=True)
    assert rc == 0, f"card tests failed: {rc}"


def phase_four_cards(card):
    """Landmark-sharded BA and keyframe-sharded PGO on a 4-card mesh
    against the single-card solvers on the same problems."""
    import jax
    import jax.numpy as jnp

    from slam1_tpu.config import SlamConfig
    from slam1_tpu.models import posegraph
    from slam1_tpu.models.ba import bundle_adjust
    from slam1_tpu.parallel import dist_pgo
    from slam1_tpu.parallel.dist_ba import (distributed_bundle_adjust,
                                            partition_problem_device)
    from slam1_tpu.parallel.mesh import lm_sharding, make_mesh
    from slam1_tpu.utils.synthetic import make_ba_problem, noisy_pose_chain

    mesh = make_mesh(4)
    assert mesh.shape["lm"] == 4, dict(mesh.shape)
    prob, _gt, cam = make_ba_problem(seed=0)
    n_obs = prob.uv.shape[0]
    # Solver parity, not robustness: the graduated outlier cut exists
    # only in the single-card LM loop.
    ba_cfg = dataclasses.replace(SlamConfig().ba, lm_iters=6, cg_iters=32,
                                 outlier_px=0.0)
    sharded, _orig, n_dropped = partition_problem_device(
        prob, 4, obs_per_shard=n_obs)
    n_dropped = int(n_dropped)
    sharded = jax.tree.map(
        lambda x: jax.device_put(x, lm_sharding(mesh, x.ndim))
        if x.ndim and x.shape[0] == 4 else x, sharded)
    per_shard = np.asarray((sharded.w > 0).sum(axis=1)).tolist()
    placed = {d.id for d in sharded.uv.sharding.device_set}

    t0 = time.perf_counter()
    out_d, cost_d = distributed_bundle_adjust(sharded, cam, ba_cfg, mesh)
    cost_d = float(cost_d)
    t_d = time.perf_counter() - t0
    out_placed = {d.id for d in out_d.points.sharding.device_set}
    t0 = time.perf_counter()
    out_s, cost_s = bundle_adjust(prob, cam, ba_cfg)
    cost_s = float(cost_s)
    t_s = time.perf_counter() - t0
    rel = abs(cost_d - cost_s) / max(cost_s, 1.0)
    gap = float(jnp.abs(out_d.poses[:, :3, 3]
                        - out_s.poses[:, :3, 3]).max())
    print(f"[4 cards] dist BA: {prob.poses.shape[0]} keyframes, {n_obs} "
          f"observations, {prob.points.shape[0]} landmark rows, per-shard "
          f"observations {per_shard}, dropped {n_dropped}, input on "
          f"devices {sorted(placed)}, output on {sorted(out_placed)}",
          flush=True)
    print(f"[4 cards] dist BA cost {cost_d:.1f} vs one card {cost_s:.1f}: "
          f"relative gap {rel:.3e} (bound 5e-2); largest pose gap "
          f"{gap:.3f} m (reported, not asserted); {t_d:.1f}s / {t_s:.1f}s "
          f"incl. compilation on {card}", flush=True)
    assert n_dropped == 0, n_dropped
    assert len(placed) == 4 and len(out_placed) == 4, (placed, out_placed)
    assert rel < 5e-2, rel

    f = 256
    _gt, est, z, w, (le_i, le_j, le_z, le_w) = noisy_pose_chain(f)
    iters = 24
    dist_poses, dist_cost = dist_pgo.optimize_sharded(
        jnp.asarray(est), jnp.asarray(z), jnp.asarray(w),
        jnp.asarray(le_i), jnp.asarray(le_j), jnp.asarray(le_z),
        jnp.asarray(le_w), mesh=mesh, axis="lm", iters=iters,
        cg_iters=8 * f)
    ei = jnp.arange(f - 1, dtype=jnp.int32)
    ref, _ = posegraph.optimize(posegraph.PoseGraph(
        poses=jnp.asarray(est),
        ei=jnp.concatenate([ei, jnp.asarray(le_i)]),
        ej=jnp.concatenate([ei + 1, jnp.asarray(le_j)]),
        z=jnp.concatenate([jnp.asarray(z[:f - 1]), jnp.asarray(le_z)]),
        w=jnp.concatenate([jnp.asarray(w[:f - 1]), jnp.asarray(le_w)])),
        iters=iters, cg_iters=32)
    pgo_gap = float(jnp.abs(dist_poses[:, :3, 3] - ref[:, :3, 3]).max())
    pgo_placed = {d.id for d in dist_poses.sharding.device_set}
    print(f"[4 cards] sharded PGO: {f} poses, largest position gap to one "
          f"card {pgo_gap:.3e} m (bound 3e-2), cost {float(dist_cost):.4f}, "
          f"output on devices {sorted(pgo_placed)}", flush=True)
    assert pgo_gap < 3e-2 and np.isfinite(float(dist_cost)), pgo_gap
    assert len(pgo_placed) == 4, pgo_placed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the four-card distributed phase")
    args = ap.parse_args(argv)
    os.chdir(_REPO)
    from slam1_tpu.utils.metrics import gpu_device
    device = gpu_device()                                 # phase 1
    card = device.pop("card")

    import jax

    from slam1_tpu.config import SlamConfig
    from slam1_tpu.utils.synthetic import make_world

    if args.cards == 4:
        if device["count"] < 4:
            sys.exit(f"chip_smoke: --cards 4 needs 4 GPUs, found "
                     f"{device['count']}")
        phase_four_cards(card)
    else:
        cfg = SlamConfig()
        world = make_world(jax.random.PRNGKey(11), n_frames=CLIP_FRAMES,
                           n_points=20 * CLIP_FRAMES, trajectory="loop2",
                           speed=1.0)
        phase_compile(cfg, world.cam)
        phase_parity(cfg, world)
        sys_ = phase_pipeline(cfg, world, card)
        with tempfile.TemporaryDirectory() as tmp:
            phase_ba(sys_, tmp)
        phase_tests()
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
