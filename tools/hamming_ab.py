"""Fused Hamming kernel against XLA's plain version, on the card.

Times, at the pipeline's shapes (SlamConfig: max_kp 2688, 1024-feature
keyframe snapshots, an 8-pair loop slate):

  - the matcher alone, kernel vs plain, for the stereo (epipolar band),
    windowed (prediction gate) and ungated forms and the vmapped
    loop-slate form: median of --reps calls, each ending in
    block_until_ready, compilation outside the window;
  - slam_step_block frames/s with the kernel and with the plain path,
    in the order kernel, plain, plain, kernel;
  - the plain FAST-9 score at each pyramid level, with the number of
    fusions XLA compiles it into;

and prints what XLA's compiled plain matcher does with the s8 x s8 -> s32
product and the int32 top-2 (the lines naming a dot, a gemm, a sort or a
top-k). Needs a GPU; one process.

    python tools/hamming_ab.py [--reps 30] [--blocks 8]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import numpy as np


def _median_ms(fn, args, reps):
    import jax
    jax.block_until_ready(fn(*args))            # compile + warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times))


def _hlo_lines(compiled, pattern):
    return [ln.strip()[:160] for ln in compiled.as_text().splitlines()
            if re.search(pattern, ln)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--blocks", type=int, default=8,
                    help="32-frame blocks per slam_step_block timing")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from slam1_tpu.config import SlamConfig
    from slam1_tpu.models import pipeline
    from slam1_tpu.ops import detector, fast, hamming
    from slam1_tpu.ops.brief import unpack_bits_pm1
    from slam1_tpu.ops.pallas_kernels import hamming_top2
    from slam1_tpu.utils.synthetic import make_world, render_frame

    from slam1_tpu.utils.metrics import gpu_device
    out = {"device": gpu_device()}

    cfg = SlamConfig()
    h, w = cfg.image.height, cfg.image.width
    n_frames = 1 + 32 * args.blocks
    world = make_world(jax.random.PRNGKey(11), n_frames=n_frames,
                       n_points=20 * n_frames, trajectory="loop2")
    lefts, rights = jax.lax.map(
        lambda i: render_frame(world, i, h, w), jnp.arange(n_frames),
        batch_size=8)
    det = jax.jit(lambda im: detector.detect_pyramid(
        im, cfg.detector, cfg.image.valid_height, cfg.image.valid_width))
    fl, fr, fn = det(lefts[0]), det(rights[0]), det(lefts[1])
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
    statics = ("dy_tol", "dx_lo", "dx_hi")
    kern = jax.jit(lambda da, db, ma, mb, **g: hamming_top2(
        unpack_bits_pm1(da), unpack_bits_pm1(db), ma, mb, **g),
        static_argnames=statics)
    plain = jax.jit(lambda da, db, ma, mb, **g: hamming.top2_plain(
        hamming.gated_distances(da, db, ma, mb, **g)),
        static_argnames=statics)
    out["alone_ms"] = {}
    for name, (a, b, gate) in forms.items():
        xs = (a.desc, b.desc, a.mask, b.mask)
        tk = _median_ms(lambda *x: kern(*x, **gate), xs, args.reps)
        tp = _median_ms(lambda *x: plain(*x, **gate), xs, args.reps)
        out["alone_ms"][name] = {"kernel": tk, "plain": tp}
        print(f"alone {name:9s} 2688x2688: kernel {tk:.4f} ms, "
              f"plain {tp:.4f} ms")
        if name == "ungated":
            c = plain.lower(*xs).compile()
            for ln in _hlo_lines(c, r"dot\(|gemm|cublas|sort|topk|TopK"):
                print(f"  plain HLO: {ln}")

    k = pipeline.SlamSystem.SLATE_K
    rng = np.random.default_rng(0)
    sel = jnp.asarray(np.stack([rng.permutation(fl.mask.shape[0])
                                [:pipeline.KF_FEATURES] for _ in range(k)]))
    slate = (fl.desc[sel], fn.desc[sel], fl.mask[sel], fn.mask[sel])
    tk = _median_ms(jax.jit(jax.vmap(lambda *x: kern(*x))), slate,
                    args.reps)
    tp = _median_ms(jax.jit(jax.vmap(lambda *x: plain(*x))), slate,
                    args.reps)
    out["alone_ms"]["loop_slate"] = {"kernel": tk, "plain": tp}
    print(f"alone loop-slate {k}x1024x1024: kernel {tk:.4f} ms, "
          f"plain {tp:.4f} ms")

    def step_fps():
        jax.clear_caches()
        state = pipeline._init_state(lefts[0], rights[0], world.cam, cfg, 0)
        blocks = [(lefts[1 + 32 * i:33 + 32 * i],
                   rights[1 + 32 * i:33 + 32 * i])
                  for i in range(args.blocks)]
        state, _ = pipeline.slam_step_block(state, *blocks[0], world.cam,
                                            cfg)
        jax.block_until_ready(state)             # compile + warm
        t0 = time.perf_counter()
        for lb, rb in blocks:
            state, _ = pipeline.slam_step_block(state, lb, rb, world.cam,
                                                cfg)
        jax.block_until_ready(state)
        return 32 * args.blocks / (time.perf_counter() - t0)

    runs = []
    for use in ("kernel", "plain", "plain", "kernel"):
        hamming.use_kernels = (lambda: True) if use == "kernel" \
            else (lambda: False)
        fps = step_fps()
        runs.append((use, fps))
        print(f"slam_step_block with {use}: {fps:.2f} frames/s")
    out["slam_step_block_fps"] = runs

    out["fast_ms"] = {}
    img = lefts[1]
    for lvl in range(cfg.detector.num_levels):
        f = jax.jit(lambda im: fast.fast_score(
            im, cfg.detector.fast_threshold, arc=cfg.detector.fast_arc))
        c = f.lower(img).compile()
        n_fus = len(re.findall(r"^\s*ROOT .*fusion|^\s*%\S+ = .* fusion\(",
                               c.as_text(), re.M))
        t = _median_ms(f, (img,), args.reps)
        out["fast_ms"][f"level{lvl} {img.shape[0]}x{img.shape[1]}"] = {
            "ms": t, "fusions": n_fus}
        print(f"fast_score level {lvl} {img.shape}: {t:.4f} ms, "
              f"{n_fus} fusions")
        img = detector._downsample2(img)

    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
