"""Offline loop-verification grid: inliers vs candidate offset.

Loads a config-4 checkpoint (tools/global_ba_scale.py --ckpt) and, for
chosen hit frames, sweeps verify_loop_slate over a grid of candidate
keyframes around the geometrically-true revisit — mapping out how
sharply the PnP inlier count falls off with candidate offset. This is
the diagnostic for loop recall at scale: it separates "BoW retrieves
the wrong frame" from "verification is weak even on the right frame".

Usage:
  python tools/loop_grid.py --ckpt .scratch/gba2000.npz \
      --hits 1823,1887,1311 [--span 16]
(runs on the default backend; each slate is one program.)
"""

from __future__ import annotations

import argparse
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", type=str, default=".scratch/gba2000.npz")
    ap.add_argument("--hits", type=str, default="1311,1567,1823,1999")
    ap.add_argument("--span", type=int, default=16)
    ap.add_argument("--frames", type=int, default=2000)
    args = ap.parse_args()
    os.chdir(_REPO)

    import jax
    import jax.numpy as jnp

    from slam1_tpu.models import pipeline
    from slam1_tpu.models.loop_closure import verify_loop_slate
    from tools.global_ba_scale import make_scale_world, scale_config

    cfg = scale_config()
    world = make_scale_world(args.frames)
    sys_ = pipeline.SlamSystem.resume(args.ckpt, world.cam, cfg)
    st = sys_.state
    gt = np.asarray(world.poses)

    # The geometric truth: nearest GT pose among frames < hit - exclude.
    def true_revisit(hf):
        p = gt[hf, :3, 3]
        d = np.linalg.norm(gt[:max(hf - 200, 1), :3, 3] - p, axis=1)
        return int(np.argmin(d)), float(np.min(d))

    ke = max(cfg.mapping.keyframe_every, 1)
    K = 8
    base = jax.random.PRNGKey(7)
    for hf_s in args.hits.split(","):
        hf = int(hf_s)
        tv, tvd = true_revisit(hf)
        # candidate grid: keyframes centred on the true revisit
        lo = (tv - args.span) // ke * ke
        cands = list(range(lo, tv + args.span + 1, ke))
        rows = []
        for s in range(0, len(cands), K):
            batch = cands[s:s + K]
            pad = K - len(batch)
            cs = jnp.asarray(batch + [-1] * pad, jnp.int32)
            hfs = jnp.full((K,), hf, jnp.int32)
            keys = jax.vmap(lambda i: jax.random.fold_in(base, i))(
                jnp.asarray([hf * 31 + c for c in batch] + [0] * pad))
            res = verify_loop_slate(keys, st.kf, cs, hfs, world.cam, cfg)
            inl = np.asarray(res.num_inliers)
            af = np.asarray(res.anchor_frame)
            for k, c in enumerate(batch):
                rows.append((c, int(inl[k]), int(af[k])))
        anchor = rows[0][2] if rows else -1
        print(f"hit {hf} (anchor kf {anchor}): true revisit frame {tv} "
              f"(gt dist {tvd:.2f} m)")
        print("  cand: " + " ".join(f"{c}" for c, _i, _a in rows))
        print("  inl : " + " ".join(f"{i}" for _c, i, _a in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
