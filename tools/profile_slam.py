"""Per-stage timing of the full SLAM pipeline step on the default backend."""
import os
import sys
import time
import functools

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from slam1_tpu.config import SlamConfig
from slam1_tpu.utils.synthetic import make_world, render_sequence
from slam1_tpu.models import pipeline, mapping, bow as bow_mod
from slam1_tpu.models.frontend import stereo_frontend
from slam1_tpu.models.tracker import temporal_track
from slam1_tpu.ops import se3

cfg = SlamConfig()
world = make_world(jax.random.PRNGKey(0), n_frames=24, n_points=6000,
                   trajectory="arc", speed=1.0)
lefts, rights = render_sequence(world, cfg.image.height, cfg.image.width)
jax.block_until_ready(lefts)
cam = world.cam


def timeit(name, fn, *args, n=20):
    out = fn(*args)
    jax.block_until_ready(out)
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n
    print(f"{name:42s} {dt*1e3:8.3f} ms")
    return out


# ---- end-to-end SlamSystem fps (same as bench measure_slam)
sys_ = pipeline.SlamSystem(cam, cfg, bow_train_frame=8)
for i in range(lefts.shape[0]):
    sys_.process(lefts[i], rights[i])
jax.block_until_ready(sys_.state.T_w_cam)
sys_ = pipeline.SlamSystem(cam, cfg, bow_train_frame=8)
sys_.process(lefts[0], rights[0])
t0 = time.perf_counter()
for i in range(1, lefts.shape[0]):
    sys_.process(lefts[i], rights[i])
jax.block_until_ready(sys_.state.T_w_cam)
dt = time.perf_counter() - t0
print(f"{'SlamSystem fps':42s} {(lefts.shape[0]-1)/dt:8.1f} fps "
      f"({dt/(lefts.shape[0]-1)*1e3:.2f} ms/frame)")

# ---- slam_step alone (thread donated state)
state = pipeline._init_state(lefts[0], rights[0], cam, cfg, 0)
state, out, feats = pipeline.slam_step(state, lefts[1], rights[1], cam, cfg)
jax.block_until_ready(state.T_w_cam)
N = 30
t0 = time.perf_counter()
for k in range(N):
    state, out, feats = pipeline.slam_step(
        state, lefts[2 + k % 20], rights[2 + k % 20], cam, cfg)
jax.block_until_ready(state.T_w_cam)
print(f"{'slam_step (full)':42s} {(time.perf_counter()-t0)/N*1e3:8.3f} ms")

# ---- components
left, right = lefts[2], rights[2]
f = jax.jit(lambda l, r: stereo_frontend(l, r, cam, cfg))
feats2, obs = timeit("stereo_frontend", f, left, right)

tt = jax.jit(lambda k, po, cf: temporal_track(k, po, cf, cam, cfg))
timeit("temporal_track (match+pnp)", tt, jax.random.PRNGKey(1), obs, feats2)

# mapping.insert
m0 = state.map
ins = jax.jit(lambda m, xyz, desc, mask: mapping.insert(
    m, xyz, desc, mask, jnp.asarray(5, jnp.int32), obs.uv_l, cfg.mapping,
    uv_r_u=obs.uv_r[:, 0], obs_row=jnp.asarray(3, jnp.int32)))
timeit("mapping.insert", ins, m0, obs.xyz, obs.desc, obs.mask)

kfi = jax.jit(lambda kf: mapping.kf_insert(
    kf, obs, jnp.eye(4), pipeline.KF_FEATURES, frame=7,
    is_kf=jnp.asarray(True)))
timeit("kf_insert", kfi, state.kf)

bw = state.bow
acc = jax.jit(lambda b, k: bow_mod.accumulate(
    b, k, feats2.desc, feats2.mask, cfg.bow.sample_desc_per_frame))
timeit("bow.accumulate", acc, bw, jax.random.PRNGKey(2))
addf = jax.jit(lambda b, k: bow_mod.add_frame(
    b, k, jnp.asarray(9, jnp.int32), feats2.desc, feats2.mask,
    is_kf=jnp.asarray(True)))
timeit("bow.add_frame", addf, bw, jax.random.PRNGKey(3))
qf = jax.jit(lambda b: bow_mod.query(b, jnp.asarray(9, jnp.int32),
                                     feats2.desc, feats2.mask, cfg.bow))
timeit("bow.query", qf, bw)

# local BA step (donated: rebuild state each call — time includes that)
st2 = pipeline._init_state(lefts[0], rights[0], cam, cfg, 0)
for i in range(1, 10):
    st2, _, _ = pipeline.slam_step(st2, lefts[i], rights[i], cam, cfg)
jax.block_until_ready(st2.T_w_cam)
st3, cost = pipeline.local_ba_step(st2, cam, cfg)
jax.block_until_ready(st3.T_w_cam)
N = 5
t0 = time.perf_counter()
st = st3
for _ in range(N):
    st, cost = pipeline.local_ba_step(st, cam, cfg)
jax.block_until_ready(st.T_w_cam)
print(f"{'local_ba_step':42s} {(time.perf_counter()-t0)/N*1e3:8.3f} ms")

# PGO step
n = 20
le = (jnp.zeros(64, jnp.int32), jnp.zeros(64, jnp.int32),
      jnp.tile(jnp.eye(4, dtype=jnp.float32), (64, 1, 1)),
      jnp.zeros(64, jnp.float32))
pg = lambda: pipeline._pgo_step(
    st.traj, st.rel, st.rel_mask, st.kf.frame_of_row,
    st.kf.frame_of_row >= 0, *le, st.frame,
    st.map.xyz, st.map.last_frame, st.map.valid, bucket=512,
    iters=3, cg_iters=cfg.ba.cg_iters)
timeit("pgo_step (bucket=512)", pg, n=5)
