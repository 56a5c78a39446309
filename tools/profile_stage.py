"""Per-stage timing of vo_step on the default backend."""
import time, functools
import jax, jax.numpy as jnp
from slam1_tpu.config import SlamConfig
from slam1_tpu.utils.synthetic import make_world, render_sequence
from slam1_tpu.ops import detector, hamming, brief, fast
from slam1_tpu.models import vo
from slam1_tpu.models.frontend import stereo_frontend
from slam1_tpu.models.tracker import temporal_track

cfg = SlamConfig()
world = make_world(jax.random.PRNGKey(0), n_frames=6, n_points=6000,
                   trajectory="arc", speed=1.0)
lefts, rights = render_sequence(world, cfg.image.height, cfg.image.width)
jax.block_until_ready(lefts)
cam = world.cam
left, right = lefts[1], rights[1]

def timeit(name, fn, *args, n=20):
    out = fn(*args); jax.block_until_ready(out)
    out = fn(*args); jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n
    print(f"{name:35s} {dt*1e3:8.3f} ms")
    return out

dcfg = cfg.detector

# full step (state is donated -> thread it)
state = vo.init_state(left, right, cam, cfg)
state, _ = vo.vo_step(state, lefts[2], rights[2], cam, cfg)
jax.block_until_ready(state.T_w_cam)
t0 = time.perf_counter()
N = 20
for _ in range(N):
    state, _ = vo.vo_step(state, lefts[2], rights[2], cam, cfg)
jax.block_until_ready(state.T_w_cam)
print(f"{'vo_step (full)':35s} {(time.perf_counter()-t0)/N*1e3:8.3f} ms")

# frontend
f = jax.jit(lambda l, r: stereo_frontend(l, r, cam, cfg))
feats, obs = timeit("stereo_frontend (2x detect+match)", f, left, right)

# detect single
det = jax.jit(lambda im: detector.detect(im, dcfg, cfg.image.valid_height, cfg.image.valid_width))
featl = timeit("detect (one image)", det, left)

fsj = jax.jit(lambda im: fast.fast_score(im, dcfg.fast_threshold, arc=dcfg.fast_arc))
score = timeit("fast_score", fsj, left)
nmsf = jax.jit(lambda s: fast.nms(s, dcfg.nms_radius))
timeit("nms", nmsf, score)

blurf = jax.jit(lambda im: brief.gaussian_blur(im, dcfg.blur_sigma))
blurred = timeit("gaussian_blur (convolve-vmap)", blurf, left)

xy = featl.xy
patf = jax.jit(lambda im, xy: brief.extract_patches(im, xy, dcfg.patch_size))
patches = timeit("extract_patches (2000x33x33)", patf, blurred, xy)
orf = jax.jit(brief.orientation)
angles = timeit("orientation", orf, patches)
pattern = detector._pattern_for(dcfg)
desf = jax.jit(lambda p, a: brief._describe(p, a, pattern, dcfg.brief_pairs))
timeit("describe", desf, patches, angles)

# top_k on tiles
def topk(score):
    h, w = score.shape
    th, tw = -(-h // dcfg.grid_rows), -(-w // dcfg.grid_cols)
    sp = jnp.pad(score, ((0, th*dcfg.grid_rows-h), (0, tw*dcfg.grid_cols-w)))
    tiles = sp.reshape(dcfg.grid_rows, th, dcfg.grid_cols, tw).transpose(0,2,1,3).reshape(-1, th*tw)
    return jax.lax.top_k(tiles, dcfg.kp_per_tile)
timeit("per-tile top_k", jax.jit(topk), score)

# hamming match (the fused kernel on a GPU, plain jnp on the CPU)
mf = jax.jit(lambda a, b, ma, mb: hamming.match(a, b, ma, mb, ratio=cfg.matcher.ratio,
             max_distance=cfg.matcher.max_hamming, cross_check=cfg.matcher.cross_check))
timeit("hamming.match 2000x2000", mf, featl.desc, featl.desc, featl.mask, featl.mask)

# pnp
tt = jax.jit(lambda k, po, cf: temporal_track(k, po, cf, cam, cfg))
timeit("temporal_track (match+pnp)", tt, jax.random.PRNGKey(1), obs, feats)
