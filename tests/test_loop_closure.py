import jax
import jax.numpy as jnp
import numpy as np

from slam1_tpu.config import tiny_config
from slam1_tpu.models import mapping
from slam1_tpu.models.frontend import stereo_frontend
from slam1_tpu.models.loop_closure import verify_loop_pair
from slam1_tpu.ops import se3
from slam1_tpu.utils.synthetic import make_world, render_frame


def test_verify_loop_pair_recovers_relative_pose(rng):
    """Render the same world from two nearby poses; keyframe-pair
    verification should recover the true relative transform."""
    import dataclasses
    cfg = tiny_config()
    # Keyframe-vs-keyframe matching only sees each snapshot's STEREO
    # observations (not the full feature set); the tiny 2x4x24 grid
    # leaves ~70 of them, right at the min_loop_inliers=20 gate. Use a
    # denser grid so the test probes geometry, not the capacity floor.
    cfg = dataclasses.replace(
        cfg, detector=dataclasses.replace(cfg.detector, kp_per_tile=48))
    hw = (cfg.image.height, cfg.image.width)
    world = make_world(rng, n_frames=20, n_points=2000, trajectory="loop",
                       speed=0.5, image_hw=hw)

    store = mapping.init_kf_store(4, k=256)
    for f in (0, 1):
        l, r = render_frame(world, f, *hw)
        _, obs = stereo_frontend(l, r, world.cam, cfg)
        store = mapping.kf_insert(store, obs, world.poses[f], k=256,
                                  frame=f)

    # candidate = frame 0, hit = frame 1 (anchor resolves to kf 1)
    res = verify_loop_pair(rng, store, 0, 1, world.cam, cfg)
    assert bool(res.ok), \
        f"loop verification failed ({int(res.num_inliers)} inliers)"
    assert int(res.anchor_frame) == 1
    # T_anchor_cand should match GT: inv(T_w_1) @ T_w_0
    T_true = se3.inverse(world.poses[1]) @ world.poses[0]
    err_t = float(jnp.linalg.norm(res.T_anchor_cand[:3, 3]
                                  - T_true[:3, 3]))
    # 0.3 m on a 0.5 m baseline: the test camera's fx ~ 150 puts
    # metre-scale noise on triangulated depths (sigma_z ~ z^2 sigma_d /
    # (fx b)), which bounds the PnP translation accuracy achievable
    # from ~14 inliers regardless of solver quality. The PGO edge
    # accuracy the pipeline relies on is asserted separately on richer
    # pairs (test_pipeline_closes_the_loop: < 0.2 m).
    assert err_t < 0.3, err_t


def test_verify_loop_pair_rejects_unrelated_frame(rng):
    """A keyframe looking at completely different content must not
    verify."""
    cfg = tiny_config()
    hw = (cfg.image.height, cfg.image.width)
    w1 = make_world(rng, n_frames=4, n_points=800, image_hw=hw)
    w2 = make_world(jax.random.fold_in(rng, 7), n_frames=4, n_points=800,
                    image_hw=hw)
    store = mapping.init_kf_store(4, k=256)
    l0, r0 = render_frame(w1, 0, *hw)
    _, obs0 = stereo_frontend(l0, r0, w1.cam, cfg)
    store = mapping.kf_insert(store, obs0, w1.poses[0], k=256, frame=0)
    lx, rx = render_frame(w2, 0, *hw)
    _, obsx = stereo_frontend(lx, rx, w2.cam, cfg)
    store = mapping.kf_insert(store, obsx, w2.poses[0], k=256, frame=1)
    res = verify_loop_pair(rng, store, 0, 1, w1.cam, cfg)
    assert int(res.num_inliers) < 12
    assert not bool(res.ok)


def test_place_query_retrieves_revisited_frame(rng):
    """Brute-force place recognition: the snapshot of a revisited
    view must outscore unrelated views and rank first (the production
    retrieval path; BoW histograms are the small-config fallback)."""
    from slam1_tpu.models.loop_closure import place_query

    cfg = tiny_config()
    hw = (cfg.image.height, cfg.image.width)
    w1 = make_world(rng, n_frames=4, n_points=1400, image_hw=hw)
    store = mapping.init_kf_store(8, k=256)
    # row 0: the view that will be revisited; rows 1-3: three UNRELATED
    # worlds (distinct landmark fields)
    l0, r0 = render_frame(w1, 0, *hw)
    _, obs0 = stereo_frontend(l0, r0, w1.cam, cfg)
    store = mapping.kf_insert(store, obs0, w1.poses[0], k=256, frame=0)
    for j in range(3):
        wx = make_world(jax.random.fold_in(rng, 9 + j), n_frames=4,
                        n_points=1400, image_hw=hw)
        lx, rx = render_frame(wx, 0, *hw)
        _, obsx = stereo_frontend(lx, rx, wx.cam, cfg)
        store = mapping.kf_insert(store, obsx, wx.poses[0], k=256,
                                  frame=3 + 3 * j)
    # query: frame 1 of world 1 — a revisit of row 0's view, one frame on
    l1, r1 = render_frame(w1, 1, *hw)
    _, obs1 = stereo_frontend(l1, r1, w1.cam, cfg)
    store = mapping.kf_insert(store, obs1, w1.poses[1], k=256, frame=20)
    q_row = 4
    cands, scores = place_query(store, q_row, max_frame=15, n_rows=8,
                                k=2, thresh=32, nms_frames=2)
    cands = np.asarray(cands)
    scores = np.asarray(scores)
    assert int(cands[0]) == 0, (cands, scores)
    # the genuine revisit must clearly outscore the best unrelated view
    assert scores[0] > 1.5 * max(scores[1], 1.0), (cands, scores)
