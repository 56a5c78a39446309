"""End-to-end flow-based VO (FAST + LK + dense disparity — the
counterpart of the reference's standalone visual_odometry.py, SURVEY C18)."""

import jax
import numpy as np

from slam1_tpu.config import tiny_config
from slam1_tpu.models import vo_flow
from slam1_tpu.utils.evalmetrics import ate_rmse
from slam1_tpu.utils.synthetic import make_world, render_sequence


def test_flow_vo_tracks_synthetic_sequence():
    cfg = tiny_config()
    world = make_world(jax.random.PRNGKey(0), n_frames=8, n_points=1500,
                       image_hw=(cfg.image.height, cfg.image.width),
                       speed=0.45)
    L, R = render_sequence(world, cfg.image.height, cfg.image.width)
    poses, metrics = vo_flow.run_sequence(L, R, world.cam, cfg)
    ok_rate = np.mean([m.pnp_ok for m in metrics])
    assert ok_rate > 0.6, ok_rate
    ate = ate_rmse(poses, np.asarray(world.poses), align=False)
    assert ate < 0.6, ate
