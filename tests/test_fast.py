import jax.numpy as jnp
import numpy as np

from slam1_tpu.ops import fast


def synthetic_corners(h=64, w=96):
    """Bright squares on dark background — corners at square corners."""
    img = np.zeros((h, w), np.float32)
    img[16:32, 16:32] = 1.0
    img[40:56, 60:80] = 0.8
    return img


def test_fast_fires_on_blobs():
    img = np.zeros((48, 48), np.float32)
    img[20:23, 20:23] = 1.0  # small bright blob: circle all darker
    score = np.asarray(fast.fast_score(jnp.asarray(img), 0.2))
    assert score[21, 21] > 0


def test_fast_silent_on_flat_and_edges():
    img = np.zeros((48, 48), np.float32)
    img[:, 24:] = 1.0  # vertical step edge
    score = np.asarray(fast.fast_score(jnp.asarray(img), 0.2))
    # interior of both flat regions and the straight edge: no corners
    assert score[24, 10] == 0
    assert score[24, 40] == 0
    assert score[24, 24] == 0  # straight edge arc is exactly 8 < 9


def test_fast_against_opencv_detections():
    """Our corner set should substantially overlap OpenCV FAST-9/16."""
    import cv2
    rng = np.random.default_rng(0)
    img = (rng.uniform(0, 1, (120, 160)) > 0.995).astype(np.float32)
    img = cv2.GaussianBlur(img * 255.0, (5, 5), 1.0)
    det = cv2.FastFeatureDetector_create(
        threshold=20, nonmaxSuppression=False,
        type=cv2.FAST_FEATURE_DETECTOR_TYPE_9_16)
    kps = det.detect(img.astype(np.uint8))
    cv_pts = {(int(k.pt[1]), int(k.pt[0])) for k in kps}
    score = np.asarray(fast.fast_score(jnp.asarray(img, jnp.float32), 20.0))
    ours = set(zip(*np.nonzero(score)))
    if not cv_pts:
        assert not ours
        return
    inter = len(cv_pts & ours)
    # implementations differ in tie-breaking at the threshold; demand
    # high overlap, not equality
    assert inter / len(cv_pts) > 0.9
    assert inter / max(len(ours), 1) > 0.9


def test_nms_keeps_single_peak():
    score = np.zeros((32, 32), np.float32)
    score[10, 10] = 5.0
    score[10, 11] = 4.0  # suppressed neighbour
    score[20, 20] = 3.0
    out = np.asarray(fast.nms(jnp.asarray(score), radius=2))
    assert out[10, 10] == 5.0
    assert out[10, 11] == 0.0
    assert out[20, 20] == 3.0


def test_runs_at_least_circular():
    """A run of exactly 9 brighter taps that crosses the circle's wrap
    point (taps 14..6) makes a corner; FAST-10 rejects the same pixel."""
    img = np.full((16, 16), 0.5, np.float32)
    for i in range(9):
        dy, dx = fast.CIRCLE[(14 + i) % 16]
        img[8 + dy, 8 + dx] = 1.0
    img = jnp.asarray(img)
    assert float(fast.fast_score(img, 0.2)[8, 8]) > 0
    assert float(fast.fast_score(img, 0.2, arc=10)[8, 8]) == 0
