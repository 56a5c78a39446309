"""Single-chip SLAM throughput + accuracy benchmark (driver contract).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.

Headline metric: frames/s of the FULL SLAM pipeline (frontend, temporal
tracking, PnP, mapping, BoW place recognition, loop closure with
geometric verification, windowed local BA, pose-graph relaxation) over a
SLAM_FRAMES-frame synthetic two-lap loop at production resolution
(376x1280 canvas ~ 1226x370 KITTI, ref XXXport_files.py:51), plus the
trajectory ATE RMSE vs ground truth after finalize — BOTH halves of the
BASELINE headline ("ATE parity ... at >=10x the reference's frames/s").

DATA CAVEAT: no KITTI download exists in this environment (the
reference itself hardcodes a local path, main.py:34), so BOTH pipelines
run on the same synthetic rendered clip (utils/synthetic.py) with exact
ground truth; the ATE numbers are synthetic-clip numbers, not KITTI
seq-00 numbers. Per-op correctness vs real imagery is covered by the
cv2 oracle tests (tests/test_fast.py etc.).

vs_baseline: ratio to a reference-equivalent OpenCV/sklearn pipeline
timed on this host's CPU, mirroring /root/reference/main.py:76-132's
per-frame hot path INCLUDING its KDTree global-map merge
(keypoint.py:102-122) and BoW chi^2 scan (bag_of_words.py:29-42) — not
just the frontend (r2 VERDICT weak #9). Also reported: VO-only fps
(detect/match/triangulate/PnP fused step) against the frontend-only
baseline. Baseline numbers are cached in .bench_baseline.json.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _REPO)

N_FRAMES = 24          # VO clip length (cycled VO_STEPS times)
VO_STEPS = 120
SLAM_FRAMES = 600      # full-pipeline clip: TWO laps of a loop — the
                       # second lap continuously revisits the first, so
                       # several independent loop-closure windows exist
                       # (recall is measurable, not capped at 1 by the
                       # 100-frame re-arm on a single-lap clip)


def measure_vo(lefts, rights, cam, cfg):
    """VO throughput with scan-blocked steps, timed to block_until_ready."""
    import jax

    from slam1_tpu.models import vo

    state = vo.init_state(lefts[0], rights[0], cam, cfg)
    Ls, Rs = lefts[1:], rights[1:]
    state, poses, m = vo.vo_block(state, Ls, Rs, cam, cfg)   # warm/compile
    jax.block_until_ready(state)

    reps = max(VO_STEPS // Ls.shape[0], 1)
    t0 = time.perf_counter()
    for _k in range(reps):
        state, poses, m = vo.vo_block(state, Ls, Rs, cam, cfg)
    jax.block_until_ready(state)
    return reps * Ls.shape[0] / (time.perf_counter() - t0)


def measure_slam(cfg, n_frames=SLAM_FRAMES):
    """Full pipeline over an n_frames synthetic loop: returns
    (frames/s of the process loop, ATE RMSE m after finalize,
    accepted loop closures). ATE is RMSE vs GT without alignment — the
    ref's runtime GT diff (main.py:143-146) is final-pose-only; RMSE
    over the whole trajectory is stricter."""
    import jax
    import jax.numpy as jnp

    from slam1_tpu.models import pipeline
    from slam1_tpu.utils.evalmetrics import ate_rmse
    from slam1_tpu.utils.synthetic import make_world, render_frame

    world = make_world(jax.random.PRNGKey(11), n_frames=n_frames,
                       n_points=20 * n_frames, trajectory="loop2",
                       speed=1.0)

    # Render into device-resident 64-frame chunks; the frames stay on
    # device so the timed loop measures the card, not host->device
    # transfer.
    ch = 64
    h, w = cfg.image.height, cfg.image.width
    chunks = []
    for s in range(0, n_frames, ch):
        idx = jnp.arange(s, min(s + ch, n_frames))
        l, r = jax.lax.map(lambda i: render_frame(world, i, h, w), idx,
                           batch_size=4)
        jax.block_until_ready(l)
        chunks.append((l, r))

    # Feed BLOCKS of frames: one dispatched program per `blk` frames
    # (slam_step_block).
    blk = 32

    def feed(sys_):
        sys_.process(chunks[0][0][0], chunks[0][1][0])   # bootstrap
        i = 1
        while i < n_frames:
            c, off = i // ch, i % ch
            k = min(blk, ch - off, n_frames - i)
            l, r = chunks[c]
            sys_.process_block(l[off:off + k], r[off:off + k])
            i += k

    # Warm pass: compiles every jit the pipeline can reach (slam_step,
    # BoW train/backfill, local BA, loop verification, PGO).
    warm = pipeline.SlamSystem(world.cam, cfg, bow_train_frame=30)
    feed(warm)
    warm.finalize()

    sys_ = pipeline.SlamSystem(world.cam, cfg, bow_train_frame=30)
    t0 = time.perf_counter()
    feed(sys_)
    jax.block_until_ready(sys_.state)
    fps = (n_frames - 1) / (time.perf_counter() - t0)
    poses = sys_.finalize()
    ate = float(ate_rmse(poses, np.asarray(world.poses), align=False))
    return fps, ate, len(sys_.loop_edges), chunks, world


def measure_reference_slam(lefts_np, rights_np, world, n_frames):
    """The reference pipeline itself (OpenCV/sklearn re-implementation of
    /root/reference/main.py:32-146) run END TO END on the same loop clip:
    tiled ORB, FLANN-style LR ratio match + LMedS mask (keypoint.py:35-66),
    triangulation, temporal 2D-3D association (Point3D.py:33-53),
    PnP-RANSAC pose CHAINING (transformation.py:5-37, main.py:120-122),
    KD-tree global-map merge (keypoint.py:102-122), full-sequence-trained
    KMeans BoW + raw-count chi^2 scan (bag_of_words.py:10-53), loop
    closure via re-localization + LINEAR translation error distribution
    (loop_closure.py:7-52, main.py:99-118).

    Returns (fps, ate_rmse_m, n_loops) — the reference's own trajectory
    accuracy and speed on this clip, so "ATE parity at >=10x" is a
    measured fact, not a claim. Returns None if cv2/sklearn missing.
    """
    try:
        import cv2
        from sklearn.cluster import KMeans
        from sklearn.neighbors import KDTree
    except ImportError:
        return None
    from slam1_tpu.utils.evalmetrics import ate_rmse

    cam = world.cam
    K = np.asarray(cam.K, np.float64)
    P_l, P_r = (np.asarray(p, np.float64) for p in cam.projection_matrices())
    u8_l = [(np.asarray(l) * 255).astype(np.uint8) for l in lefts_np]
    u8_r = [(np.asarray(r) * 255).astype(np.uint8) for r in rights_np]
    n = min(n_frames, len(u8_l))

    # ref orb.py:4-25 exactly: 5x10 grid, tiles 1.5x the grid pitch
    # (50% overlap), stepped by the pitch; ORB(scaleFactor=1.2) with
    # 200 kp per tile (main.py:75 passes max_number_of_kp=200)
    orb = cv2.ORB_create(nfeatures=200, scaleFactor=1.2)

    def detect_tiled(img):
        h, w = img.shape
        th, tw = h // 5, w // 10
        kps, descs = [], []
        for y in range(0, h - th, th):
            for x in range(0, w - tw, tw):
                tile = img[y:y + th + th // 2, x:x + tw + tw // 2]
                kp = orb.detect(tile, None)
                kp, des = orb.compute(tile, kp)
                if des is None:
                    continue
                for k in kp:
                    k.pt = (k.pt[0] + x, k.pt[1] + y)
                kps += list(kp)
                descs.append(des)
        if not descs:
            return [], None
        return kps, np.concatenate(descs)

    bf = cv2.BFMatcher(cv2.NORM_HAMMING)

    def ratio_match(da, db, ratio=0.7):
        # ref keypoint.py:44-51 / Point3D.py:44-49 (0.7 Lowe ratio)
        out = []
        for p in bf.knnMatch(da, db, k=2):
            if len(p) == 2 and p[0].distance < ratio * p[1].distance:
                out.append(p[0])
        return out

    def stereo_3d(kl, dl, kr, dr):
        """LR match + LMedS mask + triangulation -> (X, desc, uv_l)."""
        good = ratio_match(dl, dr)
        if len(good) < 9:
            return None
        uvl = np.float64([kl[m.queryIdx].pt for m in good])
        uvr = np.float64([kr[m.trainIdx].pt for m in good])
        des = np.concatenate([dl[m.queryIdx:m.queryIdx + 1] for m in good])
        _, mask = cv2.findFundamentalMat(uvl, uvr, cv2.FM_LMEDS)
        if mask is not None:                  # ref keypoint.py:59-66
            mb = mask.ravel().astype(bool)
            if mb.sum() >= 6:
                uvl, uvr, des = uvl[mb], uvr[mb], des[mb]
        X = cv2.triangulatePoints(P_l, P_r, uvl.T, uvr.T)
        return (X[:3] / X[3]).T, des, uvl

    def pnp_T(X3, uv2):
        # ref transformation.py:5-19: negate rvec/tvec -> 4x4 increment
        okf, rvec, tvec, _ = cv2.solvePnPRansac(
            np.ascontiguousarray(X3), np.ascontiguousarray(uv2), K,
            np.zeros(5))
        if not okf:
            return None
        R, _ = cv2.Rodrigues(-rvec)
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = -tvec.ravel()
        return T

    def temporal(X, des, kn, dn):
        # ref Point3D.py:33-53: match + |coord| < 500 gate
        good2 = [m for m in ratio_match(des, dn)
                 if np.all(np.abs(X[m.queryIdx]) < 500.0)]
        if len(good2) <= 4:                   # ref main.py:94 guard
            return None
        X3 = np.float64([X[m.queryIdx] for m in good2])
        uv2 = np.float64([kn[m.trainIdx].pt for m in good2])
        return X3, uv2

    # --- BoW trained on the FULL sequence up front (ref main.py:43-44,
    # bag_of_words.py:16-27): ORB(100) per image, KMeans(50) vocabulary,
    # raw-count histograms.
    orb_full = cv2.ORB_create(nfeatures=100)
    dlist = []
    for img in u8_l[:n]:
        _, d = orb_full.detectAndCompute(img, None)
        dlist.append(d if d is not None else np.zeros((1, 32), np.uint8))
    km = KMeans(50, n_init=4, random_state=0).fit(np.concatenate(dlist))
    db = []
    for d in dlist:
        lab = km.predict(d)
        db.append(np.histogram(lab, bins=50, range=(0, 49))[0]
                  .astype(np.float64))

    def chi2(x, y):                           # ref bag_of_words.py:30-31
        return np.sum(2 * (x - y) ** 2 / np.maximum(1, x + y))

    poses = [np.eye(4)]
    T_prev = np.eye(4)
    bow_threshold = 100                       # ref main.py:40
    n_loops = 0
    map_pts = None
    kl, dl = detect_tiled(u8_l[0])

    t0 = time.perf_counter()
    for i in range(n - 1):
        kr, dr = detect_tiled(u8_r[i])
        kn, dn = detect_tiled(u8_l[i + 1])
        T = None
        tri = None
        if dl is not None and dr is not None and dn is not None:
            tri = stereo_3d(kl, dl, kr, dr)
        if tri is not None:
            tm = temporal(tri[0], tri[1], kn, dn)
            if tm is not None:
                T = pnp_T(*tm)
        if T is None:
            T = T_prev                        # ref main.py:94-98: reuse
        T_prev = T

        # BoW scan vs all frames older than the threshold
        # (ref bag_of_words.py:29-42, main.py:99-100: 0 < val < 45)
        loop_done = False
        if i >= bow_threshold:
            h = db[i]
            dist = [chi2(h, db[j]) for j in range(i + 1 - bow_threshold)]
            idx, val = int(np.argmin(dist)), float(np.min(dist))
            if 0 < val < 45:
                bow_threshold = i + 100       # ref main.py:106 re-arm
                # close_loop: relocalize frame i against candidate idx
                # (ref loop_closure.py:7-36)
                kc, dc = detect_tiled(u8_l[idx])
                kcr, dcr = detect_tiled(u8_r[idx])
                T_loop = None
                if dc is not None and dcr is not None:
                    tri_c = stereo_3d(kc, dc, kcr, dcr)
                    if tri_c is not None:
                        # current frame i's tiled features = kl/dl
                        tm_c = temporal(tri_c[0], tri_c[1], kl, dl)
                        if tm_c is not None:
                            T_loop = pnp_T(*tm_c)
                if T_loop is not None:
                    n_loops += 1
                    corrected = poses[idx] @ T_loop
                    wrong = poses[-1] @ T
                    err = (corrected - wrong) / (i + 1 - idx)
                    # translation-only linear smear over frames idx..i
                    # (ref loop_closure.py:48-52, main.py:113-118)
                    for k2 in range(idx, i + 1):
                        poses[k2][:3, 3] += (k2 - idx) * err[:3, 3]
                    poses.append(corrected)
                    loop_done = True
        if not loop_done:
            poses.append(poses[-1] @ T)       # ref main.py:120-122

        # KD-tree global-map merge, rebuilt per frame
        # (ref keypoint.py:102-122, main.py:124-127)
        if tri is not None:
            Xw = (poses[-1] @ np.concatenate(
                [tri[0], np.ones((len(tri[0]), 1))], 1).T)[:3].T
            if map_pts is None:
                map_pts = Xw
            else:
                tree = KDTree(map_pts)
                dist_m, _ = tree.query(Xw, k=1)
                thr = np.maximum(0.5, 0.01 * np.abs(Xw[:, 2]))
                new = Xw[dist_m[:, 0] > thr]
                if len(new):
                    map_pts = np.vstack([map_pts, new])
        kl, dl = kn, dn
    fps = (n - 1) / (time.perf_counter() - t0)

    gt = np.asarray(world.poses)[:len(poses)]
    ate = float(ate_rmse(np.asarray(poses), gt, align=False))
    return fps, ate, n_loops


def _reference_vo_step(cam):
    """Per-frame step shaped like the reference's VO hot path (detect /
    match / triangulate / temporal-match / PnP, /root/reference/
    main.py:76-95) — the timed baseline for the VO-only comparison.
    (The FULL reference pipeline incl. mapping/BoW/loop closure is
    measure_reference_slam above.)"""
    import cv2
    K = np.asarray(cam.K, np.float64)
    P_l, P_r = (np.asarray(p, np.float64) for p in cam.projection_matrices())

    def detect_tiled(img):
        # ref orb.py:4-25: 5x10 tiles, ORB per tile
        h, w = img.shape
        th, tw = h // 5, w // 10
        kps, descs = [], []
        orb = cv2.ORB_create(nfeatures=40)
        for r in range(5):
            for c in range(10):
                tile = img[r * th:(r + 1) * th, c * tw:(c + 1) * tw]
                kp, des = orb.detectAndCompute(tile, None)
                if des is None:
                    continue
                for k in kp:
                    k.pt = (k.pt[0] + c * tw, k.pt[1] + r * th)
                kps += list(kp)
                descs.append(des)
        if not descs:
            return [], None
        return kps, np.concatenate(descs)

    bf = cv2.BFMatcher(cv2.NORM_HAMMING)

    def step(li, ri, l_next, frame_idx):
        kl, dl = detect_tiled(li)
        kr, dr = detect_tiled(ri)
        kn, dn = detect_tiled(l_next)
        if dl is None or dr is None or dn is None:
            return
        # L-R match + ratio (ref keypoint.py:44-51)
        pairs = bf.knnMatch(dl, dr, k=2)
        good = [m for m, n2 in (p for p in pairs if len(p) == 2)
                if m.distance < 0.8 * n2.distance]
        if len(good) < 9:
            return
        uvl = np.float64([kl[m.queryIdx].pt for m in good])
        uvr = np.float64([kr[m.trainIdx].pt for m in good])
        cv2.findFundamentalMat(uvl, uvr, cv2.FM_LMEDS)  # ref epipolar filter
        X = cv2.triangulatePoints(P_l, P_r, uvl.T, uvr.T)
        X = (X[:3] / X[3]).T
        d_tri = np.concatenate([dl[m.queryIdx:m.queryIdx + 1] for m in good])
        # temporal match (ref Point3D.py:33-53)
        pairs2 = bf.knnMatch(d_tri, dn, k=2)
        good2 = [m for m, n2 in (p for p in pairs2 if len(p) == 2)
                 if m.distance < 0.8 * n2.distance]
        if len(good2) < 6:
            return
        X3 = np.float64([X[m.queryIdx] for m in good2])
        uv2 = np.float64([kn[m.trainIdx].pt for m in good2])
        cv2.solvePnPRansac(X3, uv2, K, None, reprojectionError=3.0)

    return step


def measure_reference(lefts_np, rights_np, cam, with_mapping, n):
    del with_mapping                          # kept for cache-key compat
    try:
        import cv2  # noqa: F401
    except ImportError:
        return None
    step = _reference_vo_step(cam)
    u8_l = [(np.asarray(l) * 255).astype(np.uint8) for l in lefts_np]
    u8_r = [(np.asarray(r) * 255).astype(np.uint8) for r in rights_np]
    step(u8_l[0], u8_r[0], u8_l[1], 0)       # warm-up
    n = min(n, len(u8_l) - 1)
    t0 = time.perf_counter()
    for i in range(n):
        step(u8_l[i], u8_r[i], u8_l[i + 1], i)
    return n / (time.perf_counter() - t0)


def _host_fingerprint() -> str:
    """CPU model + core count: the validity domain of the cached CPU
    reference baseline."""
    model = "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return f"{model}/{os.cpu_count()}"


def main():
    os.chdir(_REPO)
    from slam1_tpu.utils.metrics import gpu_device
    device = gpu_device()
    import jax

    from slam1_tpu.config import SlamConfig
    from slam1_tpu.utils.synthetic import make_world, render_sequence

    cfg = SlamConfig()
    world = make_world(jax.random.PRNGKey(0), n_frames=N_FRAMES,
                       n_points=6000, trajectory="arc", speed=1.0)
    lefts, rights = render_sequence(world, cfg.image.height,
                                    cfg.image.width)
    jax.block_until_ready(lefts)

    vo_fps = measure_vo(lefts, rights, world.cam, cfg)
    slam_fps, ate, n_loops, s_chunks, s_world = measure_slam(cfg)

    cache_path = os.path.join(_REPO, ".bench_baseline.json")
    cache = {}
    if os.path.exists(cache_path):
        try:
            cache = json.load(open(cache_path))
        except Exception:
            cache = {}
    # Cached CPU-baseline numbers are only valid on the host that
    # measured them: key the cache on a host fingerprint and re-measure
    # on mismatch (a silent cross-host compare is exactly the class of
    # unattributable vs_baseline drift diagnosed in PROFILE_r04).
    fp = _host_fingerprint()
    if cache.get("host_fp") != fp:
        cache = {}
    ref_vo = cache.get("reference_fps")
    if ref_vo is None:
        ref_vo = measure_reference(np.asarray(lefts[:10]),
                                   np.asarray(rights[:10]), world.cam,
                                   with_mapping=False, n=8)
    # The reference pipeline run END TO END on the SAME SLAM_FRAMES
    # two-lap loop clip — its fps AND its trajectory ATE (pose chaining
    # + loop closure + map merge; see measure_reference_slam). The "ATE
    # parity at >=10x" headline is then measured on both sides.
    # Deterministic given the clip + host, so cached (~100 s of CPU
    # once; invalidated when the clip or the host fingerprint changes).
    clip_key = f"loop2-{SLAM_FRAMES}"        # invalidate on clip change
    ref = cache.get("reference_slam_v2")
    if ref is None or cache.get("clip") != clip_key:
        # one-time host materialization of the clip for the CPU
        # reference (chunked device->host fetch; cached thereafter)
        s_lefts = np.concatenate([np.asarray(l) for l, _ in s_chunks])
        s_rights = np.concatenate([np.asarray(r) for _, r in s_chunks])
        ref = measure_reference_slam(s_lefts, s_rights, s_world,
                                     SLAM_FRAMES)
    ref_slam, ref_ate, ref_loops = ref if ref else (None, None, None)
    if ref_vo or ref:
        json.dump({"reference_fps": ref_vo,
                   "reference_slam_v2": ref,
                   "clip": clip_key,
                   "host_fp": fp,
                   "host": "cpu-reference-equivalent"},
                  open(cache_path, "w"))

    vs_slam = (slam_fps / ref_slam) if (slam_fps and ref_slam) else None
    vs_vo = (vo_fps / ref_vo) if ref_vo else None
    print(json.dumps({
        "metric": "slam_frames_per_s_per_chip",
        "value": round(slam_fps, 3) if slam_fps else None,
        "unit": "frames/s",
        # Both pipelines run on the same SYNTHETIC rendered clip (no
        # KITTI data exists in this environment); ATE is vs the clip's
        # exact ground truth, not a KITTI sequence.
        "data": f"synthetic-loop2-{SLAM_FRAMES}",
        "vs_baseline": round(vs_slam, 3) if vs_slam else None,
        "ate_rmse_m": round(ate, 4) if ate is not None else None,
        "ref_ate_rmse_m": round(ref_ate, 4) if ref_ate is not None
        else None,
        "loop_closures": n_loops,
        "ref_loop_closures": ref_loops,
        "vo_frames_per_s_per_chip": round(vo_fps, 3),
        "vo_vs_baseline": round(vs_vo, 3) if vs_vo else None,
        "device": device,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
