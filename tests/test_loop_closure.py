"""Loop closure: an out-and-back trajectory must trigger a relocalization
closure and reduce accumulated drift."""
import numpy as np
import pytest

from sift_jax.config import SiftConfig
from sift_jax.geometry.odometry import MonocularOdometry
from sift_jax.geometry.trajectory import ate_rmse


W, H = 320, 240
FX = 0.9 * W


def render_loop_sequence(n=12, seed=9, n_pts=170):
    """Camera translates out and returns near the start (a loop)."""
    import cv2

    rng = np.random.default_rng(seed)
    pts = rng.uniform([-4, -2.5, 6], [4, 2.5, 16], (n_pts, 3))
    radii = rng.uniform(0.06, 0.3, n_pts)
    vals = rng.uniform(60, 255, n_pts)

    frames, gt = [], []
    for i in range(n):
        # out for n/2 frames, back for n/2
        u = i if i < n // 2 else (n - 1 - i)
        ang = 0.008 * u
        c, s = np.cos(ang), np.sin(ang)
        r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        center = np.array([-0.22 * u, 0.02 * u, 0.1 * u])
        t = -r @ center
        img = np.zeros((H, W), np.float32)
        pc = pts @ r.T + t
        for j in np.argsort(-pc[:, 2]):
            if pc[j, 2] <= 0.5:
                continue
            uu = pc[j, 0] / pc[j, 2] * FX + W / 2
            vv = pc[j, 1] / pc[j, 2] * FX + H / 2
            cv2.circle(img, (int(uu), int(vv)),
                       max(2, int(radii[j] / pc[j, 2] * FX)),
                       float(vals[j]), -1)
        img += rng.normal(0, 3, (H, W)).astype(np.float32)
        frames.append(np.clip(img, 0, 255))
        gt.append(center)
    return frames, np.stack(gt)


@pytest.mark.parametrize("lc", [False, True])
def test_loop_closure_triggers_and_helps(lc):
    frames, gt = render_loop_sequence()
    odo = MonocularOdometry(
        SiftConfig(width=W, height=H, num_features=800),
        fx=FX, fy=FX, cx=W / 2, cy=H / 2,
        loop_closure=lc, kf_interval=2, loop_min_gap=6,
        loop_min_matches=20, loop_min_inliers=15)
    for f in frames:
        odo.process(f)
    ate = ate_rmse(odo.result.positions(), gt, with_scale=True)
    if lc:
        assert len(odo.closures) >= 1, "no closure detected"
        kf, cur, n_inl = odo.closures[0]
        assert cur - kf >= 6 and n_inl >= 15
        assert ate < 0.2, f"ATE with closure {ate}"
    else:
        assert ate < 0.5  # sanity without closure
