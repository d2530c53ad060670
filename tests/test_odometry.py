"""Monocular odometry on a rendered synthetic 3D sequence, ATE-gated
(the hermetic stand-in for the TUM/KITTI gate — same metric, synthetic
ground truth)."""
import numpy as np
import pytest

from sift_jax.config import SiftConfig
from sift_jax.geometry.odometry import MonocularOdometry
from sift_jax.geometry.trajectory import ate_rmse


W, H = 320, 240
FX = 0.9 * W


def _paint_backdrop(r, t, seed, z, ex, ey, _tex_cache={}):
    """Render a value-noise textured world plane (z = +z, extent +-ex/+-ey)
    seen from camera (r, t) — real 3D geometry with gradients EVERYWHERE,
    vs the flat-shaded discs.  Reflect-sampled texture outside the extent
    still lies ON the plane, so all backdrop features move rigidly with
    the ground-truth homography."""
    import cv2

    from sift_jax.perf.benchimg import bench_image

    tex = _tex_cache.get(seed)
    if tex is None:
        tex = _tex_cache[seed] = bench_image(640, 848, seed=seed)
    th, tw = tex.shape
    corners = np.array([[-ex, -ey, z], [ex, -ey, z],
                        [ex, ey, z], [-ex, ey, z]], np.float64)
    pc = corners @ r.T + t
    uv = np.stack([pc[:, 0] / pc[:, 2] * FX + W / 2,
                   pc[:, 1] / pc[:, 2] * FX + H / 2], 1).astype(np.float32)
    src = np.float32([[0, 0], [tw, 0], [tw, th], [0, th]])
    m = cv2.getPerspectiveTransform(src, uv)
    return cv2.warpPerspective(tex, m, (W, H), flags=cv2.INTER_LINEAR,
                               borderMode=cv2.BORDER_REFLECT_101)


def render_sequence(n_frames=8, seed=5, n_pts=160, step=1.0,
                    textured=False):
    """Textured 3D blob cloud viewed from a smooth lateral+forward
    trajectory with slight yaw.  Returns (frames, gt_positions,
    gt_poses): positions [N, 3] and cam-to-world 4x4 pose mats.
    ``textured``: value-noise backdrop plane at z=30 behind the cloud."""
    import cv2

    rng = np.random.default_rng(seed)
    pts = rng.uniform([-4, -2.5, 6], [4, 2.5, 16], (n_pts, 3))
    radii = rng.uniform(0.06, 0.3, n_pts)
    vals = rng.uniform(60, 255, n_pts)

    frames, gt_pos, gt_poses = [], [], []
    for i in range(n_frames):
        ang = 0.01 * step * i
        c, s = np.cos(ang), np.sin(ang)
        r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        center = np.array([-0.22, 0.03, 0.12]) * step * i
        t = -r @ center
        img = (_paint_backdrop(r, t, seed, z=30.0, ex=22.0, ey=16.0)
               if textured else np.zeros((H, W), np.float32)).copy()
        pc = pts @ r.T + t
        order = np.argsort(-pc[:, 2])
        for j in order:
            if pc[j, 2] <= 0.5:
                continue
            u = pc[j, 0] / pc[j, 2] * FX + W / 2
            v = pc[j, 1] / pc[j, 2] * FX + H / 2
            rad = max(2, int(radii[j] / pc[j, 2] * FX))
            cv2.circle(img, (int(u), int(v)), rad, float(vals[j]), -1)
        img += rng.normal(0, 3, (H, W)).astype(np.float32)
        frames.append(np.clip(img, 0, 255))
        gt_pos.append(center)
        pose = np.eye(4)
        pose[:3, :3] = r.T
        pose[:3, 3] = center
        gt_poses.append(pose)
    return frames, np.stack(gt_pos), gt_poses


@pytest.fixture(scope="module")
def sequence():
    return render_sequence()


def _run_odometry(frames, **kw):
    odo = MonocularOdometry(
        SiftConfig(width=W, height=H, num_features=800),
        fx=FX, fy=FX, cx=W / 2, cy=H / 2, **kw)
    for f in frames:
        odo.process(f)
    return odo


def test_odometry_ate(sequence):
    frames, gt, _ = sequence
    odo = _run_odometry(frames)
    est = odo.result.positions()
    assert len(est) == len(gt)
    # tracked throughout, and PnP landmark tracking actually engaged
    # (bootstrap-only chains have no consistent scale)
    assert min(odo.result.n_inliers[1:]) >= 12
    assert odo.result.modes[1] == "bootstrap"
    assert all(m == "pnp" for m in odo.result.modes[2:]), odo.result.modes
    # monocular: align with scale; trajectory length ~3.2 units
    ate = ate_rmse(est, gt, with_scale=True)
    assert ate < 0.15, f"ATE {ate}"


def test_odometry_ate_textured():
    """Same ATE gate on the textured-backdrop scene (gradients everywhere
    — the photo-like regime; round-3 worklist: ATE was only ever gated on
    flat-shaded discs)."""
    frames, gt, _ = render_sequence(textured=True)
    odo = _run_odometry(frames)
    assert min(odo.result.n_inliers[1:]) >= 12
    ate = ate_rmse(odo.result.positions(), gt, with_scale=True)
    assert ate < 0.15, f"textured ATE {ate}"


def test_odometry_with_window_ba(sequence):
    frames, gt, _ = sequence
    odo = _run_odometry(frames, ba_interval=3, ba_window=4)
    ate = ate_rmse(odo.result.positions(), gt, with_scale=True)
    assert ate < 0.15, f"ATE with BA {ate}"


def test_odometry_poses_consistent(sequence):
    frames, _, _ = sequence
    odo = _run_odometry(frames[:3])
    poses = odo.result.poses_cam_to_world()
    np.testing.assert_allclose(poses[0], np.eye(4), atol=1e-6)
    pos = odo.result.positions()
    np.testing.assert_allclose(pos[0], 0, atol=1e-6)
    # camera moves between frames
    assert np.linalg.norm(pos[2] - pos[1]) > 1e-3


def _paint_corridor_walls(img, r, t, center_z, seed,
                          z_far=80.0, x_half=8.0, y_half=5.0,
                          _tex_cache={}):
    """Composite two value-noise textured SIDE walls (world planes
    x = +-x_half) over ``img``.  World-anchored texture (u ~ wall z,
    v ~ wall y), so wall features move with full ground-truth parallax —
    the realistic corridor regime, unlike a distant fronto-parallel
    backdrop whose features constrain translation poorly."""
    import cv2

    from sift_jax.perf.benchimg import bench_image

    tex = _tex_cache.get(seed)
    if tex is None:
        tex = _tex_cache[seed] = bench_image(512, 2048, seed=seed + 1)
    th, tw = tex.shape
    z0 = center_z + 1.5
    u0 = z0 / z_far * tw
    for x_w in (-x_half, x_half):
        quad = np.array([[x_w, -y_half, z0], [x_w, -y_half, z_far],
                         [x_w, y_half, z_far], [x_w, y_half, z0]])
        pc = quad @ r.T + t
        uv = np.stack([pc[:, 0] / pc[:, 2] * FX + W / 2,
                       pc[:, 1] / pc[:, 2] * FX + H / 2],
                      1).astype(np.float32)
        src = np.float32([[u0, 0], [tw, 0], [tw, th], [u0, th]])
        m = cv2.getPerspectiveTransform(src, uv)
        w = cv2.warpPerspective(tex, m, (W, H), flags=cv2.INTER_LINEAR,
                                borderMode=cv2.BORDER_CONSTANT,
                                borderValue=-1.0)
        np.copyto(img, w, where=w >= 0)
    return img


def render_corridor(n_frames=60, seed=5, n_pts=900, textured=True):
    """Forward flythrough of a long textured corridor (points keep
    entering the view, so arbitrary sequence lengths stay trackable).
    Textured by default: a value-noise end wall (z=70) plus two
    world-anchored textured side walls put gradients with real parallax
    everywhere, so the TUM ATE gate runs on a photo-like scene, not just
    disc edges.  Returns (frames, gt_positions, gt_poses cam-to-world)."""
    import cv2

    rng = np.random.default_rng(seed)
    pts = rng.uniform([-8, -5, 2], [8, 5, 60], (n_pts, 3))
    radii = rng.uniform(0.08, 0.35, n_pts)
    vals = rng.uniform(60, 255, n_pts)
    frames, gt_pos, gt_poses = [], [], []
    for i in range(n_frames):
        ang = 0.05 * np.sin(0.08 * i)
        c, s = np.cos(ang), np.sin(ang)
        r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        center = np.array([0.5 * np.sin(0.1 * i), 0.02 * i, 0.45 * i])
        t = -r @ center
        if textured:
            img = _paint_backdrop(r, t, seed, z=70.0, ex=42.0,
                                  ey=32.0).copy()
            _paint_corridor_walls(img, r, t, center[2], seed)
        else:
            img = np.zeros((H, W), np.float32)
        pc = pts @ r.T + t
        order = np.argsort(-pc[:, 2])
        for j in order:
            if pc[j, 2] <= 0.5:
                continue
            u = pc[j, 0] / pc[j, 2] * FX + W / 2
            v = pc[j, 1] / pc[j, 2] * FX + H / 2
            rad = max(2, int(radii[j] / pc[j, 2] * FX))
            cv2.circle(img, (int(u), int(v)), rad, float(vals[j]), -1)
        img += rng.normal(0, 3, (H, W)).astype(np.float32)
        frames.append(np.clip(img, 0, 255))
        gt_pos.append(center)
        pose = np.eye(4)
        pose[:3, :3] = r.T
        pose[:3, 3] = center
        gt_poses.append(pose)
    return frames, np.stack(gt_pos), gt_poses


def test_odometry_cli_tum_sequence(tmp_path, capsys):
    """End-to-end TUM-format gate (BASELINE configs #4/#5): a rendered
    60-frame, 26.6-unit corridor flythrough written as a TUM dataset on
    disk, run through the tools/odometry.py CLI with windowed BA,
    ATE/RPE computed against the TUM ground-truth file, estimated
    trajectory round-tripped through TUM IO.  Measured: ATE ~0.29 with
    BA (1.1% of trajectory length; ~1.65 without BA)."""
    import re

    import cv2

    from sift_jax.geometry import trajectory as T
    from sift_jax.tools import odometry as cli

    frames, gt_pos, gt_poses = render_corridor()
    seq = tmp_path / "seq"
    seq.mkdir()
    for i, f in enumerate(frames):
        cv2.imwrite(str(seq / f"frame_{i:04d}.png"), f.astype(np.uint8))
    gt_file = tmp_path / "gt.tum"
    T.write_tum_trajectory(str(gt_file), np.arange(60, dtype=float),
                           gt_poses)

    out_file = tmp_path / "est.tum"
    cli.main([str(seq), "--fx", str(FX), "--num-features", "800",
              "--ba-interval", "5", "--ba-window", "6",
              "--out", str(out_file), "--gt", str(gt_file)])
    out = capsys.readouterr().out
    m = re.search(r"ATE \(Sim3-aligned RMSE\): ([0-9.]+)", out)
    assert m, out
    ate = float(m.group(1))
    # 2.3% of the 26.6-unit trajectory (fails without BA at ~6%).
    assert ate < 0.6, out

    ts, est_poses = T.read_tum_trajectory(str(out_file))
    assert len(est_poses) == 60
    est_p = np.stack([p[:3, 3] for p in est_poses])
    # The CLI prints ATE with 4 decimals — round-off alone is 5e-5.
    assert abs(T.ate_rmse(est_p, gt_pos, with_scale=True) - ate) < 6e-5


def test_telemetry_stream(sequence, tmp_path):
    """Structured observability (SURVEY §5): per-frame events, counters
    and BA timers, serialized as JSONL."""
    import json

    from sift_jax.perf.telemetry import Telemetry

    frames, _, _ = sequence
    tel = Telemetry()
    odo = _run_odometry(frames[:5], ba_interval=3, ba_window=4,
                        telemetry=tel)
    ev = [e for e in tel.events if e["kind"] == "frame"]
    assert len(ev) == 4  # frame 0 is init-only
    assert {"mode", "keypoints", "matches", "inliers",
            "landmarks"} <= set(ev[0])
    assert tel.counters["frames"] == 4
    assert any(e["kind"] == "window_ba" for e in tel.events)

    path = tmp_path / "tel.jsonl"
    tel.write_jsonl(str(path))
    rows = [json.loads(l) for l in open(path)]
    assert rows[-1]["kind"] == "summary"
    assert rows[-1]["counters"]["frames"] == 4
    assert "window_ba_s" in rows[-1]["series"]


def test_checkpoint_resume_bitwise(sequence, tmp_path):
    """Failure recovery (SURVEY §5): kill the tracker mid-sequence,
    resume a FRESH instance from the checkpoint, and the continued
    trajectory must be bit-identical to an uninterrupted run (pose
    chain, landmark map, observations, keyframes, PRNG stream are all
    checkpointed)."""
    frames, _, _ = sequence

    full = _run_odometry(frames, ba_interval=3, ba_window=4)

    first = _run_odometry(frames[:5], ba_interval=3, ba_window=4)
    ckpt = str(tmp_path / "state.npz")
    first.save_state(ckpt)

    resumed = MonocularOdometry(
        SiftConfig(width=W, height=H, num_features=800),
        fx=FX, fy=FX, cx=W / 2, cy=H / 2, ba_interval=3, ba_window=4)
    resumed.load_state(ckpt)
    for f in frames[5:]:
        resumed.process(f)

    np.testing.assert_array_equal(
        np.stack(full.result.rotations), np.stack(resumed.result.rotations))
    np.testing.assert_array_equal(
        np.stack(full.result.translations),
        np.stack(resumed.result.translations))
    assert full.result.modes == resumed.result.modes
    assert full.result.n_inliers == resumed.result.n_inliers
