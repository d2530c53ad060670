"""Multi-host execution: 2 processes x 4 CPU devices must produce results
identical to a single process (SURVEY §2.2 multi-device DP + comm backend;
the DCN-spanning layer, parallel/multihost.py).  Runs the flagship frame
size (752x480, textured bench_image keyframes, 512 features) so the
cross-process result identity is proven on a realistic keypoint load, not
a toy shape.

The cluster runs in subprocesses (jax.distributed needs one controller per
process); the single-process reference runs in-test on the 8-device
virtual mesh.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_cluster_matches_single_process(tmp_path):
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    workers = [
        subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests",
                                          "multihost_worker.py"),
             str(pid), "2", str(port), str(tmp_path)],
            env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)
    ]
    logs = []
    for w in workers:
        out, _ = w.communicate(timeout=900)
        logs.append(out.decode(errors="replace"))
    assert all(w.returncode == 0 for w in workers), "\n".join(logs)

    got = np.load(tmp_path / "multihost_out.npz")

    # Single-process reference on the in-test 8-device CPU mesh.
    from sift_jax.config import SiftConfig
    from sift_jax.core.types import build_plan
    from sift_jax.parallel.batched import make_mesh, make_sharded_pipeline
    from sift_jax.parallel.dba import make_distributed_lm
    from tests.multihost_worker import det_frames
    from tests.test_ba import synthetic_ba

    cfg = SiftConfig(width=752, height=480, num_features=512)
    plan = build_plan(cfg)
    mesh = make_mesh(8)
    fn, shard = make_sharded_pipeline(plan, mesh)
    frames = det_frames(8, cfg.height, cfg.width)
    res, matches = fn(shard(frames))

    assert int(np.sum(got["count"])) > 0
    np.testing.assert_array_equal(got["count"], np.asarray(res.count))
    np.testing.assert_allclose(got["x"], np.asarray(res.keypoints.x),
                               atol=1e-5)
    np.testing.assert_array_equal(got["desc"], np.asarray(res.descriptors))
    np.testing.assert_array_equal(got["matches"], np.asarray(matches))

    prob, _, _, _ = synthetic_ba(seed=0, n_cams=5, n_pts=96)
    lm, place = make_distributed_lm(mesh, iterations=10)
    state = lm(place(prob))
    np.testing.assert_allclose(float(got["ba_cost"]), float(state.cost),
                               rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(got["ba_rot"], np.asarray(state.rotations),
                               atol=1e-5)


@pytest.mark.slow
def test_worker_loss_resume_from_checkpoint(tmp_path):
    """Elastic recovery (SURVEY §5 failure detection): a 2-process
    distributed LM loses worker 1 mid-run (hard os._exit after chunk 1's
    checkpoint is durable); the supervisor — this test — detects the
    exit, kills the survivor, and restarts a fresh cluster that resumes
    from the checkpoint and completes.  Final state must match an
    uninterrupted single-process run of the same chunked schedule."""
    import time

    def launch(port, die_after):
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env.pop("XLA_FLAGS", None)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        return [
            subprocess.Popen(
                [sys.executable,
                 os.path.join(REPO, "tests", "elastic_worker.py"),
                 str(pid), "2", str(port), str(tmp_path), str(die_after)],
                env=env, cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for pid in range(2)
        ]

    # Phase 1: worker 1 dies after chunk index 1 (10 of 15 iterations).
    workers = launch(_free_port(), die_after=1)
    out1, _ = workers[1].communicate(timeout=900)
    assert workers[1].returncode == 17, out1.decode(errors="replace")
    # Failure detected by the supervisor -> tear down the survivor (it
    # is blocked in the next cross-process barrier).
    time.sleep(1.0)
    workers[0].kill()
    workers[0].communicate(timeout=60)
    ckpt = np.load(tmp_path / "ba_ckpt.npz")
    assert int(ckpt["iteration"]) == 10
    assert not (tmp_path / "elastic_final.npz").exists()

    # Phase 2: fresh cluster resumes from the checkpoint.
    workers = launch(_free_port(), die_after=-1)
    logs = [w.communicate(timeout=900)[0].decode(errors="replace")
            for w in workers]
    assert all(w.returncode == 0 for w in workers), "\n".join(logs)
    assert "resuming at iteration 10" in logs[0]
    got = np.load(tmp_path / "elastic_final.npz")

    # Uninterrupted single-process reference, same chunked schedule.
    from jax.sharding import Mesh  # noqa: F401 (doc only)
    from sift_jax.parallel.batched import make_mesh
    from sift_jax.parallel.dba import make_lm_stepper
    from tests.test_ba import synthetic_ba

    prob, *_ = synthetic_ba(seed=3, n_cams=5, n_pts=96)
    init, step, place = make_lm_stepper(make_mesh(8), chunk=5)
    placed = place(prob)
    state = init(placed)
    for _ in range(3):
        state = step(placed, state)
    # Cost and rotations only (like the identity test above): the
    # monocular scale gauge is a near-null direction, and the 2x4- vs
    # 8-device psum reduction orders round differently along it, so
    # point/translation coordinates drift while the optimum (cost) and
    # the scale-free rotations agree.
    np.testing.assert_allclose(got["cost"], np.asarray(state.cost),
                               rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(got["rotations"],
                               np.asarray(state.rotations), atol=1e-5)
