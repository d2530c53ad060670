"""Golden-checkpoint capture + per-stage replay verification round-trip
(≙ tool/perf.cu over Detector::setDataGen output)."""
import numpy as np
import pytest

from sift_jax.config import SiftConfig
from sift_jax.perf.checkpoint import capture_golden, load_golden
from sift_jax.perf.replay import Replayer


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    from tests.conftest import synthetic_image

    path = str(tmp_path_factory.mktemp("golden"))
    img = synthetic_image(height=120, width=160, seed=2, n_blobs=20)
    cfg = SiftConfig(width=160, height=120, num_features=500)
    capture_golden(cfg, img, path)
    return path


def test_roundtrip_and_replay_all(checkpoint):
    params, inputs, expected = load_golden(checkpoint)
    rep = Replayer(params, inputs, expected)
    results = rep.run_all()
    failures = {k: v for k, v in results.items() if not v[0]}
    assert not failures, f"stage replays failed: {failures}"


def test_checkpoint_files_exist(checkpoint):
    import os

    for f in ("params.npz", "input.npz", "expected.npz"):
        assert os.path.exists(os.path.join(checkpoint, f))


def test_replay_detects_corruption(checkpoint):
    """A corrupted golden output must fail verification."""
    params, inputs, expected = load_golden(checkpoint)
    expected = dict(expected)
    expected["dog0"] = expected["dog0"] + 1.0
    rep = Replayer(params, inputs, expected)
    ok, _ = rep.run_minus()
    assert not ok


def test_oracle_verification(tmp_path):
    """De-circularized parity: a checkpoint with a recorded cv2.SIFT
    oracle verifies a FRESH pipeline run against the independent oracle
    (perf/oracle.py; tools/perf.py --oracle)."""
    from tests.conftest import synthetic_image

    from sift_jax.perf.oracle import capture_oracle, has_oracle, \
        verify_oracle

    img = synthetic_image(height=240, width=320, seed=1, n_blobs=40)
    cfg = SiftConfig(width=320, height=240, num_features=2000,
                     upscale=True)
    path = str(tmp_path)
    capture_golden(cfg, img, path)
    capture_oracle(cfg, img, path)
    assert has_oracle(path)

    checks = verify_oracle(path)
    assert checks["ok"], checks

    # and a drifted pipeline must FAIL the oracle gate: corrupt the
    # recorded oracle positions to emulate drift.
    import numpy as np
    import os
    orc = dict(np.load(os.path.join(path, "oracle.npz")))
    orc["x"] = orc["x"] + 3.0
    np.savez_compressed(os.path.join(path, "oracle.npz"), **orc)
    assert not verify_oracle(path)["ok"]
