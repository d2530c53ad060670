"""End-to-end detect+compute parity vs cv2.SIFT — the reference's own
oracle (readme.md:5) and BASELINE config #1/#2 gating."""
import cv2
import numpy as np
import pytest

from sift_jax.config import SiftConfig
from sift_jax.pipeline.detector import SiftDetector


@pytest.fixture(scope="module", params=["discs", "textured", "photo"])
def scene_image(request):
    """Parity gates run on THREE scene families: the disc scene (step
    edges, strong isolated extrema), the perspective-warped value-noise
    plane (gradients everywhere), and a REAL photograph (saturation
    clipping, JPEG-textured gradients — the reference's real-world dev
    regime, tool/extract_and_match_example.cc:14-34).  The photo is the
    public-domain Grace Hopper portrait (official US Navy photograph, a
    US-government work), committed grayscale at tests/data/."""
    from tests.conftest import synthetic_image, textured_image
    if request.param == "discs":
        return synthetic_image()
    if request.param == "photo":
        import os
        p = os.path.join(os.path.dirname(__file__), "data",
                         "real_photo.png")
        return cv2.imread(p, cv2.IMREAD_GRAYSCALE).astype(np.float32)
    return textured_image()


@pytest.fixture(scope="module")
def detector(scene_image):
    h, w = scene_image.shape
    cfg = SiftConfig(width=w, height=h, num_features=2000, upscale=True)
    return SiftDetector(cfg)


@pytest.fixture(scope="module")
def results(detector, scene_image):
    # Both sides see the identical uint8-quantized frame (cv2.SIFT converts
    # to 8-bit internally; feeding our detector the unquantized float image
    # would compare different inputs, not different implementations).
    img8 = scene_image.astype(np.uint8)
    res = detector.detect_and_compute(img8.astype(np.float32))
    sift = cv2.SIFT_create(contrastThreshold=0.04, edgeThreshold=10,
                           sigma=1.6)
    kps_cv, desc_cv = sift.detectAndCompute(img8, None)
    return res, kps_cv, desc_cv


def _unpack(res):
    n = int(res.count)
    kp = res.keypoints
    return (n, np.asarray(kp.x)[:n], np.asarray(kp.y)[:n],
            np.asarray(kp.angle)[:n], np.asarray(kp.size)[:n],
            np.asarray(res.descriptors)[:n])


def test_keypoint_recall(results):
    """Every OpenCV keypoint must have one of ours within 0.5 px."""
    res, kps_cv, _ = results
    n, kx, ky, _, _, _ = _unpack(res)
    assert n > 100
    missed = 0
    for k in kps_cv:
        d = np.hypot(kx - k.pt[0], ky - k.pt[1])
        if d.min() > 0.5:
            missed += 1
    assert missed <= max(2, len(kps_cv) // 100), \
        f"{missed}/{len(kps_cv)} OpenCV keypoints unmatched"


def test_keypoint_precision(results):
    """Few spurious keypoints: >=95% of ours are within 0.5 px of an
    OpenCV keypoint."""
    res, kps_cv, _ = results
    n, kx, ky, _, _, _ = _unpack(res)
    cvx = np.array([k.pt[0] for k in kps_cv])
    cvy = np.array([k.pt[1] for k in kps_cv])
    spurious = sum(
        1 for i in range(n)
        if np.hypot(cvx - kx[i], cvy - ky[i]).min() > 0.5)
    assert spurious <= max(2, n // 20), f"{spurious}/{n} spurious"


def test_angle_and_size_parity(results):
    res, kps_cv, _ = results
    n, kx, ky, ka, ks, _ = _unpack(res)
    cvp = np.array([[k.pt[0], k.pt[1], k.angle, k.size] for k in kps_cv])
    ok = total = 0
    for i in range(n):
        d = np.hypot(cvp[:, 0] - kx[i], cvp[:, 1] - ky[i])
        cand = np.where(d < 0.5)[0]
        if len(cand) == 0:
            continue
        total += 1
        da = np.abs(((cvp[cand, 2] - ka[i]) + 180) % 360 - 180)
        j = cand[np.argmin(da)]
        if da.min() < 1.0 and abs(cvp[j, 3] - ks[i]) < 0.05 * cvp[j, 3]:
            ok += 1
    assert ok >= 0.97 * total, f"angle/size parity {ok}/{total}"


def test_descriptor_parity(results):
    """Descriptors of angle-matched keypoints within tolerance.  The
    reference accepts +-1 in half space (HostInterface.cu:369-376); we gate
    p90 max-abs error <= 2 of 255 against OpenCV."""
    res, kps_cv, desc_cv = results
    n, kx, ky, ka, _, desc = _unpack(res)
    cvp = np.array([[k.pt[0], k.pt[1], k.angle] for k in kps_cv])
    errs = []
    for i in range(n):
        d = np.hypot(cvp[:, 0] - kx[i], cvp[:, 1] - ky[i])
        da = np.abs(((cvp[:, 2] - ka[i]) + 180) % 360 - 180)
        cand = np.where((d < 0.5) & (da < 1.0))[0]
        if len(cand):
            j = cand[np.argmin(d[cand])]
            errs.append(
                np.abs(desc_cv[j].astype(np.float32) - desc[i]).max())
    errs = np.array(errs)
    assert len(errs) >= 100
    assert np.percentile(errs, 90) <= 2.0, \
        f"p90 desc err {np.percentile(errs, 90)}"
    assert np.median(errs) <= 1.0


def test_no_upscale_mode(test_image):
    """Reference default config (upscale=false, CudaSiftConfig.hh:12-13)
    still runs and finds keypoints."""
    h, w = test_image.shape
    cfg = SiftConfig(width=w, height=h, num_features=500, upscale=False)
    det = SiftDetector(cfg)
    res = det.detect_and_compute(test_image)
    n = int(res.count)
    assert 10 < n <= 500
    kp = res.keypoints
    assert np.asarray(kp.valid)[:n].all()
    assert not np.asarray(kp.valid)[n:].any()


def test_prev_descriptor_rotation(detector, scene_image):
    """prev_descriptor carries frame t-1 (Detector.cu:136-141)."""
    r1 = detector.detect_and_compute(scene_image)
    r2 = detector.detect_and_compute(scene_image[::-1].copy())
    assert detector.prev_descriptors is not None
    np.testing.assert_array_equal(np.asarray(detector.prev_descriptors),
                                  np.asarray(r1.descriptors))
    np.testing.assert_array_equal(np.asarray(detector.last_result.descriptors),
                                  np.asarray(r2.descriptors))


def test_wrong_shape_raises(detector):
    with pytest.raises(ValueError):
        detector.detect_and_compute(np.zeros((10, 10), np.float32))


def test_reference_quirk_modes(test_image):
    """The reference's own behavioral quirks stay supported: DoG-sourced
    orientation histograms (interface/Detector.cu:489), continuous x512
    quantization (SiftOps.cu:617-622), and bilinear round-half octave
    downsampling (image_func/Resize.cu:26-63)."""
    from sift_jax.pipeline.detector import build_detect_fn
    from sift_jax.core.types import build_plan
    import jax

    h, w = test_image.shape
    img = np.asarray(test_image, np.float32)
    cfg = SiftConfig(width=w, height=h, num_features=500,
                     orientation_source="dog", downsample="bilinear")
    fn = jax.jit(build_detect_fn(build_plan(cfg), quant_mode="reference"))
    res = fn(img)
    n = int(res.count)
    assert 10 < n <= 500
    d = np.asarray(res.descriptors)
    # "reference" quantization is continuous in [0, 512] and must NOT be
    # uint8-cast (descriptor_dtype applies to the integer mode only).
    assert d.dtype == np.float32
    assert 0.0 <= d.min() and d.max() <= 512.0
    assert (d[:n] != np.round(d[:n])).any()
