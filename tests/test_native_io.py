"""Native C++ IO runtime (native/sift_io.cpp via ctypes): PNM decode,
RGB->gray, ordered multithreaded prefetch, resize — vs cv2 oracles."""
import os

import cv2
import numpy as np
import pytest

from sift_jax.io import native

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native lib not built")


@pytest.fixture(scope="module")
def pgm_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("pgm")
    rng = np.random.default_rng(0)
    out = []
    for i in range(6):
        img = rng.integers(0, 256, (120, 160), np.uint8)
        p = str(d / f"f{i}.pgm")
        cv2.imwrite(p, img)
        out.append((p, img))
    return out


def test_read_pnm_binary(pgm_files):
    p, img = pgm_files[0]
    a = native.read_pnm(p)
    np.testing.assert_array_equal(a, img.astype(np.float32))


def test_read_pnm_ascii(tmp_path):
    img = np.arange(12, dtype=np.uint8).reshape(3, 4)
    p = str(tmp_path / "a.pgm")
    with open(p, "w") as f:
        f.write("P2\n# comment\n4 3\n255\n"
                + " ".join(str(v) for v in img.ravel()))
    np.testing.assert_array_equal(native.read_pnm(p),
                                  img.astype(np.float32))


def test_read_ppm_color(tmp_path):
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (20, 30, 3), np.uint8)
    p = str(tmp_path / "c.ppm")
    cv2.imwrite(p, rgb[..., ::-1])  # cv2 writes BGR
    a = native.read_pnm(p)
    ref = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    assert np.abs(a - ref).max() < 0.51


def test_rgb8_to_gray():
    rng = np.random.default_rng(2)
    rgb = rng.integers(0, 256, (50, 60, 3), np.uint8)
    g = native.rgb8_to_gray(rgb)
    ref = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    assert np.abs(g - ref).max() < 1e-3


def test_frame_loader_ordered(pgm_files):
    ld = native.FrameLoader([p for p, _ in pgm_files], n_threads=3,
                            capacity=2)
    frames = list(ld)
    assert len(frames) == len(pgm_files)
    for f, (_, img) in zip(frames, pgm_files):
        np.testing.assert_array_equal(f, img.astype(np.float32))


def test_frame_loader_resize(pgm_files):
    p, img = pgm_files[0]
    ld = native.FrameLoader([p], out_size=(80, 60))
    f = next(ld)
    ref = cv2.resize(img.astype(np.float32), (80, 60),
                     interpolation=cv2.INTER_LINEAR)
    assert f.shape == (60, 80)
    assert np.abs(f - ref).max() < 1e-2


def test_missing_file_error(tmp_path):
    with pytest.raises(IOError):
        native.read_pnm(str(tmp_path / "nope.pgm"))
