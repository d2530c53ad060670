"""Image IO + conversion helpers.

Equivalent capability to the reference's OpenCV adapter
(/root/reference/cvUtils/Conversion.{hh,cc}: cvMatToImage / imageToCvMat /
localKptToCvKpt / descriptorToCvMat / cvtMatchToDMatch) — here the host
image type is a float32 numpy array and the adapters convert SiftResult
into cv2 types for interop and visual verification.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def load_grayscale(path: str) -> np.ndarray:
    """Read an image as float32 grayscale (≙ cv::imread(..., IMREAD_GRAYSCALE)
    + cvMatToImage<float>, ConversionImpl.hpp:7-31)."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(f"cannot read image: {path}")
    return img.astype(np.float32)


def to_cv_keypoints(result) -> List:
    """SiftResult -> list[cv2.KeyPoint] (≙ localKptToCvKpt,
    Conversion.cc:21-43, incl. the packed-octave field)."""
    import cv2

    n = int(result.count)
    kp = result.keypoints
    x = np.asarray(kp.x)[:n]
    y = np.asarray(kp.y)[:n]
    size = np.asarray(kp.size)[:n]
    angle = np.asarray(kp.angle)[:n]
    resp = np.asarray(kp.response)[:n]
    packed = np.asarray(kp.packed_octave())[:n]
    return [cv2.KeyPoint(float(x[i]), float(y[i]), float(size[i]),
                         float(angle[i]), float(resp[i]), int(packed[i]))
            for i in range(n)]


def to_cv_descriptors(result) -> np.ndarray:
    """SiftResult -> [N, 128] float32 cv-compatible descriptor matrix
    (≙ descriptorToCvMat, ConversionImpl.hpp:65-83)."""
    n = int(result.count)
    return np.asarray(result.descriptors)[:n].astype(np.float32)


def matches_to_cv_dmatches(match_idx: np.ndarray) -> List:
    """[Q] match indices (-1 = none) -> list[cv2.DMatch]
    (≙ cvtMatchToDMatch, Conversion.cc:45-58)."""
    import cv2

    return [cv2.DMatch(int(q), int(t), 0.0)
            for q, t in enumerate(np.asarray(match_idx)) if t >= 0]


def load_image_directory(path: str) -> Tuple[List[str], List[np.ndarray]]:
    """Sorted grayscale frames from a directory
    (≙ loadImagesFromDirectory, extract_and_match_example.cc:14-34).
    PNM directories decode through the native multithreaded loader
    (native/sift_io.cpp) when it is built; everything else via cv2."""
    import os

    exts = {".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".pgm",
            ".ppm", ".pnm"}
    names = sorted(f for f in os.listdir(path)
                   if os.path.splitext(f)[1].lower() in exts)
    paths = [os.path.join(path, f) for f in names]

    pnm = {".pgm", ".ppm", ".pnm"}
    if names and all(os.path.splitext(f)[1].lower() in pnm for f in names):
        from sift_jax.io import native

        if native.available():
            return names, list(native.FrameLoader(paths, n_threads=4))
    return names, [load_grayscale(p) for p in paths]
