"""End-to-end SfM reconstruction CLI (tools/reconstruct.py): rendered
3-frame sequence -> matches -> essential RANSAC -> triangulation -> BA,
single-device and distributed over the 8-device virtual mesh."""
import re

import numpy as np
import pytest

from tests.test_odometry import FX, render_sequence


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    import cv2

    frames, _, _ = render_sequence(n_frames=3, n_pts=220)
    d = tmp_path_factory.mktemp("recon")
    paths = []
    for i, f in enumerate(frames):
        p = str(d / f"f{i}.png")
        cv2.imwrite(p, f.astype(np.uint8))
        paths.append(p)
    return paths


def _run(image_files, capsys, extra=()):
    from sift_jax.tools import reconstruct as cli

    cli.main(list(image_files) + ["--fx", str(FX),
                                  "--num-features", "800"] + list(extra))
    out = capsys.readouterr().out
    m = re.search(r"mean sq reproj ([0-9.]+) -> ([0-9.]+) px\^2 over "
                  r"(\d+) observations, (\d+) points", out)
    assert m, out
    return (float(m.group(1)), float(m.group(2)),
            int(m.group(3)), int(m.group(4)), out)


def test_reconstruct_cli(image_files, capsys):
    c0, c1, n_obs, n_pts, out = _run(image_files, capsys)
    assert n_pts > 50 and n_obs >= 2 * n_pts
    assert c1 <= c0 and c1 < 1.0, out   # sub-pixel mean sq reprojection


def test_reconstruct_cli_distributed(image_files, capsys):
    c0, c1, n_obs, n_pts, out = _run(image_files, capsys,
                                     ("--distributed",))
    assert "distributed over 8 devices" in out
    assert c1 < 1.0, out
