"""The port's live viewer (sr_livo_tpu_torch.runtime.live_viewer) against
the JAX package's script (scripts/live_viewer.py), on a stream directory
the port's StreamPublisher wrote: `load_state` returns the script's
arrays bit for bit (the whole map, a thinned map, an empty stream), and
`--once` writes the PNG.
"""
import importlib.util
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from sr_livo_tpu_torch.ops.color_map import (C_NRGB, C_POS, C_RGB, C_VALID,
                                             REG_WIDTH)
from sr_livo_tpu_torch.runtime import live_viewer
from sr_livo_tpu_torch.runtime import streaming as tstream

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_VIEWER_PATH = os.path.join(REPO, "scripts", "live_viewer.py")
N_FRAMES, ROWS_PER_FRAME = 12, 40


@pytest.fixture(scope="module")
def jviewer():
    spec = importlib.util.spec_from_file_location("jax_live_viewer",
                                                  JAX_VIEWER_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def stream_dirs(tmp_path_factory):
    """A port stream of N_FRAMES seeded poses with a colored registry that
    grows by ROWS_PER_FRAME rows a frame (a third of them not yet seen
    often enough to publish), and an empty stream."""
    rng = np.random.RandomState(5)
    n = N_FRAMES * ROWS_PER_FRAME
    reg = np.zeros((n, REG_WIDTH), np.float32)
    reg[:, C_POS] = rng.uniform(-8, 8, (n, 3))
    reg[:, C_RGB] = rng.randint(0, 256, (n, 3))
    reg[:, C_NRGB] = rng.randint(0, 6, n)
    reg[:, C_VALID] = 1.0
    full = str(tmp_path_factory.mktemp("live"))
    pub = tstream.StreamPublisher(full, path_stride=2, map_every_n_frames=3,
                                  pub_point_minimum_views=2)
    for i in range(N_FRAMES):
        rec = torch.as_tensor(rng.randn(19).astype(np.float32))
        cmap = types.SimpleNamespace(reg=torch.as_tensor(reg),
                                     count=torch.tensor((i + 1)
                                                        * ROWS_PER_FRAME))
        pub.publish_frame(0.1 * (i + 1), rec, cmap)
    pub.close()
    assert pub.last_error is None
    empty = str(tmp_path_factory.mktemp("empty"))
    tstream.StreamPublisher(empty).close()
    return {"full": full, "empty": empty}


@pytest.mark.parametrize("case,max_points", [("full", 400_000),
                                             ("full", 100), ("empty", 10)])
def test_load_state_matches_jax(jviewer, stream_dirs, case, max_points):
    d = stream_dirs[case]
    port = live_viewer.load_state(d, max_points)
    ref = jviewer.load_state(d, max_points)
    assert port[4] == ref[4]                     # chunks
    for a, b in zip(port[:4], ref[:4]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    if case == "full":
        assert port[4] == N_FRAMES // 3
        assert port[3].shape == (N_FRAMES, 3)
        assert 0 < port[0].shape[0] <= max_points
        assert port[1].min() >= 0.0 and port[1].max() <= 1.0


def test_once_writes_the_png(stream_dirs, tmp_path):
    pytest.importorskip("matplotlib")
    png = str(tmp_path / "view.png")
    r = subprocess.run(
        [sys.executable, "-m", "sr_livo_tpu_torch.runtime.live_viewer",
         stream_dirs["full"], "--once", "--out", png], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "rendered" in r.stderr
    with open(png, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert os.path.getsize(png) > 10_000
