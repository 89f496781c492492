"""Parity of the port's image ops (sr_livo_tpu_torch.ops.image_ops) and its
host remap (sr_livo_tpu_torch.runtime.remap) with the JAX package's.

Same numpy inputs through both packages on the CPU.  Gray, pyramids,
Scharr derivatives, bilinear sampling and remap agree within 1e-4 on the
0-255 scale; `extract_patches` is bit-exact, including windows clamped at
the border and pyramid levels smaller than the window.  CLAHE bins by
truncation, so a value computed in a different float order can land in the
neighbouring bin: CLAHE and the YCrCb equalization agree within 1e-3 on at
least 99.9% of the pixels.  The port's host remap (its native C++ and its
numpy plain version) equals the JAX package's `native.remap_u8` bit for
bit.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr_livo_tpu.config import LivoConfig as JCfg
from sr_livo_tpu.models.vision import VisionModule as JVision
from sr_livo_tpu.ops import image_ops as jio
from sr_livo_tpu.runtime import native
from sr_livo_tpu_torch.config import LivoConfig as TCfg
from sr_livo_tpu_torch.models.vision import VisionModule as TVision
from sr_livo_tpu_torch.ops import image_ops as tio
from sr_livo_tpu_torch.runtime.remap import remap_u8
from tests.test_image_lk import _texture
from tests.torch_threads import one_intraop_thread  # noqa: F401

RNG = np.random.RandomState(31)
ATOL = 1e-4


def _image(h=120, w=160):
    """Smooth texture plus noise, three channels, 0-255."""
    base = _texture(h, w)[..., None] * np.array([1.0, 0.8, 0.6])
    return np.clip(base + RNG.uniform(-20, 20, (h, w, 3)), 0,
                   255).astype(np.float32)


def _close_share(a, b, atol):
    return float(np.mean(np.abs(np.asarray(a) - np.asarray(b)) <= atol))


def test_gray_pyramid_scharr():
    rgb = _image()
    jg = jio.rgb_to_gray(jnp.asarray(rgb))
    tg = tio.rgb_to_gray(torch.as_tensor(rgb))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=ATOL, rtol=0)
    g = tg.numpy()
    jp = jio.build_pyramid(jnp.asarray(g), 4)
    tp = tio.build_pyramid(torch.as_tensor(g), 4)
    assert [t.shape for t in tp] == [j.shape for j in jp]
    for t, j in zip(tp, jp):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL,
                                   rtol=0)
        jdx, jdy = jio.scharr_derivatives(j)
        tdx, tdy = tio.scharr_derivatives(torch.as_tensor(np.array(j)))
        np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(tdy.numpy(), np.asarray(jdy), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("channels", [1, 3])
def test_bilinear_and_remap(channels):
    img = _image(48, 64)
    img = img[..., 0] if channels == 1 else img
    # in-range, border and out-of-range coordinates (clamped)
    uv = np.c_[RNG.uniform(-3, 67, 500), RNG.uniform(-3, 51, 500)].astype(
        np.float32)
    uv[:4] = [[0, 0], [63, 47], [62.999, 46.999], [31.5, 23.5]]
    j = jio.bilinear_sample(jnp.asarray(img), jnp.asarray(uv))
    t = tio.bilinear_sample(torch.as_tensor(img), torch.as_tensor(uv))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=0)

    k = np.array([[40.0, 0, 32.0], [0, 40.0, 24.0], [0, 0, 1]])
    m = jio.make_undistort_map(k, np.array([-0.2, 0.05, 1e-3, -1e-3, 0.0]),
                               (48, 64))
    np.testing.assert_array_equal(
        tio.make_undistort_map(k, [-0.2, 0.05, 1e-3, -1e-3, 0.0], (48, 64)),
        m)
    j = jio.remap(jnp.asarray(img), jnp.asarray(m))
    t = tio.remap(torch.as_tensor(img), torch.as_tensor(m))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape,size", [((120, 160), 34), ((15, 20), 34),
                                        ((8, 40), 22)])
def test_extract_patches_bit_exact(shape, size):
    """Interior, border-clamped and negative starts; the last two shapes
    are pyramid levels smaller than the window on one or both axes."""
    img = RNG.uniform(0, 255, shape).astype(np.float32)
    tl = np.c_[RNG.randint(-40, shape[0] + 40, 300),
               RNG.randint(-40, shape[1] + 40, 300)].astype(np.int32)
    j = jio.extract_patches(jnp.asarray(img), jnp.asarray(tl), size)
    t = tio.extract_patches(torch.as_tensor(img), torch.as_tensor(tl), size)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))

    centers = np.c_[RNG.uniform(-5, shape[1] + 5, 300),
                    RNG.uniform(-5, shape[0] + 5, 300)].astype(np.float32)
    j = jio.sample_windows_bilinear(jnp.asarray(img), jnp.asarray(centers),
                                    21)
    t = tio.sample_windows_bilinear(torch.as_tensor(img),
                                    torch.as_tensor(centers), 21)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape,tiles,clip", [((120, 160), 8, 3.0),
                                              ((512, 640), 32, 3.0),
                                              ((64, 96), 4, 1.0)])
def test_clahe(shape, tiles, clip):
    gray = tio.rgb_to_gray(torch.as_tensor(_image(*shape))).numpy()
    gray = gray * 0.4 + 60.0           # low contrast: equalization bites
    j = jio.clahe(jnp.asarray(gray), clip, tiles)
    t = tio.clahe(torch.as_tensor(gray), clip, tiles)
    assert t.shape == gray.shape
    assert _close_share(t.numpy(), j, 1e-3) >= 0.999


def test_equalize_color_ycrcb():
    img = _image(120, 160)
    j = jio.equalize_color_ycrcb(jnp.asarray(img), 8)
    t = tio.equalize_color_ycrcb(torch.as_tensor(img), 8)
    assert _close_share(t.numpy(), j, 1e-3) >= 0.999


def test_host_remap_matches_native():
    """The port's numpy remap (the plain version of its native one)
    against the JAX package's native host remap, bit for bit."""
    rng = np.random.RandomState(3)
    h, w = 48, 64
    img = rng.randint(0, 255, (h, w, 3)).astype(np.uint8)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    m = np.stack([xs * 0.9 + 2.0 * np.sin(ys / 7.0) + 1.0,
                  ys * 0.95 + 1.5 * np.cos(xs / 9.0)], -1).astype(np.float32)
    m[0, :4] = [[-2.0, -2.0], [70.0, 50.0], [63.0, 47.0], [62.9, 46.9]]
    np.testing.assert_array_equal(remap_u8(img, m), native.remap_u8(img, m))
    np.testing.assert_array_equal(remap_u8(img[..., 0], m).shape, (h, w))


def _vision_cfgs():
    def cfg(cls):
        c = cls()
        c.camera_options.image_width = 64
        c.camera_options.image_height = 48
        c.camera_options.image_scale = 0.5
        c.camera_options.camera_intrinsic = [40.0, 0.0, 32.0, 0.0, 40.0,
                                             24.0, 0, 0, 1]
        c.camera_options.camera_dist_coeffs = [-0.05, 0.01, 0.0, 0.0, 0.0]
        return c
    j, t = cfg(JCfg), cfg(TCfg)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def test_vision_preprocess_matches_jax():
    """VisionModule.preprocess on a float frame at the processed size (the
    on-device undistort path) and on a full-size uint8 frame (the host
    remap path), and the host resize, against the JAX package's."""
    jcfg, tcfg = _vision_cfgs()
    jv, tv = JVision(jcfg), TVision(tcfg, device="cpu")
    np.testing.assert_array_equal(tv.host_map, jv.host_map)
    frame = _image(24, 32)
    jrgb, jgray = jv.preprocess(frame)
    trgb, tgray = tv.preprocess(frame)
    assert _close_share(tgray.numpy(), jgray, 1e-3) >= 0.999
    assert _close_share(trgb.numpy(), jrgb, 1e-3) >= 0.999

    full = _image(48, 64).astype(np.uint8)
    t_u8, t_re = tv._host_prepare(full)
    j_u8, j_re = jv._host_prepare(full)
    assert t_re and j_re
    np.testing.assert_array_equal(t_u8, j_u8)
    odd = _image(30, 50)                      # resized on the host
    np.testing.assert_array_equal(tv._host_prepare(odd)[0],
                                  jv._host_prepare(odd)[0])
