"""The port's file IO against the JAX package's: images, EXR, G-buffer sets,
engine tensor buffers and the native library's build.

``realtime_style_transfer_torch.data.{imaging,exr,native,hdr_screenshots}``
are the port's own copies.  On seeded inputs each gives what the JAX
package's module gives, exactly: the same arrays, the same EXR bytes, the
same decoded planes (the port's library is built from the same
``native/`` sources into ``build/rst_torch_native/``), the same G-buffer
stacks and the same corrupt set skipped.
"""

import logging
import os
from pathlib import Path

import numpy as np
import PIL.Image
import pytest

from realtime_style_transfer_torch.config import channels_from_count
from realtime_style_transfer_torch.data import exr as texr
from realtime_style_transfer_torch.data import hdr_screenshots as thdr
from realtime_style_transfer_torch.data import imaging as timg
from realtime_style_transfer_torch.data import native as tnative
from realtime_style_transfer_tpu.data import exr as jexr
from realtime_style_transfer_tpu.data import hdr_screenshots as jhdr
from realtime_style_transfer_tpu.data import imaging as jimg
from realtime_style_transfer_tpu.data import native as jnative

REPO = Path(__file__).resolve().parent.parent
CHANNELS_17 = channels_from_count(17)


def _image_case(name, tmp_path):
    """(function name, args) of one imaging case on seeded inputs."""
    rng = np.random.default_rng(7)
    img = rng.random((37, 53, 3)).astype(np.float32)
    if name == "cover_resize_shape":
        return [((37, 53), (24, 48)), ((90, 40), (24, 48)), ((24, 48), (24, 48))]
    if name == "resize_bilinear":
        return [(img, (24, 48)), (img, (80, 61)), (img, (37, 53))]
    if name == "center_crop_or_pad":
        return [(img, (24, 48)), (img, (50, 70)), (img, (30, 60))]
    if name == "preprocess_numpy_image":
        return [(img, (24, 48, 3)), (rng.random((20, 30, 17)).astype(np.float32), (24, 48, 17))]
    if name == "load_image":
        png = tmp_path / "a.png"
        PIL.Image.fromarray((img * 255).astype(np.uint8)).save(png)
        return [(png, (24, 48, 3)), (png, (40, 40, 1)), (png, (24, 48, 4))]
    if name == "list_image_paths":
        for rel in ("b/x.PNG", "a.jpg", "c/d/e.webp", "skip.txt"):
            (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
            (tmp_path / rel).write_bytes(b"")
        return [(tmp_path,)]
    wild = np.array([[-1.0, 0.0, 0.5, 1.0, 2.0, np.nan, np.inf]], np.float32)[..., None]
    if name == "image_to_uint8":
        return [(img,), (wild,)]
    assert name == "tensor_to_image"
    return [(img,), (img[..., :1],)]


@pytest.mark.parametrize("name", [
    "cover_resize_shape", "resize_bilinear", "center_crop_or_pad", "preprocess_numpy_image",
    "load_image", "list_image_paths", "image_to_uint8", "tensor_to_image"])
def test_imaging_matches_jax_package(name, tmp_path):
    for args in _image_case(name, tmp_path):
        got = getattr(timg, name)(*args)
        want = getattr(jimg, name)(*args)
        if name == "tensor_to_image":
            assert got.mode == want.mode
            got, want = np.asarray(got), np.asarray(want)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        else:
            assert got == want


@pytest.mark.parametrize("compression", ["none", "rle", "zips", "zip", "piz"])
def test_write_exr_bytes_and_native_read_match_jax_package(tmp_path, compression):
    rng = np.random.default_rng(3)
    h, w = 37, 61  # odd sizes: ragged blocks
    chans = {"R": (rng.random((h, w)) * 100).astype(np.float32),
             "G": rng.random((h, w)).astype(np.float32),
             "B": rng.standard_normal((h, w)).astype(np.float32)}
    for pixel_type in (texr.PIXEL_TYPE_FLOAT, texr.PIXEL_TYPE_HALF):
        mine = texr.write_exr(tmp_path / f"t{pixel_type}.exr", chans, compression=compression,
                              pixel_type=pixel_type)
        theirs = jexr.write_exr(tmp_path / f"j{pixel_type}.exr", chans,
                                compression=compression, pixel_type=pixel_type)
        assert mine.read_bytes() == theirs.read_bytes()
        assert tnative.exr_info(theirs) == jnative.exr_info(theirs) == (w, h, ["B", "G", "R"])
        got, want = tnative.read_exr(theirs), jnative.read_exr(theirs)
        assert sorted(got) == sorted(want) == ["B", "G", "R"]
        for name in want:
            np.testing.assert_array_equal(got[name], want[name])
    with pytest.raises(tnative.ExrError):
        tnative.read_exr(tmp_path / "missing.exr")


def test_native_library_builds_into_the_port_build_dir(tmp_path, monkeypatch):
    """The port's library is named after its sources' digest under
    ``build/rst_torch_native/`` and its build writes only there: the JAX
    package's ``native/librst_native.so`` is never an output."""
    default = tnative.lib_path()
    assert default.parent == REPO / "build" / "rst_torch_native"
    assert default.name.startswith("librst_native_") and default.suffix == ".so"
    calls = []
    run = tnative.subprocess.run

    def recording_run(cmd, *args, **kwargs):
        calls.append(list(cmd))
        return run(cmd, *args, **kwargs)

    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(tnative.subprocess, "run", recording_run)
    lib = tnative.lib_path()
    assert lib.parent == tmp_path / "b" and lib.name == default.name
    tnative._build(lib)
    tnative._build(lib)  # built already: no second compile
    assert lib.exists() and (tmp_path / "b" / ".lock").exists()
    assert len(calls) == 1
    out = Path(calls[0][calls[0].index("-o") + 1])
    assert out.parent == tmp_path / "b"
    assert not any("librst_native.so" in str(a) for a in calls[0])
    assert all(p.suffix in (".so", ".lock", "") for p in (tmp_path / "b").iterdir())


def test_gbuffer_planes_and_tensor_buffers_match_jax_package(tmp_path):
    rng = np.random.default_rng(5)
    png = jexr.write_gbuffer_fixture(tmp_path, "s", CHANNELS_17, 20, 30, seed=5)
    paths = jhdr.gbuffer_paths(png, CHANNELS_17)
    assert thdr.gbuffer_paths(png, CHANNELS_17) == paths
    counts = [c for _, c in CHANNELS_17]
    got = tnative.read_gbuffer_planes(paths, counts, 20, 30, num_threads=3)
    want = jnative.read_gbuffer_planes(paths, counts, 20, 30, num_threads=3)
    assert got.shape == (17, 20, 30)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(tnative.ExrError):
        tnative.read_gbuffer_planes(paths, counts, 21, 30)
    # the engine's raw float32 buffers, written by one package and read by the other
    data = rng.random((8, 12, 3)).astype(np.float32)
    mine = tnative.write_tensor_buffer(tmp_path / "t.buf", data)
    theirs = jnative.write_tensor_buffer(tmp_path / "j.buf", data)
    assert mine.read_bytes() == theirs.read_bytes()
    np.testing.assert_array_equal(jnative.read_tensor_buffer(mine, (8, 12, 3)), data)
    np.testing.assert_array_equal(tnative.read_tensor_buffer(theirs, (8, 12, 3)), data)
    with pytest.raises(ValueError, match="wants 300"):
        tnative.read_tensor_buffer(theirs, (10, 10, 3))


def test_gbuffer_sets_match_jax_package_and_skip_the_same_corrupt_set(tmp_path, caplog):
    shape = (24, 48, 17)
    for i in range(3):
        mine = texr.write_gbuffer_fixture(tmp_path / "t", f"s{i}", CHANNELS_17, 30, 50, seed=i)
        theirs = jexr.write_gbuffer_fixture(tmp_path / "j", f"s{i}", CHANNELS_17, 30, 50,
                                            seed=i)
        assert mine.read_bytes() == theirs.read_bytes()
        for p in jhdr.gbuffer_paths(theirs, CHANNELS_17):
            assert (tmp_path / "t" / p.name).read_bytes() == p.read_bytes()
    # a corrupt set (junk EXR) and an incomplete one (missing EXR)
    (tmp_path / "j" / "s1_BaseColor.exr").write_bytes(b"not an exr")
    os.remove(tmp_path / "j" / "s2_SceneDepth.exr")
    pngs = thdr.find_screenshots(tmp_path / "j")
    assert pngs == jhdr.find_screenshots(tmp_path / "j")
    np.testing.assert_array_equal(thdr.load_unreal_hdr_screenshot(pngs[0], CHANNELS_17),
                                  jhdr.load_unreal_hdr_screenshot(pngs[0], CHANNELS_17))
    with caplog.at_level(logging.WARNING):
        got = list(thdr.iter_hdr_screenshots(pngs, CHANNELS_17, shape, (24, 48, 3)))
        port_skips = [r.getMessage() for r in caplog.records]
        caplog.clear()
        want = list(jhdr.iter_hdr_screenshots(pngs, CHANNELS_17, shape, (24, 48, 3)))
        jax_skips = [r.getMessage() for r in caplog.records]
    assert len(got) == len(want) == 1
    for (gc, gg), (wc, wg) in zip(got, want):
        assert gc.shape == shape
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gg, wg)
    assert len(port_skips) == 2 and [m.split(":")[0] for m in port_skips] == \
        [m.split(":")[0] for m in jax_skips]
    assert "s1.png" in port_skips[0] and "s2.png" in port_skips[1]
