"""The port's dataset half (``data/pipeline.py``, ``data/wikiart.py``) against
the JAX package's, on the CPU, on ``tests/test_wikiart.py``'s fake corpus (a
synthetic manifest and its images): the seeded split, ``get_dataset``,
``get_dataset_debug`` and ``get_hdr_dataset`` give equal batches
(``np.array_equal``); the ``IndexedDataset`` cache and ``SkipSample``; the
``.npz`` sample files each package reads of the other; and the
``DevicePrefetcher`` over ``(dict, dict)`` training batches on the CPU."""

import csv
import logging

import numpy as np
import PIL.Image
import pytest
import torch

from realtime_style_transfer_torch.config import ShapeConfig as TConfig
from realtime_style_transfer_torch.data import pipeline as tpipe
from realtime_style_transfer_torch.data import wikiart as twiki
from realtime_style_transfer_tpu.config import ShapeConfig as JConfig
from realtime_style_transfer_tpu.data import pipeline as jpipe
from realtime_style_transfer_tpu.data import wikiart as jwiki

SDR = dict(resolution_divider=16, bottleneck_res_y=15, bottleneck_num_filters=4,
           num_channels=3, hdr=False)
HDR = dict(SDR, num_channels=6, hdr=True)


@pytest.fixture()
def fake_corpus(tmp_path, monkeypatch, rng):
    """tests/test_wikiart.py's corpus: a manifest of 10 rows and an image a
    row, named by the row's sha1; both packages' module paths point at it."""
    style_dir = tmp_path / "wikiart"
    image_dir = style_dir / "images"
    image_dir.mkdir(parents=True)
    manifest = style_dir / "wikiart_scraped.csv"
    rows = [{"Style": f"style{i}", "Artwork": f"art{i}", "Artist": f"artist{i}",
             "Date": str(1900 + i), "Link": f"http://example.com/{i}.jpg"}
            for i in range(10)]
    with open(manifest, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    for module in (twiki, jwiki):
        monkeypatch.setattr(module, "STYLE_TARGET_DIR", style_dir)
        monkeypatch.setattr(module, "STYLE_IMAGE_DIR", image_dir)
        monkeypatch.setattr(module, "MANIFEST_FILEPATH", manifest)
    for row in rows:
        arr = (rng.random((32, 48, 3)) * 255).astype(np.uint8)
        PIL.Image.fromarray(arr).save(jwiki.image_manifest_to_filepath(row))
    return rows


def _content(root, rng, n=3):
    for sub in ("training", "validation"):
        (root / sub).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            arr = (rng.random((40, 60, 3)) * 255).astype(np.uint8)
            PIL.Image.fromarray(arr).save(root / sub / f"{i}.png")
    return root


def _assert_trees_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_trees_equal(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_trees_equal(g, w)
    else:
        assert got.dtype == want.dtype and np.array_equal(got, want)


def _assert_datasets_equal(got, want):
    assert got[2:] == want[2:]  # n_train, n_val
    for make_got, make_want in zip(got[:2], want[:2]):
        batches_got, batches_want = list(make_got()), list(make_want())
        assert len(batches_got) == len(batches_want) > 0
        _assert_trees_equal(batches_got, batches_want)


def test_manifest_naming_and_split_match_jax(fake_corpus):
    assert twiki.style_filepaths() == jwiki.style_filepaths()
    assert twiki.style_filepaths(seed=36) == jwiki.style_filepaths(seed=36)
    row = fake_corpus[3]
    assert twiki.image_manifest_to_filepath(row) == jwiki.image_manifest_to_filepath(row)
    assert twiki.lookup_manifest_by_hash(
        twiki.image_manifest_to_filepath(row).stem) == row
    paths = twiki.style_filepaths()
    for seed in (None, 11, 36):
        assert tpipe.split_train_validation(paths, seed=seed) == \
            jpipe.split_train_validation(paths, seed=seed)


@pytest.mark.parametrize("cached", [False, True])
def test_get_dataset_batches_equal_jax(fake_corpus, tmp_path, rng, cached):
    content = _content(tmp_path / "content", rng)
    kw = dict(seed=11, content_dir=content)
    got = twiki.get_dataset(TConfig(**SDR), 2, cache_dir=tmp_path / "tcache" if cached
                            else None, **kw)
    want = jwiki.get_dataset(JConfig(**SDR), 2, cache_dir=tmp_path / "jcache" if cached
                             else None, **kw)
    _assert_datasets_equal(got, want)
    if cached:
        # the second pass reads the cache; its files are the JAX package's
        _assert_datasets_equal(got, want)
        assert sorted(p.name for p in (tmp_path / "tcache").iterdir()) == \
            sorted(p.name for p in (tmp_path / "jcache").iterdir())
    # unbatched samples too
    single = twiki.get_dataset(TConfig(**SDR), None, **kw)
    first = next(iter(single[0]()))
    _assert_trees_equal(first, next(iter(jwiki.get_dataset(JConfig(**SDR), None, **kw)[0]())))


def test_get_dataset_debug_batches_equal_jax(fake_corpus, tmp_path, monkeypatch, rng):
    for module, name in ((twiki, "t"), (jwiki, "j")):
        monkeypatch.setattr(module, "STYLE_DEBUG_IMAGE_DIR", tmp_path / f"{name}_debug")
        monkeypatch.setattr(module, "CONTENT_DEBUG_IMAGE_DIR", tmp_path / "content")
    _content(tmp_path / "content", rng, n=4)
    styles = twiki.style_filepaths(seed=1)
    got = twiki.get_dataset_debug(TConfig(**SDR), 2, style_paths=styles)
    want = jwiki.get_dataset_debug(JConfig(**SDR), 2, style_paths=styles)
    _assert_datasets_equal(got, want)
    # materialized: a second call serves the same layout, and refuses style_paths
    _assert_datasets_equal(twiki.get_dataset_debug(TConfig(**SDR), 2), want)
    with pytest.raises(ValueError, match="already materialized"):
        twiki.get_dataset_debug(TConfig(**SDR), 2, style_paths=styles)


def test_get_hdr_dataset_batches_equal_jax(fake_corpus, tmp_path):
    from realtime_style_transfer_torch.data.exr import write_gbuffer_fixture

    cfg = TConfig(**HDR)
    content = tmp_path / "hdr_content"
    for sub in ("training", "validation"):
        for i in range(2):
            write_gbuffer_fixture(content / sub, f"shot{i}", cfg.channels, 24, 48, seed=i)
    styles = twiki.style_filepaths(seed=3)
    got = twiki.get_hdr_dataset(cfg, 2, content_dir=content, style_paths=styles,
                                cache_dir=tmp_path / "cache")
    want = jwiki.get_hdr_dataset(JConfig(**HDR), 2, content_dir=content, style_paths=styles)
    _assert_datasets_equal(got, want)
    inputs, gt = next(iter(got[0]()))
    assert inputs["content"].shape == (2,) + cfg.content_shape
    assert gt["content"].shape == (2,) + cfg.output_shape
    assert sorted(p.name for p in (tmp_path / "cache").iterdir()) == [
        "content_training_60_120_6_60_120_3", "content_validation_60_120_6_60_120_3",
        "style_training_60_120_3", "style_validation_60_120_3"]


def test_indexed_dataset_cache_and_skip(tmp_path, caplog):
    calls = []

    def loader(item):
        calls.append(item)
        if item == "bad":
            raise IOError("corrupt")
        if item == "skip":
            raise tpipe.SkipSample("not wanted")
        return {"x": np.full((2, 2), float(len(item)), np.float32), "n": (np.int32(1),)}

    ds = tpipe.IndexedDataset(["aa", "bad", "skip", "cccc"], loader, cache_dir=tmp_path)
    with caplog.at_level(logging.DEBUG):
        out = list(ds)
    assert [float(o["x"][0, 0]) for o in out] == [2.0, 4.0]
    warned = [r for r in caplog.records if r.levelno >= logging.WARNING]
    assert len(warned) == 1 and "bad" in warned[0].getMessage()  # the skip is not warned
    calls.clear()
    again = list(ds)
    assert calls == ["bad", "skip"]  # the good items come from the cache
    _assert_trees_equal(again, out)
    # a corrupt cache file is reloaded
    victim = ds._cache_path("aa")
    victim.write_bytes(b"not an npz")
    calls.clear()
    assert float(list(ds)[0]["x"][0, 0]) == 2.0 and "aa" in calls


def test_sample_files_are_read_by_the_other_package(tmp_path, rng):
    sample = ({"content": rng.random((4, 6, 3), np.float32),
               "style": rng.random((1, 4, 6, 3), np.float32)},
              [np.arange(3), (np.float32(2.5), np.zeros((0,), np.float64))])
    tpipe.save_sample(tmp_path / "port.npz", sample)
    jpipe.save_sample(tmp_path / "jax.npz", sample)
    for path in ("port.npz", "jax.npz"):
        for load in (tpipe.load_sample, jpipe.load_sample):
            restored = load(tmp_path / path)
            assert isinstance(restored, tuple) and isinstance(restored[1], list)
            _assert_trees_equal(restored, jax_like(sample))
    assert (tmp_path / "port.npz").read_bytes()[:2] == b"PK"


def jax_like(sample):
    """``sample`` as ``load_sample`` gives it back: every leaf an array."""
    return tpipe._tree_map(np.asarray, sample)


def test_pair_batch_and_single_sample_match_jax(rng):
    content = [(rng.random((4, 6, 3), np.float32), rng.random((4, 6, 3), np.float32))
               for _ in range(5)]
    style = [rng.random((4, 6, 3), np.float32) for _ in range(5)]
    got = list(tpipe.batched(tpipe.pair_content_and_style(content, style, (4, 6, 1)), 2))
    want = list(jpipe.batched(jpipe.pair_content_and_style(content, style, (4, 6, 1)), 2))
    _assert_trees_equal(got, want)
    _assert_trees_equal(tpipe.get_single_sample(iter(content)),
                        jpipe.get_single_sample(iter(content)))
    assert tpipe.get_single_sample(iter(())) is None and tpipe.get_single_sample(None) is None


def _batches(n):
    rng = np.random.default_rng(3)
    return [({"content": rng.random((2, 4, 6, 3), np.float32),
              "style": rng.random((2, 1, 4, 6, 3), np.float32)},
             {"content": np.full((2, 4, 6, 3), i, np.float32),
              "style": torch.full((2, 1, 4, 6, 3), float(i))}) for i in range(n)]


def test_device_prefetcher_moves_dict_batches_in_order():
    batches = _batches(5)
    got = list(tpipe.DevicePrefetcher(iter(batches), depth=2, device="cpu"))
    assert len(got) == 5
    for (inputs, gt), (want_in, want_gt) in zip(got, batches):
        assert isinstance(inputs, dict) and isinstance(gt, dict)
        for k in want_in:
            assert isinstance(inputs[k], torch.Tensor)
            assert np.array_equal(inputs[k].numpy(), want_in[k])
        assert np.array_equal(gt["content"].numpy(), want_gt["content"])
        assert torch.equal(gt["style"], want_gt["style"])


def test_device_prefetcher_reraises_in_order_and_stays_ended():
    def broken():
        yield from _batches(2)
        raise KeyError("source failed")

    pf = tpipe.DevicePrefetcher(broken(), depth=1, device="cpu")
    assert float(next(pf)[1]["content"][0, 0, 0, 0]) == 0.0
    assert float(next(pf)[1]["content"][0, 0, 0, 0]) == 1.0
    with pytest.raises(KeyError, match="source failed"):
        next(pf)
    for _ in range(3):
        with pytest.raises(StopIteration):
            next(pf)
    done = tpipe.DevicePrefetcher(iter(_batches(1)), device="cpu")
    assert len(list(done)) == 1
    for _ in range(3):
        with pytest.raises(StopIteration):
            next(done)
