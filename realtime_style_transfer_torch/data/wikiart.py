"""WikiArt style corpus: manifest, scraper, naming, blacklist, datasets.

Port of ``realtime_style_transfer_tpu/data/wikiart.py``: the same Kaggle
manifest (``antoinegruson/-wikiart-all-images-120k-link``), sha1-of-manifest-
row image naming, corrupted-image blacklist, 80/20 seeded split and
shape-keyed cache subdirectories, so both packages see the same corpus in the
same order.  The dataset factories return zero-argument iterator factories
over numpy batches, which the trainer's ``DevicePrefetcher`` moves to the
card.  ``download_manifest`` and ``download_images`` need the network;
``style_paths`` (the training CLI's ``--style_dir``) bypasses them.
"""

from __future__ import annotations

import csv
import hashlib
import logging
import shutil
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from . import pipeline
from .imaging import list_image_paths, load_image

log = logging.getLogger(__name__)

# Corpus layout (reference ``common.py:13-20``); monkeypatchable for tests.
DATA_ROOT = Path(__file__).resolve().parents[2] / "data"
STYLE_TARGET_DIR = DATA_ROOT / "wikiart"
STYLE_IMAGE_DIR = STYLE_TARGET_DIR / "images"
STYLE_DEBUG_IMAGE_DIR = STYLE_TARGET_DIR / "debug_images"
CONTENT_TARGET_DIR = DATA_ROOT / "screenshots"
CONTENT_IMAGE_DIR = CONTENT_TARGET_DIR / "images"
CONTENT_HDR_IMAGE_DIR = CONTENT_TARGET_DIR / "hdr_images"
CONTENT_DEBUG_IMAGE_DIR = CONTENT_TARGET_DIR / "debug_images"
CONTENT_HDR_DEBUG_IMAGE_DIR = CONTENT_TARGET_DIR / "debug_hdr_images"
MANIFEST_FILEPATH = STYLE_TARGET_DIR / "wikiart_scraped.csv"

KAGGLE_DATASET = "antoinegruson/-wikiart-all-images-120k-link"
NUM_WIKIART_IMAGES = 124170

# Images whose downloads are corrupted (reference ``wikiart.py:21-26``).
BLACKLISTED_IMAGE_HASHES = frozenset(
    {"a85d4a1f4cc89ff410a98160000a64749b0920ee"}
)


# ---------------------------------------------------------------------------
# Manifest + naming
# ---------------------------------------------------------------------------


def read_manifest() -> List[Dict[str, str]]:
    """All manifest rows as dicts (columns: Style, Artwork, Artist, Date, Link)."""
    with open(MANIFEST_FILEPATH, "r", encoding="utf-8") as f:
        return list(csv.DictReader(f))


def image_manifest_to_filepath(image_manifest: Dict[str, str]) -> Path:
    """Corpus file name: sha1 of the manifest row's str() (``wikiart.py:314-317``).

    This hash IS the cross-tool image identity (blacklist entries,
    ``style_hash_lookup``), so it must match the reference bit-for-bit.
    """
    digest = hashlib.sha1(
        str(image_manifest).encode("utf-8"), usedforsecurity=False
    ).hexdigest()
    return (STYLE_IMAGE_DIR / digest).with_suffix(".jpg")


def lookup_manifest_by_hash(image_hash: str) -> Optional[Dict[str, str]]:
    """Reverse lookup: file stem -> manifest row (``style_hash_lookup.py`` role)."""
    for row in read_manifest():
        if image_manifest_to_filepath(row).stem == image_hash:
            return row
    return None


def style_filepaths(seed: Optional[int] = None) -> List[Path]:
    """Usable corpus image paths: manifest order, blacklist- and existence-
    filtered, sorted; optionally shuffled by a seeded RNG
    (``wikiart.py:159-165``)."""
    if MANIFEST_FILEPATH.exists():
        paths = [image_manifest_to_filepath(row) for row in read_manifest()]
    else:
        paths = list(STYLE_IMAGE_DIR.glob("*.jpg"))
    paths = sorted(
        p for p in paths
        if p.stem not in BLACKLISTED_IMAGE_HASHES and p.exists()
    )
    if seed is not None:
        import random

        random.Random(seed).shuffle(paths)
    return paths


# ---------------------------------------------------------------------------
# Acquisition (network-gated; no-ops in a zero-egress environment)
# ---------------------------------------------------------------------------


def download_manifest(force: bool = False) -> None:
    """Fetch the Kaggle manifest CSV (``wikiart.py:49-70``). Needs kaggle creds."""
    if MANIFEST_FILEPATH.exists() and not force:
        return
    import zipfile

    import kaggle  # type: ignore[import-not-found]

    STYLE_TARGET_DIR.mkdir(parents=True, exist_ok=True)
    kaggle.api.dataset_download_file(
        dataset=KAGGLE_DATASET,
        file_name=MANIFEST_FILEPATH.name,
        path=STYLE_TARGET_DIR,
    )
    archive_path = Path(str(MANIFEST_FILEPATH) + ".zip")
    with zipfile.ZipFile(archive_path) as archive:
        archive.extractall(path=STYLE_TARGET_DIR)
    archive_path.unlink()
    if not MANIFEST_FILEPATH.exists():
        raise FileNotFoundError(
            f"{MANIFEST_FILEPATH} missing after manifest download"
        )


def download_images(
    num_threads: int = 20,
    progress_hook: Optional[Callable[[str, Path, int, int], None]] = None,
) -> None:
    """Scrape the corpus images (``wikiart.py:73-151``) with a thread pool.

    Skips files that already exist, so interrupted scrapes resume.
    """
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    STYLE_IMAGE_DIR.mkdir(parents=True, exist_ok=True)
    rows = read_manifest()
    total = len(rows)

    def fetch(indexed_row: Tuple[int, Dict[str, str]]) -> None:
        index, row = indexed_row
        target = image_manifest_to_filepath(row)
        url = row["Link"]
        if progress_hook is not None:
            progress_hook(url, target, index, total)
        if target.exists():
            return
        try:
            with urllib.request.urlopen(url, timeout=60) as response:
                data = response.read()
            target.write_bytes(data)
        except Exception as e:  # noqa: BLE001 — scrape must keep going
            log.warning("could not download %s: %s", url, e)

    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        list(pool.map(fetch, enumerate(rows)))


def init_dataset() -> None:
    """Ensure manifest + images exist (``wikiart.py:237-243``)."""
    if not MANIFEST_FILEPATH.exists():
        download_manifest()
    if not STYLE_IMAGE_DIR.exists() or not any(STYLE_IMAGE_DIR.iterdir()):
        download_images()


# ---------------------------------------------------------------------------
# Dataset factories
# ---------------------------------------------------------------------------


def _content_dataset(
    subset_dir: Path,
    config,
    channels,
    cache_dir: Optional[Path],
    tag: str,
):
    """IndexedDataset of (content, ground_truth) pairs for one subset dir."""
    content_shape = config.content_shape
    output_shape = config.output_shape
    if channels is not None:
        from .hdr_screenshots import load_preprocessed_gbuffer

        items = [str(p) for p in sorted(Path(subset_dir).glob("*.png"))]

        def loader(png_path: str):
            content = load_preprocessed_gbuffer(
                Path(png_path), channels, content_shape
            )
            return content, load_image(png_path, output_shape)

    else:
        items = [str(p) for p in list_image_paths(subset_dir)]

        def loader(path: str):
            content = load_image(path, content_shape)
            if tuple(output_shape) == tuple(content_shape):
                return content, content
            return content, load_image(path, output_shape)

    # Shape-keyed cache subdir (reference ``wikiart.py:190-193``'s
    # name_suffix): a shared --cache_dir across network specs must never
    # serve tensors decoded for a different shape.
    suffix = "_".join(map(str, (*content_shape, *output_shape)))
    cache = Path(cache_dir) / f"{tag}_{suffix}" if cache_dir is not None \
        else None
    return pipeline.IndexedDataset(items, loader, cache_dir=cache)


def _style_dataset(
    style_paths: Sequence[Path],
    config,
    cache_dir: Optional[Path],
    tag: str,
):
    output_shape = config.output_shape

    def loader(path: str):
        return load_image(path, output_shape)

    suffix = "_".join(map(str, output_shape))
    cache = Path(cache_dir) / f"{tag}_{suffix}" if cache_dir is not None \
        else None
    return pipeline.IndexedDataset(
        [str(p) for p in style_paths], loader, cache_dir=cache
    )


def _make_factories(
    config,
    batch_size: Optional[int],
    content_by_subset: Dict[str, "pipeline.IndexedDataset"],
    styles_by_subset: Dict[str, "pipeline.IndexedDataset"],
):
    weights_shape = config.style_weights_shape

    def factory(subset: str) -> Callable[[], Iterable]:
        content_ds = content_by_subset[subset]
        style_ds = styles_by_subset[subset]

        def make_iter():
            paired = pipeline.pair_content_and_style(
                iter(content_ds), iter(style_ds),
                style_weights_shape=weights_shape,
            )
            if batch_size is None:
                return paired
            return pipeline.batched(paired, batch_size)

        return make_iter

    n_train = min(
        len(content_by_subset["training"]), len(styles_by_subset["training"])
    )
    n_val = min(
        len(content_by_subset["validation"]),
        len(styles_by_subset["validation"]),
    )
    return factory("training"), factory("validation"), n_train, n_val


def get_dataset(
    config,
    batch_size: Optional[int],
    *,
    seed: Optional[int] = None,
    cache_dir: Optional[Path] = None,
    channels: Optional[Sequence[Tuple[str, int]]] = None,
    content_dir: Optional[Path] = None,
    style_paths: Optional[Sequence[Path]] = None,
) -> Tuple[Callable[[], Iterable], Callable[[], Iterable], int, int]:
    """The full-corpus dataset pair (``wikiart.py:156-215``).

    Content comes from ``<content_dir>/{training,validation}`` (plain images,
    or Unreal G-buffer sets when ``channels`` is given); styles are the
    corpus paths (or ``style_paths``), 80/20 split with the reference's
    seeded-shuffle semantics.  Returns
    ``(make_train_iter, make_val_iter, n_train, n_val)`` where the counts are
    the min-zip pairing bound of each subset.
    """
    if content_dir is None:
        content_dir = (
            CONTENT_HDR_IMAGE_DIR if config.hdr else CONTENT_IMAGE_DIR
        )
    content_dir = Path(content_dir)
    if style_paths is None:
        init_dataset()
        # un-shuffled here: split_train_validation applies the reference's
        # SINGLE seeded shuffle (sorted -> one Random(seed).shuffle -> cut,
        # ``wikiart.py:161-167``); shuffling twice with the same seed would
        # produce a different split than the reference for the same corpus.
        style_paths = style_filepaths()
    train_styles, val_styles = pipeline.split_train_validation(
        list(style_paths), seed=seed
    )

    content_by_subset = {
        subset: _content_dataset(
            content_dir / subset, config, channels, cache_dir,
            f"content_{subset}",
        )
        for subset in ("training", "validation")
    }
    styles_by_subset = {
        "training": _style_dataset(
            train_styles, config, cache_dir, "style_training"
        ),
        "validation": _style_dataset(
            val_styles, config, cache_dir, "style_validation"
        ),
    }
    return _make_factories(
        config, batch_size, content_by_subset, styles_by_subset
    )


def get_hdr_dataset(
    config,
    batch_size: Optional[int],
    **kwargs,
) -> Tuple[Callable[[], Iterable], Callable[[], Iterable], int, int]:
    """HDR convenience wrapper (``wikiart.py:220-235``): G-buffer content.

    Injects the config's channel list and the HDR content directory unless
    overridden (the reference's default 21-channel list is the ``channels``
    property of an ``num_channels>=18`` config).
    """
    kwargs.setdefault("channels", list(config.channels))
    kwargs.setdefault("content_dir", CONTENT_HDR_IMAGE_DIR)
    return get_dataset(config, batch_size, **kwargs)


def get_hdr_dataset_debug(
    config,
    batch_size: Optional[int] = 1,
    **kwargs,
) -> Tuple[Callable[[], Iterable], Callable[[], Iterable], int, int]:
    """HDR debug wrapper (``wikiart.py:303-304``)."""
    kwargs.setdefault("channels", list(config.channels))
    return get_dataset_debug(config, batch_size, hdr=True, **kwargs)


def get_dataset_debug(
    config,
    batch_size: Optional[int] = 1,
    *,
    hdr: bool = False,
    seed: Optional[int] = None,
    cache_dir: Optional[Path] = None,
    channels: Optional[Sequence[Tuple[str, int]]] = None,
    style_paths: Optional[Sequence[Path]] = None,
) -> Tuple[Callable[[], Iterable], Callable[[], Iterable], int, int]:
    """The 100-image debug subset (``wikiart.py:246-300``).

    Copies up to 100 corpus images into ``STYLE_DEBUG_IMAGE_DIR`` with an
    80/20 training/validation layout (idempotent), and pairs them with the
    debug content directories.
    """
    training_dir = STYLE_DEBUG_IMAGE_DIR / "training"
    validation_dir = STYLE_DEBUG_IMAGE_DIR / "validation"
    for needed in (STYLE_DEBUG_IMAGE_DIR, training_dir, validation_dir):
        needed.mkdir(parents=True, exist_ok=True)

    existing = len(list_image_paths(STYLE_DEBUG_IMAGE_DIR))
    if style_paths is not None and existing > 0:
        raise ValueError(
            "style_paths given but the debug subset is already materialized "
            f"at {STYLE_DEBUG_IMAGE_DIR}; delete it to re-seed from "
            "style_paths (debug mode always serves the materialized layout)"
        )
    if existing == 0:
        source_images = (
            sorted(Path(p) for p in style_paths)[:100]
            if style_paths is not None
            else sorted(STYLE_IMAGE_DIR.iterdir())[:100]
        )
        cut = int(len(source_images) * 0.8)
        log.info(
            "copying %d debug images to %s",
            len(source_images), STYLE_DEBUG_IMAGE_DIR,
        )
        for i, image in enumerate(source_images):
            subset = "training" if i < cut else "validation"
            shutil.copyfile(image, STYLE_DEBUG_IMAGE_DIR / subset / image.name)

    content_dir = CONTENT_HDR_DEBUG_IMAGE_DIR if hdr else CONTENT_DEBUG_IMAGE_DIR
    if hdr and channels is None:
        channels = list(config.channels)

    content_by_subset = {
        subset: _content_dataset(
            Path(content_dir) / subset, config, channels, cache_dir,
            f"debug_content_{subset}",
        )
        for subset in ("training", "validation")
    }
    styles_by_subset = {
        subset: _style_dataset(
            list_image_paths(STYLE_DEBUG_IMAGE_DIR / subset), config,
            cache_dir, f"debug_style_{subset}",
        )
        for subset in ("training", "validation")
    }
    return _make_factories(
        config, batch_size, content_by_subset, styles_by_subset
    )
