"""Self-supervised MidasLite pretraining on the dataset's own SceneDepth EXRs.

Port of ``realtime_style_transfer_tpu/depth_pretrain.py``: the depth net
trains on FinalImage RGB -> normalized inverse SceneDepth, from on-disk
screenshot pairs or from procedural scenes with analytic depth, and its
``.npz`` checkpoint feeds the depth loss through ``--depth_checkpoint``
(``train_network``).  The data plane (targets, scenes, metrics) is the JAX
package's numpy code; the net is the port's :class:`.models.depth.MidasLite`
and the optimizer :class:`.optim.Adam` (``optax.adam``'s arithmetic).  Entry
points run on CUDA unless ``device="cpu"``.

``python -m realtime_style_transfer_torch.depth_pretrain`` is the twin of
``tools/pretrain_depth.py``::

    python -m realtime_style_transfer_torch.depth_pretrain --synthetic 240 \
        --resolution 192 --base_filters 16 --epochs 12 --batch_size 8 \
        --output out/midas_lite.npz
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import resolve_device
from .models.depth import (BUNDLED_DEPTH_CHECKPOINT, MidasLite,  # noqa: F401
                           depth_base_filters, make_midas)

log = logging.getLogger(__name__)


def depth_to_target(scene_depth: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    """Linear SceneDepth -> per-image normalized inverse depth in [0, 1].

    MiDaS-style nets predict *relative inverse* depth; normalizing per image
    makes the target scale-free (the loss term compares depth *differences*,
    ``styleLoss.py:277-285``, so absolute scale is irrelevant).
    """
    inv = 1.0 / (1.0 + np.maximum(scene_depth, 0.0))
    lo, hi = float(inv.min()), float(inv.max())
    return ((inv - lo) / max(hi - lo, eps)).astype(np.float32)


def load_depth_pairs(
    screenshot_paths: Sequence[Path], resolution: int
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (rgb [res,res,3] in [0,1], target [res,res]) per screenshot.

    Each ``X.png`` must have a sibling ``X_SceneDepth.exr`` (the Unreal dump
    convention, reference ``hdrScreenshots.py:14-29``).  Unreadable samples are
    log-and-skipped (reference fault-tolerance convention, ``common.py:117-118``).
    """
    from .data.imaging import load_image, resize_bilinear
    from .data.native import read_exr

    for path in screenshot_paths:
        path = Path(path)
        depth_path = path.parent / f"{path.stem}_SceneDepth.exr"
        try:
            rgb = load_image(path, (resolution, resolution, 3))
            depth = read_exr(depth_path)["R"]
        except Exception as e:  # noqa: BLE001 — log-and-skip parity
            log.warning("skipping %s: %s", path, e)
            continue
        depth = resize_bilinear(depth[..., None], (resolution, resolution))[..., 0]
        yield rgb.astype(np.float32), depth_to_target(depth)


def generate_procedural_scene(
    seed: int, resolution: int = 384, num_objects: int = 12
) -> Tuple[np.ndarray, np.ndarray]:
    """CPU-rasterized random scene with ANALYTIC ground-truth depth.

    Zero-egress substitute for real (FinalImage, SceneDepth) screenshot
    pairs: random spheres and boxes over a receding ground plane, rasterized
    with a z-buffer, lambertian-ish shading and distance fog.  The fog and
    shading make depth *monocularly inferable from the RGB* — the cue a
    MiDaS-style net (reference ``styleLoss.py:250-255``) actually learns —
    while the returned depth is exact geometry, not a heuristic.

    Returns ``(rgb [res, res, 3] float32 in [0,1], depth [res, res] float32
    linear depth)`` — the same contract as a screenshot + SceneDepth pair.
    """
    rng = np.random.default_rng(seed)
    res = resolution
    yy, xx = np.mgrid[0:res, 0:res].astype(np.float32) / res  # [0,1)^2

    # Ground plane: depth grows toward the horizon (top of frame), like a
    # camera pitched down over terrain.
    horizon = 0.25 + 0.2 * rng.random()
    depth = (2.0 + 58.0 * np.clip(
        1.0 - (yy - horizon) / max(1.0 - horizon, 1e-3), 0.0, 1.0)
    ).astype(np.float32)
    albedo = np.empty((res, res, 3), np.float32)
    albedo[:] = rng.random(3) * 0.5 + 0.3
    # checker variation so the plane has texture
    checker = (np.floor(xx * 8) + np.floor((yy - horizon) * 8)) % 2
    albedo *= (0.75 + 0.25 * checker)[..., None]
    shade = np.full((res, res), 1.0, np.float32)

    light = rng.normal(size=3)
    light /= np.linalg.norm(light)
    light[2] = abs(light[2]) + 0.5  # toward the camera

    for _ in range(num_objects):
        kind = rng.choice(("sphere", "box"))
        cx, cy = rng.random(2)
        z = 2.0 + 50.0 * rng.random() ** 1.5          # object distance
        r = (0.03 + 0.15 * rng.random()) * 12.0 / (z + 6.0)  # size by depth
        color = rng.random(3) * 0.8 + 0.2
        if kind == "sphere":
            d2 = ((xx - cx) ** 2 + (yy - cy) ** 2) / max(r * r, 1e-8)
            inside = d2 < 1.0
            # sphere surface: closer at center, analytic normal shading
            h = np.sqrt(np.clip(1.0 - d2, 0.0, 1.0))
            obj_depth = z - r * 8.0 * h
            nx = (xx - cx) / max(r, 1e-8)
            ny = (yy - cy) / max(r, 1e-8)
            s = np.clip(nx * light[0] + ny * light[1] + h * light[2], 0.1, 1.0)
        else:
            w, hgt = r, r * (0.5 + rng.random())
            inside = (np.abs(xx - cx) < w) & (np.abs(yy - cy) < hgt)
            obj_depth = np.full_like(xx, z)
            s = np.full_like(xx, float(np.clip(light[2], 0.2, 1.0)))
        win = inside & (obj_depth < depth)
        depth[win] = obj_depth[win].astype(np.float32)
        albedo[win] = color
        shade[win] = s[win]

    rgb = albedo * shade[..., None]
    # distance fog: the dominant monocular depth cue (and physically what a
    # deferred renderer's aerial perspective does)
    fog = np.exp(-depth / 25.0)[..., None]
    sky = np.array([0.65, 0.72, 0.85], np.float32) * (0.8 + 0.2 * rng.random())
    rgb = rgb * fog + sky * (1.0 - fog)
    rgb += rng.normal(0, 0.005, rgb.shape)
    return (np.clip(rgb, 0.0, 1.0).astype(np.float32),
            depth.astype(np.float32))


def synthetic_depth_pairs(
    num_scenes: int, resolution: int, *, seed: int = 0
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``num_scenes`` procedural (rgb, normalized-inverse-depth) pairs."""
    pairs = []
    for i in range(num_scenes):
        rgb, depth = generate_procedural_scene(seed * 100003 + i, resolution)
        pairs.append((rgb, depth_to_target(depth)))
    return pairs


def correlation(a: np.ndarray, b: np.ndarray) -> float:
    """Pearson correlation between two arrays (the acceptance metric)."""
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    a -= a.mean()
    b -= b.mean()
    denom = np.sqrt((a * a).sum() * (b * b).sum())
    return float((a * b).sum() / denom) if denom > 0 else 0.0


def spearman_correlation(a: np.ndarray, b: np.ndarray) -> float:
    """Spearman rank correlation — the depth ORDERING metric (invariant to
    any monotone calibration of either map).

    A (near-)constant input scores 0: stable argsort of a flat array yields
    raster-order ranks, which would otherwise correlate spuriously with any
    smooth depth gradient (a constant predictor must not pass the gate).
    """
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.std() < 1e-12 * (1.0 + np.abs(a.mean())):
        return 0.0
    if b.std() < 1e-12 * (1.0 + np.abs(b.mean())):
        return 0.0

    def ranks(x: np.ndarray) -> np.ndarray:
        order = np.argsort(x.ravel(), kind="stable")
        r = np.empty(order.size, np.float64)
        r[order] = np.arange(order.size, dtype=np.float64)
        return r

    return correlation(ranks(a), ranks(b))


def aligned_rmse(pred: np.ndarray, target: np.ndarray) -> float:
    """RMSE after least-squares scale/shift alignment of pred to target —
    the MiDaS evaluation protocol (affine-invariant disparity error; Ranftl
    et al. 2020 §4) applied to the normalized inverse-depth maps this stack
    trains on.  0 = perfect up to an affine map; 1-ish = uninformative."""
    p = np.asarray(pred, np.float64).ravel()
    t = np.asarray(target, np.float64).ravel()
    var = p.var()
    if var <= 0:
        return float(np.sqrt(np.mean((t - t.mean()) ** 2)))
    s = ((p - p.mean()) * (t - t.mean())).mean() / var
    b = t.mean() - s * p.mean()
    return float(np.sqrt(np.mean((s * p + b - t) ** 2)))


def _predict(model: MidasLite, rgb: np.ndarray, device: torch.device) -> np.ndarray:
    with torch.no_grad():
        return model(torch.from_numpy(rgb[None]).to(device))[0].cpu().numpy()


def evaluate_depth_checkpoint(variables, pairs, *, device=None) -> dict:
    """Score MidasLite ``variables`` against (rgb, target) pairs: the means
    over the pairs of ``spearman`` (rank agreement with the SceneDepth
    target), ``pearson`` and ``aligned_rmse`` (the MiDaS protocol's
    affine-aligned error), and ``n``."""
    device = resolve_device(device)
    model = make_midas(variables).to(device).eval()
    sp, pe, rm = [], [], []
    for rgb, target in pairs:
        pred = _predict(model, rgb, device)
        sp.append(spearman_correlation(pred, target))
        pe.append(correlation(pred, target))
        rm.append(aligned_rmse(pred, target))
    return {
        "spearman": float(np.mean(sp)),
        "pearson": float(np.mean(pe)),
        "aligned_rmse": float(np.mean(rm)),
        "n": len(sp),
    }


def pretrain(
    training_paths: Sequence[Path],
    validation_paths: Sequence[Path],
    *,
    resolution: int = 384,
    **kwargs,
):
    """Train MidasLite on on-disk (FinalImage, SceneDepth) screenshot pairs.

    Returns ``(variables, history)``; see :func:`pretrain_on_pairs`.
    """
    train_pairs = list(load_depth_pairs(training_paths, resolution))
    val_pairs = list(load_depth_pairs(validation_paths, resolution))
    return pretrain_on_pairs(train_pairs, val_pairs, resolution=resolution,
                             **kwargs)


def pretrain_on_pairs(
    train_pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    val_pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    *,
    resolution: int = 384,
    base_filters: int = 32,
    epochs: int = 10,
    batch_size: int = 4,
    learning_rate: float = 1e-3,
    seed: int = 0,
    log_every: int = 10,
    variables=None,
    device=None,
):
    """Train MidasLite on in-memory (rgb, target) pairs, from flax
    ``variables`` when given (else weights drawn from ``seed``).

    Returns ``(variables, history)``: ``{"params": ...}`` as a flax tree of
    numpy arrays, and the per-epoch train loss and validation correlation.
    The epochs' orders come from ``np.random.default_rng(seed)``, as in the
    JAX package.
    """
    from torch.func import functional_call

    from .optim import Adam, apply_updates
    from .weights import to_flax

    del resolution  # the pairs carry it
    device = resolve_device(device)
    if variables is None:
        model = MidasLite(base_filters=base_filters,
                          generator=torch.Generator().manual_seed(seed))
    else:
        model = make_midas(variables)
    model = model.to(device)
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    model.requires_grad_(False)
    tx = Adam(learning_rate)
    opt_state = tx.init(params)

    def forward(params, rgb):
        return functional_call(model, params, (rgb,))

    train_pairs = list(train_pairs)
    val_pairs = list(val_pairs)
    if not train_pairs:
        raise ValueError("no readable (png, SceneDepth.exr) training pairs")

    def evaluate(params) -> float:
        if not val_pairs:
            return float("nan")
        cors = []
        with torch.no_grad():
            for rgb, target in val_pairs:
                pred = forward(params, torch.from_numpy(rgb[None]).to(device))[0]
                cors.append(correlation(pred.cpu().numpy(), target))
        return float(np.mean(cors))

    history = {"train_loss": [], "val_correlation": [],
               "initial_val_correlation": evaluate(params)}
    shuffler = np.random.default_rng(seed)
    step = 0
    for epoch in range(epochs):
        order = shuffler.permutation(len(train_pairs))
        losses = []
        for start in range(0, len(order) - batch_size + 1, batch_size):
            idx = order[start:start + batch_size]
            rgb = torch.from_numpy(np.stack([train_pairs[i][0] for i in idx])).to(device)
            target = torch.from_numpy(np.stack([train_pairs[i][1] for i in idx])).to(device)
            leaves = {k: v.requires_grad_(True) for k, v in params.items()}
            loss = torch.mean(torch.square(forward(leaves, rgb) - target))
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            updates, opt_state = tx.update(grads, opt_state)
            params = apply_updates({k: v.detach() for k, v in params.items()}, updates)
            losses.append(loss.item())
            step += 1
            if log_every and step % log_every == 0:
                log.info("step %d: loss %.5f", step, losses[-1])
        val_cor = evaluate(params)
        history["train_loss"].append(float(np.mean(losses)) if losses else np.nan)
        history["val_correlation"].append(val_cor)
        log.info("epoch %d: train loss %.5f, val correlation %.4f",
                 epoch, history["train_loss"][-1], val_cor)

    return {"params": to_flax(params)["params"]}, history


def save_depth_checkpoint(variables, output: Path) -> None:
    """Save MidasLite variables as one ``.npz`` of ``/``-joined flax paths,
    the form ``load_depth_checkpoint`` and the JAX package read."""
    from .tracing.checkpoint import write_tree

    output = Path(output)
    if output.suffix != ".npz":
        raise ValueError(f"{output}: the port saves a depth checkpoint as one .npz file "
                         "(an Orbax directory is the JAX package's form)")
    write_tree(output, variables)


def load_depth_checkpoint(path: Path):
    """MidasLite variables saved by :func:`save_depth_checkpoint` (or the
    JAX package's ``.npz``); an Orbax directory is refused."""
    from .models.depth import load_depth_checkpoint as load
    from .tracing.checkpoint import orbax_refusal

    if Path(path).is_dir():
        raise orbax_refusal(path)
    return load(path)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Pretrain, score against the validation pairs, save; returns the scores."""
    from .data.imaging import list_image_paths
    from .tracing import logsetup

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--content_dir", type=Path, default=None,
                   help="dir with training/ and validation/ screenshot subdirs "
                        "(X.png + X_SceneDepth.exr siblings)")
    p.add_argument("--synthetic", type=int, default=None, metavar="N",
                   help="pretrain on N procedural scenes with analytic depth "
                        "instead of --content_dir (90/10 train/val split)")
    p.add_argument("--output", type=Path, required=True,
                   help=".npz file for the trained MidasLite")
    p.add_argument("--resolution", type=int, default=384)
    p.add_argument("--base_filters", type=int, default=32)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--min_spearman", type=float, default=None,
                   help="quality gate: refuse to save unless the trained net's mean "
                        "Spearman rank correlation against the validation SceneDepth "
                        "targets clears this bar")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: CUDA, and an error without it)")
    args = p.parse_args(argv)
    logsetup.setup()

    common = dict(
        resolution=args.resolution, base_filters=args.base_filters,
        epochs=args.epochs, batch_size=args.batch_size,
        learning_rate=args.learning_rate, seed=args.seed, device=args.device,
    )
    if (args.synthetic is None) == (args.content_dir is None):
        raise SystemExit("pass exactly one of --content_dir / --synthetic")
    if args.synthetic is not None:
        pairs = synthetic_depth_pairs(args.synthetic, args.resolution, seed=args.seed)
        n_val = max(1, len(pairs) // 10)
        val_pairs = pairs[:n_val]
        variables, history = pretrain_on_pairs(pairs[n_val:], val_pairs, **common)
    else:
        train_paths = list_image_paths(args.content_dir / "training")
        val_paths = list_image_paths(args.content_dir / "validation")
        variables, history = pretrain(train_paths, val_paths, **common)
        val_pairs = list(load_depth_pairs(val_paths, args.resolution))

    scores = evaluate_depth_checkpoint(variables, val_pairs, device=args.device)
    print(
        f"quality vs validation SceneDepth: spearman {scores['spearman']:.4f}"
        f", pearson {scores['pearson']:.4f}, aligned_rmse "
        f"{scores['aligned_rmse']:.4f} over {scores['n']} scenes"
    )
    if args.min_spearman is not None and scores["spearman"] < args.min_spearman:
        raise SystemExit(
            f"quality gate failed: spearman {scores['spearman']:.4f} < "
            f"--min_spearman {args.min_spearman}; not saving {args.output}")
    save_depth_checkpoint(variables, args.output)
    print(
        f"saved {args.output}; val correlation "
        f"{history['initial_val_correlation']:.4f} -> "
        f"{history['val_correlation'][-1]:.4f}"
    )
    return scores


if __name__ == "__main__":
    main()
