"""Convert pretrained Keras weights into flax variable trees, saved as ``.npz``.

Twin of the repository's ``tools/convert_keras_weights.py``: the same
converters, flags, refusals and layout math, but the output is an ``.npz`` of
``/``-joined flax paths (``tracing.checkpoint.write_tree``), which
``tracing.checkpoint.load_weights``, ``weights.from_flax`` and
``cli.load_variables`` read; it writes no Orbax directory.

Step 1 (a machine with tensorflow) dumps a backbone's weights to an ``.npz``
keyed by their Keras names::

    import numpy as np, tensorflow as tf
    m = tf.keras.applications.VGG16(include_top=False, weights="imagenet")
    np.savez("vgg16_imagenet.npz",
             **{w.name: w.numpy() for layer in m.layers for w in layer.weights})

or a trained reference transfer net in the key grammar ``convert_transfer``
reads (``contract_{i}_conv/kernel``, ``contract_{i}_bn/gamma``,
``residual_{i}_conv{j}/kernel``, ``expand_{i}_conv/kernel``, ...).

Step 2 (here)::

    python -m realtime_style_transfer_torch.convert_keras_weights vgg16 \\
        vgg16_imagenet.npz out/vgg16_params.npz
    python -m realtime_style_transfer_torch.convert_keras_weights transfer \\
        transfer_keras.npz out/transfer.npz

The layout math: Conv2D kernels are HWIO on both sides (identity); a Keras
depthwise kernel ``(H, W, C, 1)`` becomes the grouped conv's ``(H, W, 1,
C)``; a Keras ``Conv2DTranspose`` kernel ``(kh, kw, out, in)`` is flipped
180 degrees in space and its I/O swapped; a Keras batch norm's
``gamma``/``beta``/``moving_mean``/``moving_variance`` become flax's
``scale``/``bias`` and ``batch_stats`` ``mean``/``var``; EfficientNet B3's
ImageNet rescale constant folds into its normalization variance.  The block
tables come from the port's own ``models/backbones``.
"""

from __future__ import annotations

import argparse
import re
from pathlib import Path
from typing import Optional, Sequence

import numpy as np


def convert_vgg16(npz) -> dict:
    """Keras VGG16 names (block{i}_conv{j}/kernel:0) -> VGG16Features params."""
    params = {}
    for key in npz.files:
        m = re.match(r".*?(block\d_conv\d)/(kernel|bias)", key)
        if not m:
            continue
        layer, kind = m.groups()
        entry = params.setdefault(layer, {})
        entry["kernel" if kind == "kernel" else "bias"] = np.asarray(npz[key])
    missing = {f"block{b}_conv{c}" for b, n in enumerate((2, 2, 3, 3, 3), 1)
               for c in range(1, n + 1)} - set(params)
    if missing:
        raise SystemExit(f"npz is missing layers: {sorted(missing)}")
    return {"params": params}


def _tree_put(tree, path, value):
    node = tree
    for part in path[:-1]:
        node = node.setdefault(part, {})
    node[path[-1]] = np.asarray(value)


def _keras_bn(npz, params, batch_stats, dst_module, dst_name, src_prefix):
    """A Keras BatchNormalization -> flax ``scale``/``bias`` and ``mean``/``var``."""
    _tree_put(params, (*dst_module, dst_name, "scale"), npz[f"{src_prefix}/gamma:0"])
    _tree_put(params, (*dst_module, dst_name, "bias"), npz[f"{src_prefix}/beta:0"])
    _tree_put(batch_stats, (*dst_module, dst_name, "mean"), npz[f"{src_prefix}/moving_mean:0"])
    _tree_put(batch_stats, (*dst_module, dst_name, "var"),
              npz[f"{src_prefix}/moving_variance:0"])


def depthwise_kernel(dw: np.ndarray) -> np.ndarray:
    """Keras depthwise kernel (H, W, C, 1) -> grouped-conv HWIO (H, W, 1, C)."""
    return np.transpose(np.asarray(dw), (0, 1, 3, 2))


def convert_mobilenetv3(npz) -> dict:
    """Keras MobileNetV3Small dump -> MobileNetV3Small module variables.

    Keras layer-name patterns (from tf.keras.applications.MobileNetV3Small):
      Conv/kernel, Conv/BatchNorm/{gamma,beta,moving_mean,moving_variance}
      expanded_conv[_i]/{expand,depthwise,project}/(kernel|depthwise_kernel)
      expanded_conv[_i]/{expand,depthwise,project}/BatchNorm/...
      expanded_conv[_i]/squeeze_excite/Conv[_1]/{kernel,bias}
      Conv_1/kernel + Conv_1/BatchNorm/...
    """
    from .models.backbones.mobilenetv3 import MOBILENETV3_SMALL_BLOCKS

    params: dict = {}
    batch_stats: dict = {}

    def bn(dst_module, dst_name, src_prefix):
        _keras_bn(npz, params, batch_stats, dst_module, dst_name, src_prefix)

    # stem + final conv
    _tree_put(params, ("stem_conv", "kernel"), npz["Conv/kernel:0"])
    bn((), "stem_bn", "Conv/BatchNorm")
    _tree_put(params, ("last_conv", "kernel"), npz["Conv_1/kernel:0"])
    bn((), "last_bn", "Conv_1/BatchNorm")
    for i, (_k, _exp, _out, use_se, _act, _s) in enumerate(MOBILENETV3_SMALL_BLOCKS):
        src = "expanded_conv" if i == 0 else f"expanded_conv_{i}"
        dst = src
        if i > 0:
            _tree_put(params, (dst, "expand", "kernel"), npz[f"{src}/expand/kernel:0"])
            bn((dst,), "expand_bn", f"{src}/expand/BatchNorm")
        _tree_put(params, (dst, "depthwise", "kernel"),
                  depthwise_kernel(npz[f"{src}/depthwise/depthwise_kernel:0"]))
        bn((dst,), "depthwise_bn", f"{src}/depthwise/BatchNorm")
        if use_se:
            for leaf in ("kernel", "bias"):
                _tree_put(params, (dst, "se", "se_reduce", leaf),
                          npz[f"{src}/squeeze_excite/Conv/{leaf}:0"])
                _tree_put(params, (dst, "se", "se_expand", leaf),
                          npz[f"{src}/squeeze_excite/Conv_1/{leaf}:0"])
        _tree_put(params, (dst, "project", "kernel"), npz[f"{src}/project/kernel:0"])
        bn((dst,), "project_bn", f"{src}/project/BatchNorm")
    return {"params": params, "batch_stats": batch_stats}


# Keras efficientnet.py applies an extra x * 1/sqrt(stddev) graph CONSTANT
# (not a weight) after the Normalization layer when built with
# weights="imagenet"; folding stddev into the normalization variance is
# exact: (x-m)/sqrt(v*s) == ((x-m)/sqrt(v)) / sqrt(s).
IMAGENET_STDDEV_RGB = np.array([0.229, 0.224, 0.225], np.float32)


def _effnet_normalization(npz, batch_stats, imagenet_rescale: bool) -> None:
    """v1 Rescaling/Normalization stats (identity on random-init dumps)."""
    mean = var = None
    for key in npz.files:
        if "normalization" not in key:
            continue
        if key.endswith("/mean:0"):
            mean = np.asarray(npz[key])
        elif key.endswith("/variance:0"):
            var = np.asarray(npz[key])
    if mean is None or var is None:  # dump predates the preprocessing layers
        mean, var = np.zeros(3, np.float32), np.ones(3, np.float32)
    if imagenet_rescale:
        var = var * IMAGENET_STDDEV_RGB
    batch_stats["normalization"] = {"mean": mean, "variance": var}


def _mbconv_se(npz, params, name):
    for se in ("se_reduce", "se_expand"):
        _tree_put(params, (name, se, "kernel"), npz[f"{name}_{se}/kernel:0"])
        _tree_put(params, (name, se, "bias"), npz[f"{name}_{se}/bias:0"])


def convert_efficientnet_b3(npz, imagenet_rescale: bool = False) -> dict:
    """Keras ``efficientnet.EfficientNetB3(include_top=False)`` dump ->
    ``models.backbones.efficientnet.EfficientNetB3`` variables.

    Layer-name grammar (tf_keras applications/efficientnet.py ``block()``):
    ``stem_conv, stem_bn, block{s}{u}_{expand_conv,expand_bn,dwconv,bn,
    se_reduce,se_expand,project_conv,project_bn}, top_conv, top_bn`` plus the
    baked-in ``normalization`` layer stats.  Pass ``imagenet_rescale=True``
    when converting a ``weights="imagenet"`` dump (see IMAGENET_STDDEV_RGB).
    """
    from .models.backbones.efficientnet import (B3_DEPTH, B3_WIDTH, EFFICIENTNET_V1_BLOCKS,
                                                round_filters, round_repeats)

    params: dict = {}
    batch_stats: dict = {}
    _effnet_normalization(npz, batch_stats, imagenet_rescale)

    def bn(mod, dst, src):
        _keras_bn(npz, params, batch_stats, mod, dst, src)

    _tree_put(params, ("stem_conv", "kernel"), npz["stem_conv/kernel:0"])
    bn((), "stem_bn", "stem_bn")
    if "top_conv/kernel:0" in npz.files:
        _tree_put(params, ("top_conv", "kernel"), npz["top_conv/kernel:0"])
        bn((), "top_bn", "top_bn")
    else:
        # A loss tower cut at its last tap (block7b_add) has no top_conv/top_bn
        # in its dump; the taps never read them: zeros fill the module tree.
        cin = round_filters(EFFICIENTNET_V1_BLOCKS[-1][4], B3_WIDTH)
        ctop = round_filters(1280, B3_WIDTH)
        _tree_put(params, ("top_conv", "kernel"), np.zeros((1, 1, cin, ctop), np.float32))
        params["top_bn"] = {"scale": np.ones(ctop, np.float32),
                            "bias": np.zeros(ctop, np.float32)}
        batch_stats["top_bn"] = {"mean": np.zeros(ctop, np.float32),
                                 "var": np.ones(ctop, np.float32)}
    for stage, (exp, _k, _s, r, _f) in enumerate(EFFICIENTNET_V1_BLOCKS, start=1):
        for unit in range(round_repeats(r, B3_DEPTH)):
            name = f"block{stage}{chr(ord('a') + unit)}"
            if exp != 1:
                _tree_put(params, (name, "expand", "kernel"),
                          npz[f"{name}_expand_conv/kernel:0"])
                bn((name,), "expand_bn", f"{name}_expand_bn")
            _tree_put(params, (name, "depthwise", "kernel"),
                      depthwise_kernel(npz[f"{name}_dwconv/depthwise_kernel:0"]))
            bn((name,), "depthwise_bn", f"{name}_bn")
            _mbconv_se(npz, params, name)
            _tree_put(params, (name, "project", "kernel"), npz[f"{name}_project_conv/kernel:0"])
            bn((name,), "project_bn", f"{name}_project_bn")
    return {"params": params, "batch_stats": batch_stats}


def convert_efficientnet_v2s(npz) -> dict:
    """Keras ``efficientnet_v2.EfficientNetV2S(include_top=False,
    include_preprocessing=False)`` dump ->
    ``models.backbones.efficientnet.EfficientNetV2S`` variables.

    Layer-name grammar (tf_keras applications/efficientnet_v2.py): fused
    blocks use ``{expand_conv,expand_bn,project_conv,project_bn}`` (the
    expand-ratio-1 blocks only ``project_*``); MBConv blocks use
    ``{expand_conv,expand_bn,dwconv2,bn,se_reduce,se_expand,project_conv,
    project_bn}``.
    """
    from .models.backbones.efficientnet import EFFICIENTNET_V2S_BLOCKS

    params: dict = {}
    batch_stats: dict = {}

    def bn(mod, dst, src):
        _keras_bn(npz, params, batch_stats, mod, dst, src)

    _tree_put(params, ("stem_conv", "kernel"), npz["stem_conv/kernel:0"])
    bn((), "stem_bn", "stem_bn")
    _tree_put(params, ("top_conv", "kernel"), npz["top_conv/kernel:0"])
    bn((), "top_bn", "top_bn")
    for stage, (kind, exp, _k, _s, r, _f, se_ratio) in enumerate(EFFICIENTNET_V2S_BLOCKS,
                                                                  start=1):
        for unit in range(r):
            name = f"block{stage}{chr(ord('a') + unit)}"
            if kind == "fused":
                if exp != 1:
                    _tree_put(params, (name, "expand", "kernel"),
                              npz[f"{name}_expand_conv/kernel:0"])
                    bn((name,), "expand_bn", f"{name}_expand_bn")
                _tree_put(params, (name, "project", "kernel"),
                          npz[f"{name}_project_conv/kernel:0"])
                bn((name,), "project_bn", f"{name}_project_bn")
                continue
            _tree_put(params, (name, "expand", "kernel"), npz[f"{name}_expand_conv/kernel:0"])
            bn((name,), "expand_bn", f"{name}_expand_bn")
            _tree_put(params, (name, "depthwise", "kernel"),
                      depthwise_kernel(npz[f"{name}_dwconv2/depthwise_kernel:0"]))
            bn((name,), "depthwise_bn", f"{name}_bn")
            if se_ratio:
                _mbconv_se(npz, params, name)
            _tree_put(params, (name, "project", "kernel"), npz[f"{name}_project_conv/kernel:0"])
            bn((name,), "project_bn", f"{name}_project_bn")
    return {"params": params, "batch_stats": batch_stats}


def convert_conv_transpose_kernel(k_tf: np.ndarray) -> np.ndarray:
    """Keras ``Conv2DTranspose`` kernel -> the transfer net's ``ConvTranspose``.

    Keras stores ``(kh, kw, out, in)`` and computes the gradient form of the
    transpose conv (``transpose_kernel=True`` semantics); the net stores
    ``(kh, kw, in, out)`` for ``transpose_kernel=False``, whose kernel enters
    the underlying dilated conv unflipped: a spatial 180 degree flip plus the
    I/O swap.
    """
    if k_tf.ndim != 4:
        raise ValueError(f"expected rank-4 kernel, got {k_tf.shape}")
    return np.ascontiguousarray(np.transpose(k_tf[::-1, ::-1], (0, 1, 3, 2)))


def convert_transfer(npz) -> dict:
    """A transfer-net dump (see the module docstring) -> StyleTransferNet.

    Conv2D kernels map identically (HWIO both sides); BatchNorm
    gamma/beta/moving_* map to flax scale/bias + batch_stats mean/var;
    Conv2DTranspose kernels go through :func:`convert_conv_transpose_kernel`.
    """
    params: dict = {}
    batch_stats: dict = {}
    for key in npz.files:
        layer, leaf = key.rsplit("/", 1)
        value = np.asarray(npz[key])
        if layer.endswith("_bn"):
            if leaf == "gamma":
                params.setdefault(layer, {})["scale"] = value
            elif leaf == "beta":
                params.setdefault(layer, {})["bias"] = value
            elif leaf == "moving_mean":
                batch_stats.setdefault(layer, {})["mean"] = value
            elif leaf == "moving_variance":
                batch_stats.setdefault(layer, {})["var"] = value
            else:
                raise SystemExit(f"unknown BN leaf {key}")
            continue
        if leaf == "kernel" and layer.startswith("expand_"):
            value = convert_conv_transpose_kernel(value)
        params.setdefault(layer, {})[leaf] = value
    return {"params": params, "batch_stats": batch_stats}


def convert_predictor(npz) -> dict:
    """Keras style-prediction model dump -> ``models.predictor.StylePredictor``.

    Head convs (``StylePredictor`` / ``StyleNormPredictor``, 1x1, HWIO both
    sides) and the dummy extractor conv map identically; a MobileNetV3-Small
    or EfficientNetV2-S backbone (if present in the dump, told apart by its
    stem layer name) goes through the matching backbone converter and nests
    under ``backbone``.
    """
    params: dict = {}
    head_layers = ("StylePredictor", "StyleNormPredictor", "dummy_conv")
    for key in npz.files:
        layer = key.split("/", 1)[0]
        if layer in head_layers:
            leaf = key.rsplit("/", 1)[1].replace(":0", "")
            params.setdefault(layer, {})[leaf] = np.asarray(npz[key])
    for name in ("StylePredictor", "StyleNormPredictor"):
        if name not in params:
            raise SystemExit(f"npz is missing head conv {name}")
    variables = {"params": params}
    if any(key.split("/", 1)[0] not in head_layers for key in npz.files):
        if "Conv/kernel:0" in npz.files:          # MobileNetV3 stem
            backbone = convert_mobilenetv3(npz)
        elif "stem_conv/kernel:0" in npz.files:   # EfficientNetV2-S stem
            backbone = convert_efficientnet_v2s(npz)
        else:
            raise SystemExit("unrecognized backbone layers in predictor dump")
        params["backbone"] = backbone["params"]
        variables["batch_stats"] = {"backbone": backbone["batch_stats"]}
    return variables


CONVERTERS = {
    "vgg16": convert_vgg16,
    "mobilenetv3": convert_mobilenetv3,
    "efficientnet_b3": convert_efficientnet_b3,
    "efficientnet_v2s": convert_efficientnet_v2s,
    "transfer": convert_transfer,
    "predictor": convert_predictor,
}


def convert(backbone: str, npz, imagenet_rescale: bool = False) -> dict:
    """The flax variables of ``backbone``'s converter on the loaded dump."""
    if backbone == "efficientnet_b3":
        return convert_efficientnet_b3(npz, imagenet_rescale=imagenet_rescale)
    return CONVERTERS[backbone](npz)


def main(argv: Optional[Sequence[str]] = None) -> Path:
    """Run the CLI with ``argv``; returns the ``.npz`` written."""
    from .tracing.checkpoint import write_tree

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("backbone", choices=sorted(CONVERTERS))
    p.add_argument("npz_path", type=Path)
    p.add_argument("output", type=Path,
                   help=".npz of /-joined flax paths to write (read by cli.load_variables)")
    p.add_argument("--imagenet_rescale", action="store_true",
                   help="efficientnet_b3 only: the dump came from a "
                        "weights='imagenet' build, fold the Keras graph's "
                        "1/sqrt(IMAGENET_STDDEV_RGB) constant into the "
                        "normalization variance")
    args = p.parse_args(argv)

    with np.load(args.npz_path) as npz:
        variables = convert(args.backbone, npz, args.imagenet_rescale)
        n = sum(int(np.prod(npz[k].shape)) for k in npz.files)
    write_tree(args.output, variables)
    print(f"converted {args.backbone}: {n:,} source values -> {args.output}")
    return args.output


if __name__ == "__main__":
    main()
