"""The EfficientNet loss towers (B3 ``efficientnet``, V2-S
``efficientnet_v2s``) in the port's loss function, against the JAX package on
the CPU, in the three tower modes (``split``, ``batched``, ``scan``).

Each tower's JAX variables come from ``jax.eval_shape`` filled by a numpy
seed and reach the port through ``weights.load_flax``.  Limits (f32): loss
components rtol 1e-4; the gradient with respect to the prediction rtol 1e-3
+ atol 1e-5 x its largest value.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_style_transfer_torch.models import losses as tlosses
from realtime_style_transfer_torch.weights import load_flax
from realtime_style_transfer_tpu.models import losses as jlosses
from test_torch_efficientnet import seeded_variables

torch.set_num_threads(2)
TOWERS = ("efficientnet", "efficientnet_v2s")
SHAPE = (2, 48, 48, 3)


def images(shape, seed):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def tower_variables(name, jmod):
    """Seeded variables of a tower whose deep taps follow its input: for
    B3, He-scaled kernels and a Normalization of variance 255^-2 (B3 sees
    the tower's [-1, 1] image / 255; an imported layer holds data
    statistics), which brings the image back to [-1, 1].  Without them the
    deep taps barely move with the image (the content term is then a
    difference of nearly equal numbers), and V2-S's taps do at gain 1."""
    gain = 2 ** 0.5 if name == "efficientnet" else 1.0
    variables = seeded_variables(jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0), jnp.zeros(SHAPE))), 11, gain=gain)
    if name == "efficientnet":
        norm = variables["batch_stats"]["efficientnetb3"]["normalization"]
        norm["mean"] = np.zeros(3, np.float32)
        norm["variance"] = np.full(3, 255.0 ** -2, np.float32)
    return variables


@pytest.fixture(scope="module")
def towers():
    """Per tower: JAX's loss components and gradient with respect to the
    prediction, and the port's tower filled with the same weights."""
    pred, gt_c, gt_s = images(SHAPE, 1), images(SHAPE, 2), images((2, 1) + SHAPE[1:], 3)
    out = {}
    for name in TOWERS:
        jmod = jlosses.LOSS_EXTRACTORS[name]()
        variables = tower_variables(name, jmod)
        jfn = jlosses.make_style_loss_function(functools.partial(jmod.apply, variables),
                                               jmod.factors)

        def total(p, jfn=jfn):
            losses = jfn(p, {"content": gt_c, "style": gt_s})
            return jnp.mean(losses["loss"]), losses

        (_, losses), grad = jax.jit(jax.value_and_grad(total, has_aux=True))(pred)
        out[name] = dict(losses=jax.tree.map(np.asarray, losses), grad=np.asarray(grad),
                         port=load_flax(tlosses.loss_extractor(name), variables).eval(),
                         inputs=(pred, gt_c, gt_s))
    return out


@pytest.mark.parametrize("tower_mode", tlosses.TOWER_MODES)
@pytest.mark.parametrize("name", TOWERS)
def test_tower_loss_and_its_gradient_match_jax(towers, name, tower_mode):
    ref = towers[name]
    tmod = ref["port"]
    assert tmod.factors == tlosses.LossFactors(1.0, 1.0, 1.0, 1.0)
    pred, gt_c, gt_s = (torch.from_numpy(a) for a in ref["inputs"])
    pred.requires_grad_(True)
    fn = tlosses.make_style_loss_function(tmod, tmod.factors, tower_mode=tower_mode)
    losses = fn(pred, {"content": gt_c, "style": gt_s})
    (grad,) = torch.autograd.grad(torch.mean(losses["loss"]), [pred])
    assert set(losses) == set(ref["losses"])
    for key, want in ref["losses"].items():
        np.testing.assert_allclose(losses[key].detach().numpy(), want, rtol=1e-4, err_msg=key)
    want = ref["grad"]
    np.testing.assert_allclose(grad.numpy(), want, rtol=1e-3, atol=1e-5 * np.abs(want).max())
