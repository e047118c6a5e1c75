"""One training step of the JAX package's QAT and joint AdaRound runners,
and the port's, from the same variables on the CPU (``tests/test_torch_qat_step.py``,
``tests/test_torch_adaround_step.py``).

The JAX losses are those of ``quantize_tpu/runners/qat.py`` (``_loss``)
and ``quantize_tpu/runners/adaround.py`` (``_train_fn``'s calibrate pass
and ``loss_fn``), under ``jit``; the port's are
:func:`quantize_tpu_torch.runners.qat.loss_and_grads` and
:func:`quantize_tpu_torch.runners.adaround.calibrate_taps` then
``reconstruction_loss``.

The models: TestCNN at 16 x 16 with its BatchNorms live (random running
statistics and affine parameters, which QAT trains) and folded, a 2-layer
ViT (hidden 32, patch 8, 32 x 32) and MobileNetV2 at width 0.25 with BN
folded (32 x 32); a batch of 4.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from quantize_tpu.models import MODELS as JAX_MODELS
from quantize_tpu.models.vit import VisionTransformer as JViT
from quantize_tpu.nn.intercept import QuantCtx as JaxQuantCtx
from quantize_tpu.quant.adaround import regularization as jax_regularization
import quantize_tpu_torch as qtt
from quantize_tpu_torch import convert
from quantize_tpu_torch.models.vit import VisionTransformer

W8 = {"n_bits": 8, "symmetric": True, "signed": True, "granularity": "channel",
      "range": {"name": "minmax"}}
W4 = {**W8, "n_bits": 4}
A8 = {"n_bits": 8, "symmetric": False, "granularity": "layer",
      "range": {"name": "maminmax", "momentum": 0.1}}
A32 = {"n_bits": 32}
ADA = {"adaround": {"apply": True}}
VIT_KW = dict(image_size=32, patch_size=8, num_layers=2, num_heads=2, hidden_dim=32,
              mlp_dim=64, num_classes=10)

# name: (JAX constructor, port constructor, image size), each taking ctx
MODELS = {
    "testcnn-bn": (lambda ctx: JAX_MODELS.build("testcnn", num_classes=10, ctx=ctx),
                   lambda ctx: qtt.MODELS.build("testcnn", num_classes=10, ctx=ctx, device="cpu"),
                   16),
    "testcnn-bnfold": (lambda ctx: JAX_MODELS.build("testcnn", num_classes=10, ctx=ctx),
                       lambda ctx: qtt.MODELS.build("testcnn", num_classes=10, ctx=ctx,
                                                    device="cpu"), 16),
    "vit": (lambda ctx: JViT(ctx=ctx, **VIT_KW),
            lambda ctx: VisionTransformer(ctx=ctx, device="cpu", **VIT_KW), 32),
    "mobilenet_v2": (lambda ctx: JAX_MODELS.build("mobilenet_v2", num_classes=10, ctx=ctx,
                                                  width_mult=0.25),
                     lambda ctx: qtt.MODELS.build("mobilenet_v2", num_classes=10, ctx=ctx,
                                                  device="cpu", width_mult=0.25), 32),
}


def quant_cfg(name: str, weight: dict, act: dict) -> dict:
    return {"default": {"weight": weight, "activation": act,
                        "bn_folding": name != "testcnn-bn"}}


def setup(name: str, cfg: dict, seed: int = 0):
    """(JAX model, port model, JAX variables after init and one more
    calibrate pass (the port holds them too), batch, labels)."""
    jax_ctor, port_ctor, size = MODELS[name]
    rng = np.random.default_rng(seed)
    x_cal = rng.normal(size=(4, size, size, 3)).astype(np.float32)
    x = rng.normal(size=(4, size, size, 3)).astype(np.float32)
    label = np.array([1, 7, -1, 3], np.int32)  # one padded row
    jm = jax_ctor(JaxQuantCtx(cfg))
    v = dict(jax.jit(lambda k, a: jm.init(k, a, mode="calibrate"))(jax.random.PRNGKey(seed),
                                                                   jnp.asarray(x_cal)))
    v.pop("taps", None)
    v = jax.device_get(v)
    if "batch_stats" in v:
        # live BatchNorms with random statistics and affine parameters
        def rand(path, a):
            r = np.random.default_rng(zlib.crc32(jax.tree_util.keystr(path).encode()))
            if path[-1].key in ("var", "scale"):
                return r.uniform(0.5, 1.5, a.shape).astype(np.float32)
            return r.normal(0, 0.2, a.shape).astype(np.float32)

        v["batch_stats"] = jax.tree_util.tree_map_with_path(rand, v["batch_stats"])
        v["params"] = {k: (jax.tree_util.tree_map_with_path(rand, sub) if k.startswith("bn")
                           else sub) for k, sub in v["params"].items()}
    _, upd = jax.jit(lambda v, a: jm.apply(v, a, mode="calibrate",
                                           mutable=["qobs", "qparams"]))(v, jnp.asarray(x_cal))
    v = jax.device_get({**v, **upd})
    tm = port_ctor(qtt.QuantCtx(cfg))
    convert.from_jax_variables(tm, v)
    return jm, tm, v, x, label


def flat_keys(tree: dict, names) -> set:
    return {f"{c}/{k}" for c in names if c in tree for k in convert.flatten(tree[c])}


def jax_qat_step(jm, variables, x, label):
    """quantize_tpu/runners/qat.py's loss and its gradient."""
    trainable = {c: variables[c] for c in ("params", "qparams") if c in variables}
    frozen = {c: t for c, t in variables.items() if c not in trainable}

    def _loss(trainable, frozen, img, label):
        logits = jm.apply({**frozen, **trainable}, img, mode="quant")
        valid = label >= 0
        loss_vec = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.maximum(label, 0))
        return jnp.sum(loss_vec * valid) / jnp.maximum(jnp.sum(valid), 1), logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(_loss, has_aux=True))(
        trainable, frozen, jnp.asarray(x), jnp.asarray(label))
    return float(loss), np.asarray(logits), jax.device_get(grads)


def jax_init_adaround(jm, variables, x):
    """quantize_tpu/runners/adaround.py's ``_init_adaround``: calibrate,
    then write V."""
    _, upd = jax.jit(lambda v, a: jm.apply(v, a, mode="calibrate",
                                           mutable=["qobs", "qparams"]))(variables, jnp.asarray(x))
    variables = {**variables, **jax.device_get(upd)}
    _, upd = jax.jit(lambda v, a: jm.apply(v, a, mode="init_adaround",
                                           mutable=["adaround"]))(variables, jnp.asarray(x))
    return {**variables, **jax.device_get(upd)}


def jax_joint_step(jm, variables, x, beta):
    """quantize_tpu/runners/adaround.py's joint step: loss, logits, V grads
    and the variables its calibrate pass leaves. The calibrate pass runs
    eagerly, the loss and its gradient under ``jit``: the runner jits the
    two together, and XLA then rounds the MinMax weight scale computed in
    the graph an ulp away from the true quotient absmax / qmax, so that
    each channel's extreme weight, on the grid at qmax in the calibrate
    pass, lands an ulp below it in the quant pass and AdaRound's floor takes
    it a step down."""
    img = jnp.asarray(x)
    _, upd = jm.apply(variables, img, mode="calibrate", mutable=["qobs", "qparams", "taps"])
    fp_taps = jax.lax.stop_gradient(upd.pop("taps"))
    variables = {**variables, "qobs": upd["qobs"], "qparams": upd["qparams"]}

    def loss_fn(ada, variables, fp_taps, img, beta):
        logits, upd2 = jm.apply({**variables, "adaround": ada}, img, mode="quant",
                                mutable=["taps"])
        terms = jax.tree.map(lambda q, o: jnp.mean((q - o) ** 2), upd2["taps"], fp_taps)
        recon = sum(jax.tree.leaves(terms))
        reg = sum(jax_regularization(v, beta) for v in jax.tree.leaves(ada))
        return recon + reg, logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["adaround"], variables, fp_taps, img, jnp.float32(beta))
    return (float(loss), np.asarray(logits), jax.device_get(grads), jax.device_get(variables),
            jax.device_get(fp_taps))


def check_grad(got, want, name: str) -> None:
    """At least 99% of the elements within rtol 1e-4 plus atol 1e-6, and the
    difference's L2 norm within 1e-3 of the gradient's plus the L2 norm of
    the same 1e-6 floor (1e-6 * sqrt(n)).

    A quantizer's scale and zero-point gradients are differences of two
    sums that nearly cancel (the dequantize path's g*q and the quantize
    path's -g*x/scale, each up to qmax times the result; a symmetric
    quantizer's zero point has a true gradient of 0 and float32 noise in
    both packages). The conv and matmul gradients feeding them differ
    between XLA and PyTorch by ~1e-6 relative, which that cancellation
    multiplies by up to qmax: for ``qparams`` leaves the elementwise floor
    is 1e-3 of the leaf's largest entry, the L2 criterion's own bound."""
    got = np.asarray(got, np.float64).reshape(-1)
    want = np.asarray(want, np.float64).reshape(-1)
    assert got.shape == want.shape, name
    floor = 1e-6 + (1e-3 * np.abs(want).max() if name.startswith("qparams/") else 0.0)
    close = np.abs(got - want) <= 1e-4 * np.abs(want) + floor
    assert close.mean() >= 0.99, f"{name}: {(~close).sum()}/{close.size} elements off"
    norm, diff = np.linalg.norm(want), np.linalg.norm(got - want)
    assert diff <= 1e-3 * norm + 1e-6 * np.sqrt(want.size), (
        f"{name}: |diff| {diff:.3e} vs |grad| {norm:.3e}")


def to_torch(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))
