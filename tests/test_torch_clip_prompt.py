"""CoOp / CoCoOp prompt learning in the port, held against the JAX package
on the CPU (``tests/test_prompt_learning.py``'s cases: the tiny CLIP ViT,
3 classes, images 32 x 32).

JAX's initial variables are carried into the port; the fp32 logits must
agree within 1e-5 of max|logits|, the context shapes (shared and
class-specific) and the parameter names must be JAX's, and the gradient of
a cross-entropy loss must reach the context vectors (``params/ctx``, an
``nn.Parameter``) and equal JAX's ``jax.grad`` within 1e-4 of its largest
entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from quantize_tpu.models.clip.prompt_learning import CoCoOpCLIP as JCoCoOp
from quantize_tpu.models.clip.prompt_learning import CoOpCLIP as JCoOp
from quantize_tpu_torch import convert
from quantize_tpu_torch.models.clip.prompt_learning import CoCoOpCLIP, CoOpCLIP

torch.set_num_threads(2)

TINY = dict(embed_dim=32, vision_layers=2, vision_width=64, vision_patch_size=8,
            context_length=16, vocab_size=64, transformer_width=32,
            transformer_heads=2, transformer_layers=2)
NAMES = ["cat", "dog", "bird"]


@pytest.fixture(scope="module", params=[("coop", {}), ("coop", {"csc": True}), ("cocoop", {})],
                ids=["coop", "coop-csc", "cocoop"])
def case(request):
    kind, kw = request.param
    kw = {"n_ctx": 4 if kind == "coop" else 2, **kw}
    jcls = JCoOp if kind == "coop" else JCoCoOp
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32)
    jm = jcls(backbone="ViT-B/16", num_classes=3, config_overrides=TINY, classnames=NAMES, **kw)
    # CoCoOp's vmap over images leaks a tracer under jit: it runs eagerly
    jit = jax.jit if kind == "coop" else (lambda f: f)
    variables = jax.device_get(dict(jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))))
    tm = (CoOpCLIP if kind == "coop" else CoCoOpCLIP)(
        "ViT-B/16", 3, config_overrides=TINY, classnames=NAMES, image_size=32, device="cpu", **kw)
    convert.from_jax_variables(tm, variables)
    y = np.array([0, 2])

    def loss_fn(ctx_p):
        params = {**variables["params"], "ctx": ctx_p}
        logits = jm.apply({**variables, "params": params}, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean()

    want = np.asarray(jit(jm.apply)(variables, jnp.asarray(x)))
    want_grad = np.asarray(jit(jax.grad(loss_fn))(variables["params"]["ctx"]))
    tm.zero_grad()
    got = tm(torch.from_numpy(x))
    F.cross_entropy(got, torch.from_numpy(y)).backward()
    return {"kind": kind, "kw": kw, "logits": (got.detach().numpy(), want),
            "grad": (tm.get_var("params", "ctx").grad, want_grad),
            "keys": (set(convert.flatten(convert.to_numpy(tm)["params"])),
                     set(convert.flatten(variables["params"])))}


def test_parameters_have_the_flax_names(case):
    mine, theirs = case["keys"]
    assert mine == theirs and "ctx" in mine
    assert ("meta_fc1/kernel" in mine) == (case["kind"] == "cocoop")


def test_context_shape(case):
    n_ctx = case["kw"]["n_ctx"]
    grad, want = case["grad"]
    assert tuple(grad.shape) == want.shape == ((3, n_ctx, 32) if case["kw"].get("csc")
                                               else (n_ctx, 32))


def test_logits_match_jax(case):
    got, want = case["logits"]
    assert got.shape == want.shape == (2, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_gradient_reaches_the_context_as_jax(case):
    grad, want = case["grad"]
    assert grad is not None and float(grad.norm()) > 0
    np.testing.assert_allclose(grad.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_coop_context_trains_as_jax():
    """tests/test_prompt_learning.py::test_coop_ctx_is_trainable's case (2
    classes, 2 context vectors, 4 images): the gradient of the mean
    cross-entropy with respect to ``ctx`` equals ``jax.grad``'s within 1e-4
    of its largest entry, and one Adam step of the port's optimizer moves
    the context as optax's does (rtol 1e-6)."""
    from quantize_tpu_torch.optim import Optimizer, build_optimizer
    from quantize_tpu_torch.utils import Config

    jm = JCoOp(backbone="ViT-B/16", num_classes=2, n_ctx=2, config_overrides=TINY,
               classnames=["cat", "dog"])
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(4, 32, 32, 3)).astype(np.float32))
    y = jnp.asarray([0, 1, 0, 1])
    variables = jax.device_get(dict(jax.jit(jm.init)(jax.random.PRNGKey(0), x)))

    def loss_fn(ctx_p):
        params = {**variables["params"], "ctx": ctx_p}
        logits = jm.apply({**variables, "params": params}, x)
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()

    ctx0 = variables["params"]["ctx"]
    want = np.asarray(jax.jit(jax.grad(loss_fn))(ctx0))
    tm = CoOpCLIP("ViT-B/16", 2, n_ctx=2, config_overrides=TINY, classnames=["cat", "dog"],
                  image_size=32, device="cpu")
    convert.from_jax_variables(tm, variables)
    ctx = tm.get_var("params", "ctx")
    loss = F.cross_entropy(tm(torch.tensor(np.asarray(x))), torch.tensor([0, 1, 0, 1]))
    got, = torch.autograd.grad(loss, [ctx])
    assert float(got.norm()) > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())

    cfg = Config({"optimizer": {"name": "adam", "lr": 1e-3}, "lr_scheduler": {"name": "constant"}})
    tx = optax.adam(1e-3)
    updates, _ = tx.update(jnp.asarray(want), tx.init(jnp.asarray(ctx0)))
    opt = Optimizer(build_optimizer(cfg), {"params/ctx": ctx})
    opt.step({"params/ctx": ctx}, {"params/ctx": torch.from_numpy(want.copy())})
    np.testing.assert_allclose(ctx.detach().numpy(), np.asarray(optax.apply_updates(ctx0, updates)),
                               rtol=1e-6)
    assert not np.array_equal(ctx.detach().numpy(), ctx0)
