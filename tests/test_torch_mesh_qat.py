"""One sharded QAT step of the port on gloo ranks on the CPU
(``tests/_torch_mesh.py``) against one device and against the JAX
package's step, the counterpart of ``__graft_entry__.py:113-141`` (one
sharded QAT step on a ``(dp, tp)`` mesh).

ResNet-18 W8A8 at 32 px, 16 classes, BN folded, the QAT configs'
activations (``tests/_torch_train_parity.py``), a batch of ``dp * 2`` with
one padded row, at ``(2, 1)``, ``(1, 2)`` and ``(2, 2)``; TestCNN with its
BatchNorms live at ``(1, 2)`` (their scale and bias split by JAX's rules
and gathered whole: they run after the gathered conv).

* Against the port's one device on the same batch: the loss within 1e-5
  relative, every trainable leaf's gradient (gathered whole) and the
  variables after SGD 1e-3 by ``check_grad``.
* Against JAX's ``quantize_tpu/runners/qat.py`` loss on the whole batch
  (``jax_qat_step``, one device: its sharding changes no value) and
  ``optax.sgd``'s update, by the same criteria beyond the port's own
  one-device gap. On this ResNet-18 batch the port's one device already
  rounds one int8 activation step away from XLA's (ROADMAP §3's accepted
  f32 reassociation; eager JAX gives jit's values), so its loss sits 5e-4
  to 2e-3 from JAX's and about half the leaves miss ``check_grad``: the
  mesh may not move further from JAX than that, plus the criterion. The
  TestCNN step flips nothing, but its first activation scale's gradient
  (a sum over the image that nearly cancels, ``check_grad``'s docstring)
  sits 1e-3 from JAX's on one device already: it is held the same way.
* The collectives of a step: the valid count's and the gradients'
  all-reduces over ``data``, one all-gather a split layer and its input
  gradient's all-reduce over ``model``, nothing else; every rank ends with
  the same variables.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh import flat_tensors, run_jobs
from _torch_train_parity import A8, W8, check_grad, jax_qat_step, quant_cfg
from quantize_tpu.models import MODELS as JAX_MODELS
from quantize_tpu.nn.intercept import QuantCtx as JaxQuantCtx
import quantize_tpu_torch as qtt
from quantize_tpu_torch import convert
from quantize_tpu_torch.runners.qat import loss_and_grads

torch.set_num_threads(2)

LR = 1e-3
MESHES = [(2, 1), (1, 2), (2, 2)]
# name: (registry name, keywords, image size, BN folded), the meshes it runs on
MODELS = {"resnet18": (("resnet18", {"num_classes": 16}, 32, True), MESHES),
          "testcnn-bn": (("testcnn", {"num_classes": 10}, 16, False), [(1, 2)])}
SPLIT = {"resnet18": 21, "testcnn-bn": 4}
LABEL = np.array([3, -1, 15, 7], np.int32)


def _cfg(name):
    return quant_cfg("testcnn-bn" if not MODELS[name][0][3] else name, W8, A8)


def _jax_model(name):
    registry, kw, size, _ = MODELS[name][0]
    jm = JAX_MODELS.build(registry, ctx=JaxQuantCtx(_cfg(name)), **kw)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, size, size, 3)).astype(np.float32)
    v = dict(jax.jit(lambda k, a: jm.init(k, a, mode="calibrate"))(jax.random.PRNGKey(0),
                                                                   jnp.asarray(x)))
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
                                           mutable=["qobs", "qparams"]))(v, jnp.asarray(x))
    return jm, jax.device_get({**v, **upd}), x


def _flat(tree):
    return {f"{c}/{k}": a for c in tree for k, a in convert.flatten(tree[c]).items()}


def _port_step(name, v, x, label):
    """The port's one-device step: loss, flat gradients, flat updated
    variables (numpy)."""
    registry, kw, _, _ = MODELS[name][0]
    model = qtt.MODELS.build(registry, ctx=qtt.QuantCtx(_cfg(name)), device="cpu", **kw)
    convert.from_jax_variables(model, v)
    loss, _, grads = loss_and_grads(model, torch.from_numpy(x), torch.from_numpy(label))
    grads = {k: g.numpy() for k, g in grads.items() if g is not None}
    flat = _flat(v)
    return float(loss), grads, {k: (torch.tensor(np.asarray(flat[k])) + float(-np.float32(
        LR)) * torch.from_numpy(g)).numpy() for k, g in grads.items()}


def _jax_step(jm, v, x, label):
    loss, _, grads = jax_qat_step(jm, v, x, label)
    grads = _flat(grads)
    return loss, grads, {k: a - np.float32(LR) * grads[k] for k, a in _flat(v).items()
                         if k in grads}


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """By (model, global batch): JAX's step and the port's one-device step
    (loss, flat gradients, flat updated variables); the ranks' reports and
    saved results by world size."""
    tmp = tmp_path_factory.mktemp("mesh_qat")
    refs, jobs = {}, {2: [], 4: []}
    for name, ((registry, kw, _, _), meshes) in MODELS.items():
        jm, v, x = _jax_model(name)
        torch.save(flat_tensors(v), tmp / f"{name}.pt")
        for dp, tp in meshes:
            n = dp * 2
            np.save(tmp / f"{name}{n}.x.npy", x[:n])
            np.save(tmp / f"{name}{n}.label.npy", LABEL[:n])
            if (name, n) not in refs:
                refs[name, n] = {"jax": _jax_step(jm, v, x[:n], LABEL[:n]),
                                 "one": _port_step(name, v, x[:n], LABEL[:n])}
            jobs[dp * tp].append({
                "name": f"{name}{dp}x{tp}", "mesh": [dp, tp],
                "build": {"name": registry, "kw": kw}, "cfg": _cfg(name),
                "variables": str(tmp / f"{name}.pt"), "x": str(tmp / f"{name}{n}.x.npy"),
                "label": str(tmp / f"{name}{n}.label.npy"), "step": LR,
                "out": str(tmp / f"{name}{dp}x{tp}")})
    ranks = {world: run_jobs(world, js, tmp) for world, js in jobs.items()}
    return refs, ranks


CASES = [(name, mesh) for name, (_, meshes) in MODELS.items() for mesh in meshes]
IDS = [f"{name}-{dp}x{tp}" for name, (dp, tp) in CASES]


def _case(steps, name, mesh):
    refs, ranks = steps
    dp, tp = mesh
    reports, saved = ranks[dp * tp]
    key = f"{name}{dp}x{tp}"
    return refs[name, dp * 2], [r[key] for r in reports], [s[key] for s in saved]


def _check(got, want, key, tag, beyond=None):
    """``check_grad`` of ``got`` against ``want``; with ``beyond`` (the port's
    one device), where that misses ``want`` too, the difference's L2 norm
    within ``beyond``'s plus the criterion's L2 bound."""
    try:  # check_grad reads the collection from the name
        check_grad(beyond if beyond is not None else got, want, key)
    except AssertionError:
        if beyond is None:
            raise
        a, w = np.asarray(got, np.float64).ravel(), np.asarray(want, np.float64).ravel()
        gap = np.linalg.norm(np.asarray(beyond, np.float64).ravel() - w)
        bound = gap + 1e-3 * np.linalg.norm(w) + 1e-6 * np.sqrt(w.size)
        assert np.linalg.norm(a - w) <= bound, f"{tag}: {key} moved beyond the one-device gap"
        return
    try:
        check_grad(got, want, key)
    except AssertionError as exc:
        raise AssertionError(f"{tag}: {exc}") from None


def _hold(got, ref, tag, beyond=None):
    """A rank's step against ``ref`` (loss, gradients, updated variables)."""
    loss, grads, updated = ref
    tol = 1e-5 * abs(loss)
    if beyond is not None:
        tol += abs(beyond[0] - loss)
    assert abs(float(got["loss"]) - loss) <= tol, (tag, float(got["loss"]), loss)
    assert set(got["grads"]) <= set(grads) and set(got["updated"]) == set(updated)
    for key, want in grads.items():
        g = got["grads"].get(key)
        _check(np.zeros_like(want) if g is None else g.numpy(), want, key, tag,
               None if beyond is None else beyond[1].get(key, np.zeros_like(want)))
    for key, want in updated.items():
        _check(got["updated"][key].numpy(), want, key, tag,
               None if beyond is None else beyond[2][key])


@pytest.mark.parametrize("name,mesh", CASES, ids=IDS)
def test_step_matches_one_device(steps, name, mesh):
    ref, _, saved = _case(steps, name, mesh)
    for rank, got in enumerate(saved):
        _hold(got, ref["one"], f"rank {rank}")
        # every rank ends with the same variables
        for key, t in got["updated"].items():
            assert torch.equal(t, saved[0]["updated"][key]), (rank, key)


@pytest.mark.parametrize("name,mesh", CASES, ids=IDS)
def test_step_matches_jax(steps, name, mesh):
    ref, _, saved = _case(steps, name, mesh)
    for rank, got in enumerate(saved):
        _hold(got, ref["jax"], f"rank {rank}", ref["one"])


@pytest.mark.parametrize("name,mesh", CASES, ids=IDS)
def test_step_collectives(steps, name, mesh):
    _, reports, saved = _case(steps, name, mesh)
    dp, tp = mesh
    split = SPLIT[name] if tp > 1 else 0
    want = {}
    if split:
        # one gather a split layer forward, one input-gradient reduce back
        want = {"all-gather": split, "all-reduce": split}
    if dp > 1:  # the valid count, then the gradients with the loss
        want["all-reduce"] = want.get("all-reduce", 0) + 2
    for rep in reports:
        assert rep["step"] == want
        assert len(rep["split"]) == split
    if name == "testcnn-bn":
        # the live BatchNorms' sharded scale and bias gathered whole at load
        assert reports[0]["load"]["all-gather"] == 4
        for key, g in saved[0]["whole_grads"].items():  # the same on both ranks, unsummed
            assert torch.equal(g, saved[1]["whole_grads"][key]), key
        assert any("BatchNorm_0/scale" in k for k in saved[0]["whole_grads"])
