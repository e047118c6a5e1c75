"""One joint AdaRound step in the port against the JAX package's AdaRound
runner on the CPU (``tests/_torch_train_parity.py``): TestCNN W4A8 and a
tiny ViT W4A8 here, MobileNetV2 (width 0.25) W4 weight-only with BN folded
in ``tests/test_torch_adaround_step_mbv2.py``, every weight quantizer with
``adaround.apply``.

* Init (``init_adaround``: calibrate, then V from the fractional part): the
  same V leaves as JAX's ``adaround`` collection, the calibrated qparams
  within rtol 1e-5 and h(V) equal to the fractional part of
  ``w / scale - zero`` within 1e-5; from JAX's calibrated variables, each V
  within rtol 1e-6 plus 2^-22 of JAX's (V = -log(1.2 / (frac + 0.1) - 1)
  crosses 0, and JAX's float32 log is XLA's own).
* The step from JAX's initialized variables with V moved off its initial
  values by seeded noise (β from the schedule's decay; JAX's calibrate
  pass eagerly, ``_torch_train_parity.jax_joint_step`` says why). At its
  initial value every weight exactly on the grid has h(V) exactly 0, the
  clip's endpoint, whose gradient (0.5) JAX under ``jit`` does not pass: XLA
  fuses sigmoid(V) * 1.2 - 0.1 into one multiply-add there and lands an
  ulp below 0, where eager JAX, as the port, lands on it. The calibrate
  pass: its FP32 taps within rtol 1e-5 (of max|tap|) and its qparams within
  rtol 1e-5; the quant pass then runs from JAX's qparams (JAX's MSE search
  computes its scales in a compiled scan, an ulp from the true quotients
  the port takes, and at the grid's edge an ulp of scale moves a weight
  across AdaRound's floor). The checks:
  the loss (reconstruction MSE over every tap layer's output plus each V's
  regularization) within rtol 1e-5, the qparams its calibrate pass leaves
  within rtol 1e-5, and each V's gradient by ``check_grad`` (99% of the
  elements within rtol 1e-4 plus atol 1e-6, the L2 difference within 1e-3
  of the gradient's).
"""
import jax
import numpy as np
import pytest
import torch

from _torch_train_parity import (A8, A32, ADA, W4, check_grad, flat_keys, jax_init_adaround,
                                 jax_joint_step, quant_cfg, setup, to_torch)
from quantize_tpu_torch import convert
from quantize_tpu_torch.nn.variables import trainable
from quantize_tpu_torch.quant.adaround import beta_schedule, rect_sigmoid
from quantize_tpu_torch.runners.adaround import (calibrate_taps, init_adaround,
                                                  reconstruction_loss)

torch.set_num_threads(2)

CASES = {"testcnn-bnfold": A8, "vit": A8}
BETA = beta_schedule(5, 10)


def run_step(name, act):
    jm, tm, v, x, _ = setup(name, quant_cfg(name, {**W4, **ADA}, act))
    v_init = jax_init_adaround(jm, v, x)
    init_adaround(tm, to_torch(x))
    port_init = convert.to_numpy(tm)
    # V from JAX's calibrated variables: the port's init_adaround pass alone
    convert.from_jax_variables(tm, {c: t for c, t in v_init.items() if c != "adaround"})
    with torch.no_grad():
        tm(to_torch(x), mode="init_adaround")
    port_v = convert.to_numpy(tm)["adaround"]
    # both steps from JAX's variables, V moved off its initial values (as a
    # step after the first finds it)
    rng = np.random.default_rng(7)
    moved = {**v_init, "adaround": jax.tree.map(
        lambda a: (a + rng.normal(0, 0.5, a.shape)).astype(np.float32), v_init["adaround"])}
    convert.from_jax_variables(tm, moved)
    want = jax_joint_step(jm, moved, x, BETA)
    fp = calibrate_taps(tm, to_torch(x))
    after = convert.to_numpy(tm)
    # the quant pass from JAX's calibrated qparams: an ulp of a scale moves
    # a weight exactly on the grid's edge across AdaRound's floor
    convert.from_jax_variables(tm, {"qparams": want[3]["qparams"]})
    got = reconstruction_loss(tm, to_torch(x), fp, BETA)
    return {"name": name, "init": (port_init, v_init), "v": port_v, "jax": want, "port": got,
            "after": after, "fp": fp}


@pytest.fixture(scope="module", params=sorted(CASES))
def step(request):
    return run_step(request.param, CASES[request.param])


def test_init_calibrates_as_jax_and_h_v_is_the_fraction(step):
    mine, theirs = step["init"]
    flat_m, flat_t = convert.flatten(mine["adaround"]), convert.flatten(theirs["adaround"])
    assert set(flat_m) == set(flat_t) and all(k.endswith("w_quantizer/V") for k in flat_m)
    qm, qt = convert.flatten(mine["qparams"]), convert.flatten(theirs["qparams"])
    for key, want in qt.items():
        np.testing.assert_allclose(qm[key], want, rtol=1e-5, atol=1e-7, err_msg=key)
    params = convert.flatten(mine["params"])
    for key, v in flat_m.items():
        layer = key[:-len("w_quantizer/V")]
        v_over = (params[layer + "kernel"] / qm[layer + "w_quantizer/scale"]
                  - qm[layer + "w_quantizer/zero"])
        frac = np.clip(v_over - np.floor(v_over), -0.1 + 1e-6, 1.1 - 1e-6)
        np.testing.assert_allclose(rect_sigmoid(to_torch(v)).numpy(), frac, atol=1e-5,
                                   err_msg=key)


def test_init_writes_jax_v(step):
    """From the same calibrated variables, V is JAX's."""
    want = convert.flatten(step["init"][1]["adaround"])
    got = convert.flatten(step["v"])
    assert set(got) == set(want)
    for key, v in want.items():
        np.testing.assert_allclose(got[key], v, rtol=1e-6, atol=2.0 ** -22, err_msg=key)


def test_trainable_leaves_are_the_adaround_collection(step):
    _, _, grads = step["port"]
    mine, theirs = step["init"]
    assert set(grads) == flat_keys(theirs, ("adaround",))
    assert not any(k.startswith(("params/", "qparams/")) for k in grads)


def test_loss_and_calibration_match_jax(step):
    loss_j, logits_j, _, after_j, fp_j = step["jax"]
    taps_j = {key[:-len("/out")]: outs for key, outs in convert.flatten(fp_j).items()}
    assert set(step["fp"]) == set(taps_j)
    for path, taps in step["fp"].items():
        assert len(taps["out"]) == len(taps_j[path]) == 1
        want = np.asarray(taps_j[path][0])
        np.testing.assert_allclose(taps["out"][0].numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(), err_msg=f"fp32 tap {path}")
    loss_t, logits_t, _ = step["port"]
    np.testing.assert_allclose(float(loss_t), loss_j, rtol=1e-5)
    np.testing.assert_allclose(logits_t.numpy(), logits_j, rtol=0,
                               atol=1e-5 * np.abs(logits_j).max())
    mine = convert.flatten(step["after"]["qparams"])
    for key, want in convert.flatten(after_j["qparams"]).items():
        np.testing.assert_allclose(mine[key], want, rtol=1e-5, atol=1e-7, err_msg=key)


def test_v_gradients_match_jax(step):
    _, _, grads_j, _, _ = step["jax"]
    _, _, grads_t = step["port"]
    flat_j = {f"adaround/{k}": a for k, a in convert.flatten(grads_j).items()}
    assert set(flat_j) == set(grads_t)
    for key, want in flat_j.items():
        check_grad(grads_t[key].numpy(), want, key)
        assert np.any(want), key
