"""The slice end to end: ResNet-18/50 W8A8 init -> calibrate -> pack ->
packed forward in the port, held against the JAX package on the CPU.

JAX variables are carried into the port with quantize_tpu_torch.convert,
then both packages run the same steps on the same numpy inputs (batch 2,
32x32, 10 classes).

* Calibration runs float32 convolutions, which oneDNN and XLA sum in
  different orders, so calibrated ranges agree to float32 reassociation
  noise: rtol 1e-5 (seen: 1.2e-6 for ResNet-50, 4.1e-7 for ResNet-18).
* Pack from the same calibrated variables is exact: integer buffers and
  scales are bit-equal.
* The packed forward on the same deploy buffers is bit-equal to JAX's
  (the integer sums are exact and the epilogues run the same float32
  operations in the same order), fusion on and off. The criterion is
  1e-3 of max|logits|; the difference seen is 0.0.
* Quant-mode (fake-quant) logits cannot match tightly across frameworks:
  a ~1e-7 difference in one float32 conv output near a round() boundary
  flips it by a whole quant step, as tests/test_golden_models.py explains.
  They are held to the network's own quantization-noise envelope (seen:
  max|diff| 0.0116 against a noise of 0.0286 for ResNet-50; 4.2e-7 for
  ResNet-18).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantize_tpu.deploy import model_size_bytes as jax_model_size_bytes
from quantize_tpu.deploy import pack_model as jax_pack_model
from quantize_tpu.models import MODELS as JAX_MODELS
from quantize_tpu.nn.intercept import QuantCtx as JaxQuantCtx
from quantize_tpu.nn.precision import fused_residual as jax_fused_residual
import quantize_tpu_torch as qtt
from quantize_tpu_torch import convert
from quantize_tpu_torch.ops import launch_counts

torch.set_num_threads(2)

CFG = {"default": {
    "weight": {"n_bits": 8, "symmetric": True, "signed": True, "granularity": "channel",
               "range": {"name": "minmax"}},
    "activation": {"n_bits": 8, "symmetric": False, "granularity": "layer",
                   "range": {"name": "minmax"}},
    "bn_folding": True}}


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - b)) / np.max(np.abs(b)))


@pytest.fixture(scope="module", params=["resnet18", "resnet50"])
def case(request):
    name = request.param
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    x_cal = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    xj = jnp.asarray(x)
    jm = JAX_MODELS.build(name, num_classes=10, ctx=JaxQuantCtx(CFG))
    v0 = dict(jm.init(jax.random.PRNGKey(0), xj, mode="calibrate"))
    v0.pop("taps", None)
    _, upd = jm.apply(v0, jnp.asarray(x_cal), mode="calibrate", mutable=["qobs", "qparams"])
    v1 = jax.device_get({**v0, **upd})
    out = {"name": name}

    tm = qtt.MODELS.build(name, num_classes=10, ctx=qtt.QuantCtx(CFG), device="cpu")
    convert.from_jax_variables(tm, jax.device_get(v0))
    qtt.calibrate_model(tm, [x_cal], device="cpu")
    out["calibrated"] = (convert.to_numpy(tm), v1)

    # simulate and pack both from the same calibrated variables
    convert.from_jax_variables(tm, v1)
    with torch.no_grad():
        out["quant"] = (tm(torch.from_numpy(x), mode="quant").numpy(),
                        np.asarray(jm.apply(v1, xj, mode="quant")),
                        np.asarray(jm.apply(v1, xj, mode="fp32")))
    deploy = jax_pack_model(jm, v1, xj)
    port_deploy = qtt.pack_model(tm, x, device="cpu")
    out["packed_buffers"] = (convert.flatten(convert.to_numpy(tm)["packed"]),
                             convert.flatten(jax.device_get(deploy["packed"])))
    out["deploy_keys"] = ({c: set(v) for c, v in port_deploy.items()},
                          {c: set(convert.flatten(v)) for c, v in deploy.items()})
    out["deploy_bytes"] = (qtt.model_size_bytes(port_deploy), jax_model_size_bytes(deploy))
    before = launch_counts()
    for fused in (False, True):
        with jax_fused_residual(fused):
            want = np.asarray(jm.apply(deploy, xj, mode="packed"))
        with qtt.fused_residual(fused), torch.no_grad():
            got = tm(torch.from_numpy(x), mode="packed").numpy()
        out[("packed", fused)] = (got, want)
    with qtt.fused_residual(True), qtt.packed_carry(torch.bfloat16), torch.no_grad():
        out["packed_bf16"] = tm(torch.from_numpy(x), mode="packed").float().numpy()
    out["launches_unchanged"] = launch_counts() == before
    return out


def test_calibrated_qparams_and_observers_match(case):
    port, jax_vars = case["calibrated"]
    for col in ("qparams", "qobs"):
        mine, theirs = convert.flatten(port[col]), convert.flatten(jax_vars[col])
        assert set(mine) == set(theirs), col
        for key, val in theirs.items():
            if key.endswith("count"):
                np.testing.assert_array_equal(mine[key], val, err_msg=key)
            else:
                np.testing.assert_allclose(mine[key], val, rtol=1e-5, atol=1e-7, err_msg=key)


def test_pack_buffers_match(case):
    mine, theirs = case["packed_buffers"]
    assert set(mine) == set(theirs)
    assert any(k.endswith("corr_a") for k in theirs) and any(k.endswith("col_sum") for k in theirs)
    for key, val in theirs.items():
        assert mine[key].dtype == np.asarray(val).dtype, key
        if key.endswith(("w_int", "col_sum", "corr_a")):
            np.testing.assert_array_equal(mine[key], val, err_msg=key)
        else:
            np.testing.assert_allclose(mine[key], val, rtol=1e-6, atol=0, err_msg=key)


def test_deploy_variables_have_the_jax_layout(case):
    mine, theirs = case["deploy_keys"]
    assert mine == theirs
    assert case["deploy_bytes"][0] == case["deploy_bytes"][1]


@pytest.mark.parametrize("fused", [False, True])
def test_packed_logits_match_jax(case, fused):
    got, want = case[("packed", fused)]
    assert got.shape == want.shape == (2, 10)
    # criterion 1e-3 of max|JAX logits|; seen: 0.0 for resnet18 and resnet50
    assert _rel(got, want) <= 1e-3


def test_quant_logits_within_the_quantization_noise(case):
    got, want, fp32 = case["quant"]
    noise = np.abs(want - fp32)
    assert np.max(np.abs(got - want)) <= noise.max()
    assert np.mean(np.abs(got - want)) <= noise.mean()


def test_port_slice_checks(case):
    """The checks the GPU smoke run makes, here on the CPU plain versions:
    packed vs the port's own quant simulation, fusion on vs off, bf16
    carry; and CPU tensors never launch a kernel. Seen: 1.6e-2, 0.0 and
    2.6e-2 (ResNet-18), 1.6e-2, 0.0 and 1.8e-2 (ResNet-50)."""
    packed, _ = case[("packed", False)]
    fused, _ = case[("packed", True)]
    sim = case["quant"][0]
    assert _rel(packed, sim) <= 2e-2
    assert _rel(fused, packed) <= 1e-3
    assert _rel(case["packed_bf16"], packed) <= 5e-2
    assert case["launches_unchanged"]


def test_fp32_resnet_with_batchnorm_matches_jax():
    """QuantCtx.fp32(): no quantizers and unfolded inference BatchNorm
    (params + batch_stats) after every conv; float32 convs in another
    summation order, so rtol/atol 1e-4."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    jm = JAX_MODELS.build("resnet18", num_classes=10)
    v = jax.device_get(dict(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), mode="fp32")))
    bs = jax.tree_util.tree_map(lambda a: rng.uniform(0.5, 2.0, size=a.shape).astype(np.float32),
                                v["batch_stats"])
    v = {**v, "batch_stats": bs}
    tm = qtt.MODELS.build("resnet18", num_classes=10, device="cpu")
    convert.from_jax_variables(tm, v)
    assert set(convert.flatten(convert.to_numpy(tm)["batch_stats"])) == set(convert.flatten(bs))
    want = np.asarray(jm.apply(v, jnp.asarray(x), mode="fp32"))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), mode="fp32").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
