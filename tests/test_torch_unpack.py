"""``deploy.unpack_model`` in the port, held against the JAX package on the
CPU: TestCNN W4A8 (conv1's 3 input channels keep ``w_int``, conv2 packs
int4 pairs ``w_p4c``, the dense layers split-half int4 ``w_p4``) and W8
weight-only (``w_int`` throughout, ``tests/test_packed.py``'s round trip).

* The port's ``unpack_model`` of JAX's deploy variables equals JAX's
  ``unpack_model`` bit for bit, leaf by leaf.
* Round trip (JAX ``test_packed.py:195-215``): the port packs, unpacks,
  loads the result into a fresh model with ``convert.from_jax_variables``
  and runs it; its fp32 logits are within 2e-3 (rtol and atol) of the
  original quant mode's, and so are the restored model's quant-mode
  logits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantize_tpu.deploy import pack_model as jax_pack_model
from quantize_tpu.deploy import unpack_model as jax_unpack_model
from quantize_tpu.models import MODELS as JAX_MODELS
from quantize_tpu.nn.intercept import QuantCtx as JaxQuantCtx
import quantize_tpu_torch as qtt
from quantize_tpu_torch import convert

torch.set_num_threads(2)


def _weight(bits):
    return {"n_bits": bits, "symmetric": True, "granularity": "channel",
            "range": {"name": "minmax"}}


A8 = {"n_bits": 8, "symmetric": False, "granularity": "layer", "range": {"name": "minmax"}}
CFGS = {"w4a8": {"default": {"weight": _weight(4), "activation": A8, "bn_folding": True}},
        "w8_weight_only": {"default": {"weight": _weight(8), "activation": {"n_bits": 32},
                                       "bn_folding": True}}}


@pytest.fixture(scope="module", params=sorted(CFGS))
def case(request):
    cfg = CFGS[request.param]
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    xj = jnp.asarray(x)
    jm = JAX_MODELS.build("testcnn", num_classes=4, ctx=JaxQuantCtx(cfg))
    v0 = dict(jm.init(jax.random.PRNGKey(0), xj, mode="calibrate"))
    v0.pop("taps", None)
    _, upd = jm.apply(v0, xj, mode="calibrate", mutable=["qobs", "qparams"])
    v1 = jax.device_get({**v0, **upd})
    deploy = jax.device_get(jax_pack_model(jm, v1, xj))
    out = {"name": request.param, "jax_deploy": deploy,
           "jax_unpacked": jax.device_get(jax_unpack_model(deploy))}

    tm = qtt.MODELS.build("testcnn", num_classes=4, ctx=qtt.QuantCtx(cfg), device="cpu")
    convert.from_jax_variables(tm, v1)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        out["sim"] = tm(xt, mode="quant").numpy()
        restored = qtt.unpack_model(qtt.pack_model(tm, x, device="cpu"))
        fresh = qtt.MODELS.build("testcnn", num_classes=4, ctx=qtt.QuantCtx(cfg), device="cpu")
        convert.from_jax_variables(fresh, restored)
        out["restored"] = {mode: fresh(xt, mode=mode).numpy() for mode in ("fp32", "quant")}
    return out


def test_unpack_model_equals_jax_bit_for_bit(case):
    deploy = case["jax_deploy"]
    packed = convert.flatten(deploy["packed"])
    kinds = {k.rsplit("/", 1)[1] for k in packed if k.endswith(("w_int", "w_p4", "w_p4c"))}
    assert kinds == ({"w_int", "w_p4", "w_p4c"} if case["name"] == "w4a8" else {"w_int"})
    mine = qtt.unpack_model(deploy)
    theirs = case["jax_unpacked"]
    assert set(mine) == set(theirs)
    for col, tree in theirs.items():
        want = convert.flatten(tree)
        assert set(mine[col]) == set(want), col
        for key, val in want.items():
            got = mine[col][key].numpy()
            assert got.dtype == np.asarray(val).dtype, key
            np.testing.assert_array_equal(got, val, err_msg=f"{col}/{key}")


def test_unpack_model_round_trip(case):
    # the int weights are the simulated weights: unpacked, the fp32 forward
    # is the quant simulation up to the activation quantize (none at W8
    # weight-only), within JAX's 2e-3
    sim = case["sim"]
    if case["name"] == "w8_weight_only":
        np.testing.assert_allclose(case["restored"]["fp32"], sim, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(case["restored"]["quant"], sim, rtol=2e-3, atol=2e-3)
