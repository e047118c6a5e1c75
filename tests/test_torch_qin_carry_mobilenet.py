"""The int8 carry between blocks (``qin_carry``) on the MobileNets, held
against the JAX package on the CPU (batch 2, 32 x 32, 10 classes, W8A8 with
BN folded), through ``tests/_torch_parity.py``'s ``run_carry``:
MobileNetV2 at ``width_mult`` 0.25 (expand-first residual blocks, and a
first block without an expand conv that at this width has a residual: its
depthwise conv carries the int8 input) and MobileNetV3-Large cut to 7 of
its 15 blocks at full width (blocks 1-5, 7 and 8: the no-expand residual
first block, expand-first residual blocks with and without squeeze-excite,
hard-swish blocks; both packages' block list patched for the test).

A depthwise conv that carries its int8 input leaves the float path for the
grouped int8 kernel K3g (JAX ``layers.py:454``): one K3g call a forward in
each. The tolerance is each model's packed-parity test's: MobileNetV2
bit-equal to eager JAX (``test_torch_mobilenet.py``), MobileNetV3 within
the network's quantization noise with the same argmax against jitted JAX
(``test_torch_mobilenet_v3.py``), at f32 and bf16 carry.
"""
import numpy as np
import pytest
import torch

import quantize_tpu.models.mobilenet as jax_mobilenet
from quantize_tpu.models import MODELS as JAX_MODELS
import quantize_tpu_torch as qtt
import quantize_tpu_torch.models.mobilenet as port_mobilenet

from _torch_parity import CARRIES, check_carry, check_carry_vs_float_skip, run_carry

torch.set_num_threads(2)

CFG = {"default": {
    "weight": {"n_bits": 8, "symmetric": True, "signed": True, "granularity": "channel",
               "range": {"name": "minmax"}},
    "activation": {"n_bits": 8, "symmetric": False, "signed": False, "granularity": "layer",
                   "range": {"name": "minmax"}},
    "bn_folding": True}}
V3_CUT = [jax_mobilenet._V3_LARGE[i] for i in (0, 1, 2, 3, 4, 6, 7)]
# name: (constructor keywords, logits tolerance, JAX packed under jit)
MODELS = {"mobilenet_v2": ({"width_mult": 0.25}, "exact", False),
          "mobilenet_v3_large": ({}, "noise", True)}


@pytest.fixture(scope="module", params=sorted(MODELS))
def case(request):
    name = request.param
    kw, logits, jit_packed = MODELS[name]
    rng = np.random.default_rng(40)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    x_cal = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_mobilenet, "_V3_LARGE", V3_CUT)
        mp.setattr(port_mobilenet, "_V3_LARGE", V3_CUT)
        out = run_carry(lambda **a: JAX_MODELS.build(name, **a, **kw),
                        lambda **a: qtt.MODELS.build(name, **a, **kw), CFG, x, x_cal,
                        jit_packed=jit_packed)
    out["logits"] = logits
    return out


@pytest.mark.parametrize("carry", sorted(CARRIES))
def test_mobilenet_carry_packed_logits_match_jax(case, carry):
    check_carry(case, carry, False, case["logits"])
    assert case[("grouped", carry, False)] == 1


def test_mobilenet_carry_against_the_float_skip(case):
    check_carry_vs_float_skip(case)
