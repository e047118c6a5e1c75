"""The int8 carry between blocks (``qin_carry``) on the ResNets, held
against the JAX package on the CPU (batch 2, 32 x 32, 10 classes, W8A8 with
BN folded): ResNet-18 (basic blocks) and a narrow bottleneck ResNet (stages
of 2, 1, 1 and 1 blocks, 16 channels a group, a stride-1 downsample in
stage 1), through ``tests/_torch_parity.py``'s ``run_carry``.

Both packages pack from the same calibrated variables and serve the same
input under the carry, at f32 and bf16 carry, with the fused residual tail
on and off: the port's logits within 1e-3 of max|logits| of eager JAX's
(``test_torch_resnet.py``'s criterion). Against the port's own float
carry: within JAX's 8e-2 bound with the same argmax; quant mode bit-equal
with the flag on and off.
"""
import numpy as np
import pytest
import torch

from quantize_tpu.models.resnet import ResNet as JaxResNet
from quantize_tpu.models import MODELS as JAX_MODELS
import quantize_tpu_torch as qtt
from quantize_tpu_torch.models.resnet import ResNet as PortResNet

from _torch_parity import CARRIES, check_carry, check_carry_vs_float_skip, run_carry

torch.set_num_threads(2)

CFG = {"default": {
    "weight": {"n_bits": 8, "symmetric": True, "signed": True, "granularity": "channel",
               "range": {"name": "minmax"}},
    "activation": {"n_bits": 8, "symmetric": False, "signed": False, "granularity": "layer",
                   "range": {"name": "minmax"}},
    "bn_folding": True}}
BOTTLENECK = dict(stage_sizes=(2, 1, 1, 1), bottleneck=True, width_per_group=16)
MODELS = {
    "resnet18": (lambda **a: JAX_MODELS.build("resnet18", **a),
                 lambda **a: qtt.MODELS.build("resnet18", **a)),
    "resnet_bottleneck": (lambda **a: JaxResNet(**BOTTLENECK, **a),
                          lambda **a: PortResNet(**BOTTLENECK, **a)),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def case(request):
    rng = np.random.default_rng(40)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    x_cal = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    return run_carry(*MODELS[request.param], CFG, x, x_cal, fused_opts=(False, True))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("carry", sorted(CARRIES))
def test_resnet_carry_packed_logits_match_jax(case, carry, fused):
    check_carry(case, carry, fused, "resnet")
    assert case[("grouped", carry, fused)] == 0


def test_resnet_carry_against_the_float_skip(case):
    check_carry_vs_float_skip(case)
