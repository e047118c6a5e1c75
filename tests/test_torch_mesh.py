"""The port's mesh and sharding rules (``quantize_tpu_torch.parallel.mesh``)
on the CPU against the JAX package's ``quantize_tpu.parallel.mesh``.

* ``spec_for_variables`` of the port's packed ResNet-18 W8A8 and ViT W4A8
  deploy variables (the port's flat layout) equals JAX's
  ``PartitionSpec``s, as tuples, of JAX's deploy of the same model (its
  shapes by ``jax.eval_shape``) at tp 1, 2, 3 and 4, and so does the
  port's spec of JAX's nested deploy.
* ``make_mesh`` has JAX's axis names and shape; ``shard_variables`` and
  ``shard_batch`` place every leaf on a one-device mesh, bit-equal; a mesh
  of two devices raises the not-ported error (queue 1 item 6), and so
  does a mesh larger than the devices given.
* ``checkpoint.restore`` onto a one-device mesh.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantize_tpu.deploy import pack_model as jax_pack_model
from quantize_tpu.models import MODELS as JAX_MODELS
from quantize_tpu.models.vit import VisionTransformer as JViT
from quantize_tpu.nn.intercept import QuantCtx as JaxQuantCtx
from quantize_tpu.parallel import make_mesh as jax_make_mesh
from quantize_tpu.parallel import spec_for_variables as jax_spec_for_variables
import quantize_tpu_torch as qtt
from quantize_tpu_torch import checkpoint, convert
from quantize_tpu_torch.models.vit import VisionTransformer
from quantize_tpu_torch.parallel import (make_mesh, shard_batch, shard_variables,
                                         spec_for_variables)

torch.set_num_threads(2)
CPU = torch.device("cpu")
ACT = {"n_bits": 8, "symmetric": False, "granularity": "layer", "range": {"name": "minmax"}}
W8A8 = {"default": {"weight": {"n_bits": 8, "symmetric": True, "granularity": "channel",
                               "range": {"name": "minmax"}}, "activation": ACT,
                    "bn_folding": True}}
W4A8 = {"default": {"weight": {"n_bits": 4, "symmetric": True, "signed": True,
                               "granularity": "channel", "range": {"name": "minmax"}},
                    "activation": ACT, "bn_folding": True}}
MODELS = {  # name: (JAX constructor, the port's, quant config, keywords)
    "resnet18": (lambda **kw: JAX_MODELS.build("resnet18", **kw),
                 lambda **kw: qtt.MODELS.build("resnet18", **kw), W8A8, dict(num_classes=10)),
    "vit": (JViT, VisionTransformer, W4A8,
            dict(num_classes=5, image_size=32, patch_size=8, num_layers=2, num_heads=2,
                 hidden_dim=48, mlp_dim=96)),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def deploys(request):
    """(the port's deploy variables, JAX's deploy as shapes) of one model."""
    jax_ctor, port_ctor, cfg, kw = MODELS[request.param]
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32)
    jm = jax_ctor(ctx=JaxQuantCtx(cfg), **kw)

    def pack(key, xs):
        v = dict(jm.init(key, xs, mode="calibrate"))
        v.pop("taps", None)
        return jax_pack_model(jm, v, xs)

    jax_deploy = jax.eval_shape(pack, jax.random.PRNGKey(0), jnp.asarray(x))
    tm = port_ctor(ctx=qtt.QuantCtx(cfg), device="cpu", **kw)
    qtt.init_model(tm, x, seed=0, device="cpu")
    return qtt.pack_model(tm, x, device="cpu"), jax_deploy


@pytest.mark.parametrize("tp", [1, 2, 3, 4])
def test_spec_for_variables_matches_jax(deploys, tp):
    port_deploy, jax_deploy = deploys
    is_spec = lambda s: isinstance(s, jax.sharding.PartitionSpec)  # noqa: E731
    want = {col: {k: tuple(v) for k, v in convert.flatten(tree).items()}
            for col, tree in jax.tree.map(tuple, jax_spec_for_variables(jax_deploy, tp),
                                          is_leaf=is_spec).items()}
    got = spec_for_variables(port_deploy, tp)
    assert set(got) == set(want)
    for col in want:
        assert got[col] == want[col], col
    # the port's rules on JAX's nested layout give the same tree
    nested = spec_for_variables(jax_deploy, tp)
    assert {col: convert.flatten(tree) for col, tree in nested.items()} == want
    if tp in (2, 4):  # the packed weights split on their out channels
        assert any("model" in spec for spec in got["packed"].values())


def test_mesh_axes_and_placement_on_one_device():
    mesh = make_mesh(1, 1, devices=[CPU])
    jmesh = jax_make_mesh(1, 1)
    assert mesh.axis_names == tuple(jmesh.axis_names)
    assert mesh.shape == dict(jmesh.shape) == {"data": 1, "model": 1}
    assert mesh.device == CPU and mesh.size == 1
    variables = {"packed": {"fc/w_int": np.arange(6, dtype=np.int8).reshape(2, 3)},
                 "params": {"fc": {"bias": torch.ones(3)}}}
    placed = shard_variables(mesh, variables)
    assert placed["packed"]["fc/w_int"].dtype == torch.int8
    assert torch.equal(placed["packed"]["fc/w_int"], torch.arange(6, dtype=torch.int8).view(2, 3))
    assert torch.equal(placed["params"]["fc"]["bias"], torch.ones(3))
    batch = shard_batch(mesh, {"img": np.zeros((4, 2, 2, 3), np.float32),
                               "label": np.arange(4, dtype=np.int32)})
    assert batch["img"].shape == (4, 2, 2, 3) and batch["label"].dtype == torch.int32


def test_a_mesh_of_two_devices_is_not_ported():
    mesh = make_mesh(2, 1, devices=[CPU, CPU])
    assert mesh.shape == {"data": 2, "model": 1} and mesh.size == 2
    for call in (lambda: shard_variables(mesh, {"params": {"w": np.ones(2)}}),
                 lambda: shard_batch(mesh, {"img": np.ones((2, 1))}),
                 lambda: mesh.device):
        with pytest.raises(NotImplementedError, match="more than one device.*queue 1 item 6"):
            call()
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        make_mesh(1, 2, devices=[CPU])


def test_checkpoint_restores_onto_a_one_device_mesh(tmp_path, deploys):
    port_deploy, _ = deploys
    path = str(tmp_path / "deploy.pt")
    checkpoint.save(path, port_deploy)
    back = checkpoint.restore(path, mesh=make_mesh(1, 1, devices=[CPU]))
    assert set(back) == set(port_deploy)
    for col, flat in port_deploy.items():
        for key, t in flat.items():
            assert back[col][key].device == CPU and torch.equal(back[col][key], t), key
