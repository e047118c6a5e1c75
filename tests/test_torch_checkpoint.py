"""Checkpoints in the port (``quantize_tpu_torch.checkpoint``, the runner's
``load_checkpoint`` of a JAX runner checkpoint, ``utils/msgpack.py``) on the
CPU.

* ``checkpoint.save``/``restore`` round-trip TestCNN W8A8's deploy
  variables (integer planes, scales, correction maps) bit-equal, and the
  restored model's packed logits equal the original's (JAX
  ``tests/test_checkpoint.py``); ``template`` conforms containers and
  dtypes; ``force=False`` refuses an existing file; ``mesh`` places the
  leaves on a one-device mesh and raises the not-ported error for two.
* A checkpoint the JAX runner writes (a pickle of flax msgpack bytes, numpy
  scalars in ``extra``) loads into the port's runner with every variable
  bit-equal, ``extra`` as written.
* The port's msgpack decoder equals ``flax.serialization.msgpack_restore``
  on every wire type flax writes (its ndarray, complex and numpy-scalar
  extensions, chunked arrays), and the checkpoint unpickler refuses any
  global but numpy's scalar and dtype constructors.
"""
import collections
import os
import pickle

import flax.serialization
import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import quantize_tpu.runners as jax_runners
from quantize_tpu.data import DataLoader, make_synthetic
import quantize_tpu_torch as qtt
import quantize_tpu_torch.runners as runners
from quantize_tpu_torch import checkpoint, convert
from quantize_tpu_torch.parallel.mesh import make_mesh
from quantize_tpu_torch.utils import Config
from quantize_tpu_torch.utils import msgpack as port_msgpack

from test_e2e_ptq import base_cfg

torch.set_num_threads(2)

W8A8 = {"default": {
    "weight": {"n_bits": 8, "symmetric": True, "granularity": "channel",
               "range": {"name": "minmax"}},
    "activation": {"n_bits": 8, "symmetric": False, "granularity": "layer",
                   "range": {"name": "minmax"}},
    "bn_folding": True}}


@pytest.fixture(scope="module")
def packed_testcnn():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    model = qtt.MODELS.build("testcnn", num_classes=4, ctx=qtt.QuantCtx(W8A8), device="cpu")
    qtt.init_model(model, x, seed=0, device="cpu")
    deploy = qtt.pack_model(model, x, device="cpu")
    with torch.no_grad():
        ref = model(torch.from_numpy(x), mode="packed")
    return x, deploy, ref


def test_save_restore_round_trips_packed_variables(tmp_path, packed_testcnn):
    x, deploy, ref = packed_testcnn
    path = str(tmp_path / "ckpt" / "deploy.pt")
    checkpoint.save(path, deploy)
    back = checkpoint.restore(path)
    assert set(back) == set(deploy)
    for col, flat in deploy.items():
        assert set(back[col]) == set(flat), col
        for key, t in flat.items():
            assert back[col][key].dtype == t.dtype and torch.equal(back[col][key], t), key
    fresh = qtt.MODELS.build("testcnn", num_classes=4, ctx=qtt.QuantCtx(W8A8), device="cpu")
    convert.from_jax_variables(fresh, back)
    with torch.no_grad():
        assert torch.equal(fresh(torch.from_numpy(x), mode="packed"), ref)


def test_restore_conforms_to_the_template(tmp_path, packed_testcnn):
    _, deploy, _ = packed_testcnn
    path = str(tmp_path / "deploy.pt")
    checkpoint.save(path, {"packed": deploy["packed"]})
    nested = convert.unflatten({f"packed/{k}": v for k, v in deploy["packed"].items()})
    template = {"packed": {k: (v.double() if v.is_floating_point() else v.numpy())
                           for k, v in convert.flatten(nested["packed"]).items()}}
    template["packed"] = convert.unflatten(template["packed"])
    back = checkpoint.restore(path, template=template)
    flat = convert.flatten(back)
    assert set(flat) == {f"packed/{k}" for k in deploy["packed"]}
    assert isinstance(back["packed"], dict) and all("/" not in k for k in back["packed"])
    for key, t in deploy["packed"].items():
        got = flat[f"packed/{key}"]
        assert got.dtype == (torch.float64 if t.is_floating_point() else t.dtype), key
        assert torch.equal(got, t.to(got.dtype)), key
    with pytest.raises(KeyError, match="no leaf"):
        checkpoint.restore(path, template={"packed": {"missing": np.zeros(1)}})


def test_save_without_force_and_restore_onto_a_mesh(tmp_path, packed_testcnn):
    _, deploy, _ = packed_testcnn
    path = str(tmp_path / "deploy.pt")
    checkpoint.save(path, deploy)
    with pytest.raises(FileExistsError):
        checkpoint.save(path, deploy, force=False)
    checkpoint.save(path, deploy, force=True)
    # onto a one-device mesh: every leaf on its device, bit-equal
    back = checkpoint.restore(path, mesh=make_mesh(1, 1, devices=[torch.device("cpu")]))
    for col, flat in deploy.items():
        for key, t in flat.items():
            assert back[col][key].device.type == "cpu" and torch.equal(back[col][key], t), key
    with pytest.raises(NotImplementedError, match="mesh.*queue 1 item 6"):
        checkpoint.restore(path, mesh=make_mesh(2, 1, devices=["cpu", "cpu"]))


def test_jax_runner_checkpoint_loads_bit_equal(tmp_path):
    cfg = base_cfg(tmp_path)
    loader = DataLoader(make_synthetic(n=64, image_size=16, num_classes=10), batch_size=32)
    jr = jax_runners.build_runner(cfg, loader, None, None)
    batch = next(iter(loader))
    jr.init_variables(batch, seed=0)
    jr.train_step(batch, 0, 0, 1)
    extra = {"epoch": np.int64(3), "eval": {"top1": np.float32(12.5), "n": 64}, "tag": "x"}
    path = str(tmp_path / "jax_ckpt.pkl")
    jr.save_checkpoint(path, extra=extra)
    port = runners.build_runner(Config(base_cfg(tmp_path).to_dict()), device="cpu")
    got_extra = port.load_checkpoint(path)
    assert got_extra == extra and type(got_extra["epoch"]) is np.int64
    want = convert.flatten(jax.device_get(jr.variables))
    mine = {f"{col}/{k}": t for col, flat in port.variables.items() for k, t in flat.items()}
    assert set(mine) == set(want) and {"params", "qparams", "qobs"} <= set(port.variables)
    for key, val in want.items():
        got = mine[key].detach().numpy()
        assert got.dtype == np.asarray(val).dtype, key
        np.testing.assert_array_equal(got, val, err_msg=key)


def _same(mine, theirs):
    if isinstance(theirs, dict):
        assert isinstance(mine, dict) and list(mine) == list(theirs)
        for k in theirs:
            _same(mine[k], theirs[k])
    elif isinstance(theirs, (list, tuple)):
        assert isinstance(mine, list) and len(mine) == len(theirs)
        for a, b in zip(mine, theirs):
            _same(a, b)
    elif isinstance(theirs, np.ndarray) and theirs.dtype == ml_dtypes.bfloat16:
        assert mine.dtype == torch.bfloat16 and tuple(mine.shape) == theirs.shape
        np.testing.assert_array_equal(mine.float().numpy(), theirs.astype(np.float32))
    elif isinstance(theirs, (np.ndarray, np.generic)):
        assert type(mine) is type(theirs) and mine.dtype == theirs.dtype
        np.testing.assert_array_equal(mine, theirs)
    else:
        assert type(mine) is type(theirs) and mine == theirs


def test_msgpack_decoder_matches_flax(monkeypatch):
    rng = np.random.default_rng(3)
    tree = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63 - 1,
                 -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63],
        "floats": [0.0, -1.5, 3.25e300, float("inf")], "flags": [True, False, None],
        "text": ["", "a" * 31, "b" * 32, "c" * 300, "d" * 70000, "é"],
        "blobs": [b"", b"z" * 300, b"y" * 70000], "complex": 1.5 - 2j,
        "scalars": {"i64": np.int64(-7), "f32": np.float32(0.1), "u8": np.uint8(200)},
        "arrays": {str(dt): rng.normal(size=(3, 5)).astype(dt) for dt in
                   ("float32", "float64", "float16", "int8", "uint8", "int16", "int32",
                    "int64", "uint32", "bool")},
        "bf16": rng.normal(size=(4, 2)).astype(ml_dtypes.bfloat16),
        "empty": np.zeros((0, 3), np.float32), "zero_d": np.asarray(5, np.int32),
        "wide": {f"k{i}": i for i in range(20)}, "long": list(range(20)),
    }
    data = flax.serialization.msgpack_serialize(tree)
    _same(port_msgpack.msgpack_restore(data), flax.serialization.msgpack_restore(data))
    # arrays above flax's chunk size are split into chunks and joined back
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    big = {"w": rng.normal(size=(7, 9)).astype(np.float32), "n": {"b": np.arange(50)}}
    data = flax.serialization.msgpack_serialize(big)
    assert b"__msgpack_chunked_array__" in data
    _same(port_msgpack.msgpack_restore(data), flax.serialization.msgpack_restore(data))
    with pytest.raises(ValueError, match="extra bytes"):
        port_msgpack.msgpack_restore(data + b"\x00")


@pytest.mark.parametrize("payload", [collections.OrderedDict(a=1), os.getcwd, print])
def test_checkpoint_unpickler_refuses_other_globals(tmp_path, payload):
    path = tmp_path / "evil.pkl"
    with open(path, "wb") as f:
        pickle.dump({"variables": flax.serialization.msgpack_serialize({}),
                     "extra": {"x": payload}}, f)
    with pytest.raises(pickle.UnpicklingError, match="is not allowed"):
        port_msgpack.load_jax_checkpoint(str(path))
    port = runners.build_runner(Config(base_cfg(tmp_path).to_dict()), device="cpu")
    with pytest.raises(pickle.UnpicklingError):
        port.load_checkpoint(str(path))
