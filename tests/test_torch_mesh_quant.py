"""The port's fp32- and quant-mode TestCNN on a ``(data, model)`` mesh of
gloo ranks on the CPU (``tests/_torch_mesh.py``), the counterpart of
``tests/test_parallel.py::test_sharded_quant_sim_forward_matches_local``.

* TestCNN W8A8 (``tests/test_parallel.py``'s config), 8 rows at 16 px,
  JAX's calibrated variables: each rank's logits in fp32 and quant mode
  against JAX's jitted forward over the same variables sharded on the same
  virtual mesh, at ``(2, 1)``, ``(1, 2)`` and ``(2, 2)``, within JAX's
  tolerance (rtol 1e-4, atol 1e-5); the ranks of a ``model`` group give the
  same bits; every conv and dense layer runs on its slice and gathers once.
* The load that used to raise (a slice copied into the whole kernel): the
  port's own quant-mode variables (``qtt.init_model``, then
  ``convert.to_numpy``) on a ``(1, 2)`` mesh.
* ``calibrate`` and ``pack`` run on a split layer (they raised before
  calibration and pack were ported to slices: ``tests/
  test_torch_mesh_calibrate.py`` holds them against JAX); so does
  ``init_adaround`` (it raised before AdaRound was ported to slices), each
  rank's V bit-equal to its slice of one device's V written from the same
  variables (``tests/test_torch_mesh_adaround.py`` holds it against JAX);
  ``gather_variables`` of ``shard_variables`` gives every leaf back bit for
  bit (quant-mode and deploy variables).
* The global masked loss: at ``(2, 1)`` with all of rank 1's labels at -1,
  the loss and gradients equal the one-device step on the whole batch (the
  port's and JAX's, ``tests/_torch_train_parity.py``'s criterion).
* A per-tensor weight quantizer's scale and zero stay whole on a split
  layer; their gradients, each rank's covering its slice, are summed over
  ``model``: the ``(1, 2)`` step equals JAX's one device. Every replicated
  leaf's gradient is bit-equal across the ``model`` group without a sum.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_mesh import flat_tensors, run_jobs
from _torch_train_parity import A8, W8, check_grad, jax_qat_step, quant_cfg
from quantize_tpu.models import MODELS as JAX_MODELS
from quantize_tpu.nn.intercept import QuantCtx as JaxQuantCtx
from quantize_tpu.parallel import make_mesh as jax_make_mesh
from quantize_tpu.parallel import shard_variables as jax_shard_variables
import quantize_tpu_torch as qtt
from quantize_tpu_torch import convert
from quantize_tpu_torch.runners.qat import loss_and_grads

torch.set_num_threads(2)

W8A8 = {"default": {
    "weight": {"n_bits": 8, "symmetric": True, "granularity": "channel",
               "range": {"name": "minmax"}},
    "activation": {"n_bits": 8, "symmetric": False, "granularity": "layer",
                   "range": {"name": "minmax"}},
    "bn_folding": True}}
# the QAT configs' activations (tests/_torch_train_parity.py): the training
# steps run these; with per-tensor weights, one scale and zero a layer,
# whole on every rank
QAT = quant_cfg("testcnn-bnfold", W8, A8)
QAT_LAYER = quant_cfg("testcnn-bnfold", {**W8, "granularity": "layer"}, A8)
# W8A8 with AdaRound's V on every weight quantizer
W8A8_ADA = {"default": {**W8A8["default"],
                        "weight": {**W8A8["default"]["weight"], "adaround": {"apply": True}}}}
CONFIGS = {"w8a8": W8A8, "w8a8_ada": W8A8_ADA, "qat": QAT, "qat_layer": QAT_LAYER}
MESHES = [(2, 1), (1, 2), (2, 2)]
MODES = ("fp32", "quant")
LAYERS = ["conv1", "conv2", "fc1", "fc2"]
LABEL = np.array([1, 7, -1, 3, 0, 5, 2, 6], np.int32)
MASKED = np.array([1, 7, -1, 3, -1, -1, -1, -1], np.int32)  # rank 1's rows all padding


def _jax_variables(cfg):
    model = JAX_MODELS.build("testcnn", num_classes=8, ctx=JaxQuantCtx(cfg))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 16, 16, 3)).astype(np.float32)
    v = dict(model.init(jax.random.PRNGKey(0), jnp.asarray(x), mode="calibrate"))
    v.pop("taps", None)
    _, upd = model.apply(v, jnp.asarray(x), mode="calibrate", mutable=["qobs", "qparams"])
    return model, jax.device_get({**v, **upd}), x


@pytest.fixture(scope="module")
def jax_side():
    """JAX's models, variables and batch by config, and its sharded logits
    by (config, mesh, mode)."""
    out = {name: _jax_variables(cfg) for name, cfg in CONFIGS.items()}
    model, v, x = out["w8a8"]
    fwd = {mode: jax.jit(lambda v, img, mode=mode: model.apply(v, img, mode=mode))
           for mode in MODES}
    logits = {}
    for dp, tp in MESHES:
        mesh = jax_make_mesh(dp=dp, tp=tp)
        vs = jax_shard_variables(mesh, v)
        xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data", None, None, None)))
        for mode in MODES:
            logits[(dp, tp), mode] = np.asarray(fwd[mode](vs, xs))
    return out, logits


def _port(cfg, variables):
    model = qtt.MODELS.build("testcnn", num_classes=8, ctx=qtt.QuantCtx(cfg), device="cpu")
    convert.from_jax_variables(model, variables)
    return model


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    """Every job's reports and saved results on 2 ranks and on 4, and the
    port's one-device references."""
    tmp = tmp_path_factory.mktemp("mesh_quant")
    variables, refs = jax_side[0], {}
    files = {}
    for name, (_, v, x) in variables.items():
        torch.save(flat_tensors(v), tmp / f"{name}.pt")
        files[name] = str(tmp / f"{name}.pt")
    x = variables["w8a8"][2]
    np.save(tmp / "x.npy", x)
    np.save(tmp / "label.npy", LABEL)
    np.save(tmp / "masked.npy", MASKED)
    # the port's own quant-mode variables (the load that used to raise)
    own = qtt.MODELS.build("testcnn", num_classes=8, ctx=qtt.QuantCtx(W8A8), device="cpu")
    qtt.init_model(own, x, seed=0, device="cpu")
    torch.save(flat_tensors(convert.to_numpy(own)), tmp / "own.pt")
    with torch.no_grad():
        refs["own"] = own(torch.from_numpy(x), mode="quant")
    deploy = qtt.pack_model(_port(W8A8, variables["w8a8"][1]), x, device="cpu")
    torch.save(deploy, tmp / "deploy.pt")

    def job(name, mesh, cfg="w8a8", var=None, **what):
        return {"name": name, "mesh": list(mesh),
                "build": {"name": "testcnn", "kw": {"num_classes": 8}}, "cfg": CONFIGS[cfg],
                "variables": var or files[cfg], "x": str(tmp / "x.npy"),
                "out": str(tmp / name), **what}

    two = [job(f"fwd{dp}x{tp}", (dp, tp), forward=list(MODES)) for dp, tp in MESHES[:2]]
    two += [job("own1x2", (1, 2), var=str(tmp / "own.pt"), forward=["quant"]),
            job("modes1x2", (1, 2), cfg="w8a8_ada", modes=True),
            job("round1x2", (1, 2), roundtrip=True),
            job("round_deploy1x2", (1, 2), var=str(tmp / "deploy.pt"), roundtrip=True),
            job("masked2x1", (2, 1), cfg="qat", label=str(tmp / "masked.npy"), step=1e-3),
            job("layer1x2", (1, 2), cfg="qat_layer", label=str(tmp / "label.npy"),
                step=1e-3)]
    four = [job("fwd2x2", (2, 2), forward=list(MODES)),
            job("round2x2", (2, 2), roundtrip=True),
            job("round_deploy2x2", (2, 2), var=str(tmp / "deploy.pt"), roundtrip=True)]
    r2, s2 = run_jobs(2, two, tmp)
    r4, s4 = run_jobs(4, four, tmp)
    return {2: (r2, s2), 4: (r4, s4)}, refs, tmp


def _rank_rows(mesh, rank):
    dp, tp = mesh
    n = 8 // dp
    i = rank // tp
    return slice(i * n, (i + 1) * n)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_forward_matches_jax_sharded(jax_side, ranks, mesh, mode):
    _, logits = jax_side
    world = mesh[0] * mesh[1]
    reports, saved = ranks[0][world]
    name = f"fwd{mesh[0]}x{mesh[1]}"
    want = logits[mesh, mode]
    for rank in range(world):
        got = saved[rank][name][mode].numpy()
        np.testing.assert_allclose(got, want[_rank_rows(mesh, rank)], rtol=1e-4, atol=1e-5,
                                   err_msg=f"rank {rank}")
    for rank in range(world):  # a model group's ranks hold the same bits
        first = rank - rank % mesh[1]
        assert torch.equal(saved[rank][name][mode], saved[first][name][mode])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_split_layers_gather_once(ranks, mesh):
    world = mesh[0] * mesh[1]
    reports, _ = ranks[0][world]
    rep = reports[0][f"fwd{mesh[0]}x{mesh[1]}"]
    if mesh[1] == 1:
        assert rep["split"] == [] and rep["quant"] == {} and rep["load"] == {}
    else:
        assert rep["split"] == LAYERS
        assert rep["quant"] == rep["fp32"] == {"all-gather": len(LAYERS)}
        assert rep["load"] == {}  # every sharded leaf is a split layer's slice


def test_own_quant_variables_load_on_a_model_sharded_mesh(ranks):
    """This load used to raise RuntimeError: a slice copied into the whole
    kernel."""
    (r2, s2), refs = ranks[0][2], ranks[1]
    assert r2[0]["own1x2"]["split"] == LAYERS
    for rank in range(2):
        np.testing.assert_allclose(s2[rank]["own1x2"]["quant"].numpy(), refs["own"].numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_calibrate_and_pack_refuse_a_split_layer(ranks):
    """Calibrate and pack used to raise on a split layer; they now run on
    its slice and write the variables (the name is this test's since
    before)."""
    reports, _ = ranks[0][2]
    for rank in range(2):
        rep = reports[rank]["modes1x2"]
        assert rep["split"] == LAYERS
        assert rep["ran"] == ["calibrate", "pack"]
        assert rep["changed"]


def test_init_adaround_runs_on_a_split_layer(ranks):
    """``init_adaround`` used to raise ValueError on a slice (this test
    asserted that refusal); it now writes the slice's V. Each rank's own V
    equals, bit for bit, its slice of the V one device writes from the same
    variables (the mesh's gathered after calibrate and pack), and the V
    gathered whole equals that V."""
    _, saved = ranks[0][2]
    model = _port(W8A8_ADA, _nest(saved[0]["modes1x2"]["from"]))
    with torch.no_grad():
        model(torch.from_numpy(np.load(ranks[2] / "x.npy")), mode="init_adaround")
    want = convert.flatten(convert.to_numpy(model)["adaround"])
    assert sorted(want) == [f"{layer}/w_quantizer/V" for layer in LAYERS]
    for rank in range(2):
        got = saved[rank]["modes1x2"]
        assert set(got["v"]) == {f"adaround/{k}" for k in want}
        for key, v in want.items():
            whole = got["v"][f"adaround/{key}"].numpy()
            own = got["v_own"][f"adaround/{key}"].numpy()
            n = v.shape[-1] // 2
            np.testing.assert_array_equal(whole, v, err_msg=key)
            np.testing.assert_array_equal(own, v[..., rank * n:(rank + 1) * n], err_msg=key)


def _nest(flat):
    out = {}
    for key, t in flat.items():
        col, rest = key.split("/", 1)
        out.setdefault(col, {})[rest] = t
    return out


@pytest.mark.parametrize("name", ["round1x2", "round_deploy1x2", "round2x2", "round_deploy2x2"])
def test_gather_variables_round_trips(ranks, name):
    world = 4 if name.endswith("2x2") else 2
    reports, _ = ranks[0][world]
    for rank in range(world):
        assert reports[rank][name]["roundtrip"], f"rank {rank}"
        assert reports[rank][name]["roundtrip_leaves"] > 20


def _jax_step(jax_side, cfg, label):
    model, v, x = jax_side[0][cfg]
    return jax_qat_step(model, v, x, label)


def _check_step(got, loss, grads, tag):
    """``got``'s loss and gradients against ``loss`` and ``grads`` (flat
    ``{"collection/path/leaf": array}``)."""
    np.testing.assert_allclose(float(got["loss"]), loss, rtol=1e-5, err_msg=tag)
    for key, a in grads.items():
        g = got["grads"].get(key)
        try:  # check_grad reads the collection from the name
            check_grad(np.zeros_like(a) if g is None else g.numpy(), a, key)
        except AssertionError as exc:
            raise AssertionError(f"{tag}: {exc}") from None


def _flat(grads):
    return {f"{c}/{k}": a for c in grads for k, a in convert.flatten(grads[c]).items()}


def test_masked_loss_across_data_ranks(jax_side, ranks):
    """Rank 1 holds only padding rows: its share of the loss is 0, and the
    valid count summed over ``data`` makes rank 0's the global mean."""
    (reports, saved), _ = ranks[0][2], ranks[1]
    loss_j, _, grads_j = _jax_step(jax_side, "qat", MASKED)
    _, v, x = jax_side[0]["qat"]
    loss_1, _, grads_1 = loss_and_grads(_port(QAT, v), torch.from_numpy(x),
                                        torch.from_numpy(MASKED))
    params_j = {k: a for k, a in _flat(grads_j).items() if k.startswith("params/")}
    for rank in range(2):
        got = saved[rank]["masked2x1"]
        # JAX's qparams gradients sit ~1e-3 from the port's one device here
        # (conv1's activation scale: a sum over the image that nearly
        # cancels, check_grad's docstring); the mesh is held to the port's
        # one device for every leaf, to JAX for the loss and params
        _check_step(got, loss_j, params_j, f"rank {rank} vs JAX")
        _check_step(got, float(loss_1), {k: g.numpy() for k, g in grads_1.items()
                                         if g is not None}, f"rank {rank} vs one device")
        # the valid count's all-reduce, then one of the gradients and the loss
        assert reports[rank]["masked2x1"]["step"] == {"all-reduce": 2}
    for key, g in saved[0]["masked2x1"]["grads"].items():
        assert torch.equal(g, saved[1]["masked2x1"]["grads"][key]), key


def test_per_tensor_weight_quantizer_on_slices(jax_side, ranks):
    (reports, saved), _ = ranks[0][2], ranks[1]
    loss_j, _, grads_j = _jax_step(jax_side, "qat_layer", LABEL)
    for rank in range(2):
        got = saved[rank]["layer1x2"]
        _check_step(got, loss_j, _flat(grads_j), f"rank {rank}")
        assert got["grads"]["qparams/conv2/w_quantizer/scale"].shape == (1,)
    counts = reports[0]["layer1x2"]["step"]
    # a gather a layer; each layer's input gradient and its weight
    # quantizer's scale and zero summed over the model group
    assert counts == {"all-gather": len(LAYERS), "all-reduce": 3 * len(LAYERS)}


def test_replicated_leaves_get_the_same_gradient_on_every_rank(ranks):
    _, saved = ranks[0][2]
    whole = [saved[r]["layer1x2"]["whole_grads"] for r in range(2)]
    assert whole[0].keys() == whole[1].keys()
    assert any(k.endswith("a_quantizer/scale") for k in whole[0])
    for key, g in whole[0].items():
        assert torch.equal(g, whole[1][key]), key
