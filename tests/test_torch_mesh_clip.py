"""Sharded CLIP zero-shot packed inference in the port, on gloo ranks on the
CPU (``tests/_torch_mesh.py``): the counterpart of
``tests/test_parallel.py::test_sharded_clip_zeroshot_packed_matches_local``
in its tiny configuration (ViT-B/16's layout: embedding 32, image tower 64
wide and 2 layers, patch 8 at 32 px; 8 classes from ``HashTokenizer(64)``
through JAX's quantized text tower).

JAX's packed deploy variables load into the port at ``(2, 1)`` and
``(1, 2)``: ``zeroshot/weights`` and ``proj`` stay whole (JAX's rules leave
them whole), the image tower's MLPs (``c_fc``, ``c_proj``) and its patch
conv split, the attention projections run whole (K8 reads the fused q/k/v).
Each rank's logits are bit-equal to the port's one device on its rows (the
split is exact per channel); against JAX's sharded logits on the same
virtual mesh, the argmax is equal and every logit within 3% of the span
(JAX's own test's tolerance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_mesh import flat_tensors, run_jobs
from quantize_tpu.deploy import pack_model as jax_pack_model
from quantize_tpu.models.clip import CLIPZeroShot as JZeroShot
from quantize_tpu.models.clip import HashTokenizer as JHashTokenizer
from quantize_tpu.models.clip import build_zeroshot as jax_build_zeroshot
from quantize_tpu.nn.intercept import QuantCtx as JaxQuantCtx
from quantize_tpu.parallel import make_mesh as jax_make_mesh
from quantize_tpu.parallel import shard_variables as jax_shard_variables
import quantize_tpu_torch as qtt
from quantize_tpu_torch import convert
from quantize_tpu_torch.models.clip import CLIPZeroShot

torch.set_num_threads(2)

W8A8 = {"default": {
    "weight": {"n_bits": 8, "symmetric": True, "granularity": "channel",
               "range": {"name": "minmax"}},
    "activation": {"n_bits": 8, "symmetric": False, "granularity": "layer",
                   "range": {"name": "minmax"}},
    "bn_folding": True}}
TINY = dict(embed_dim=32, vision_layers=2, vision_width=64, vision_patch_size=8,
            context_length=16, vocab_size=64, transformer_width=32, transformer_heads=2,
            transformer_layers=2)
MESHES = [(2, 1), (1, 2)]
# the image tower's layers on a slice at (1, 2): the patch conv and each
# block's two MLP layers; the text tower's MLPs hold float kernels (the
# pack leaves that tower unpacked), split too, and run no packed forward
IMAGE_SPLIT = ["clip.visual.conv1"] + [f"clip.visual.transformer.resblock_{i}.{name}"
                                       for i in range(2) for name in ("c_fc", "c_proj")]
TEXT_SPLIT = [f"clip.transformer.resblock_{i}.{name}" for i in range(2)
              for name in ("c_fc", "c_proj")]


@pytest.fixture(scope="module")
def jax_clip():
    """JAX's packed tiny CLIP: deploy variables, the batch, and its logits
    sharded over each mesh."""
    clip = JZeroShot(backbone="ViT-B/16", num_classes=8, ctx=JaxQuantCtx(W8A8),
                     config_overrides=TINY)
    x = np.random.default_rng(3).normal(size=(8, 32, 32, 3)).astype(np.float32)
    cv = dict(clip.init(jax.random.PRNGKey(0), jnp.asarray(x), mode="calibrate"))
    cv.pop("taps", None)
    _, upd = clip.apply(cv, jnp.asarray(x), mode="calibrate", mutable=["qobs", "qparams"])
    cv = {**cv, **upd}
    tok = JHashTokenizer(64)
    names = [f"class{i}" for i in range(8)]
    cv = jax_build_zeroshot(clip, cv, names, tokenizer=tok, mode="calibrate")
    cv = jax_build_zeroshot(clip, cv, names, tokenizer=tok, mode="quant")
    deploy = jax_pack_model(clip, cv, jnp.asarray(x))
    fwd = jax.jit(lambda v, img: clip.apply(v, img, mode="packed"))
    logits = {}
    for dp, tp in MESHES:
        mesh = jax_make_mesh(dp=dp, tp=tp)
        xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data", None, None, None)))
        logits[dp, tp] = np.asarray(fwd(jax_shard_variables(mesh, deploy), xs), np.float32)
    return jax.device_get(deploy), x, logits


@pytest.fixture(scope="module")
def port_clip(jax_clip, tmp_path_factory):
    """The port's one-device logits, and the ranks' reports and logits."""
    deploy, x, _ = jax_clip
    tmp = tmp_path_factory.mktemp("mesh_clip")
    kw = {"backbone": "ViT-B/16", "num_classes": 8, "config_overrides": TINY,
          "image_size": 32}
    model = CLIPZeroShot(ctx=qtt.QuantCtx(W8A8), device="cpu", **kw)
    convert.from_jax_variables(model, deploy)
    with torch.inference_mode():
        one = model(torch.from_numpy(x), mode="packed").float()
    torch.save(flat_tensors(deploy), tmp / "deploy.pt")
    np.save(tmp / "x.npy", x)
    jobs = [{"name": f"clip{dp}x{tp}", "mesh": [dp, tp], "build": {"name": "clip", "kw": kw},
             "cfg": W8A8, "variables": str(tmp / "deploy.pt"), "x": str(tmp / "x.npy"),
             "forward": ["packed"], "out": str(tmp / f"clip{dp}x{tp}")} for dp, tp in MESHES]
    reports, saved = run_jobs(2, jobs, tmp)
    return one, reports, saved


def _rows(mesh, rank):
    dp, tp = mesh
    n = 8 // dp
    return slice(rank // tp * n, (rank // tp + 1) * n)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_ranks_bit_equal_to_one_device(port_clip, mesh):
    one, _, saved = port_clip
    for rank in range(2):
        got = saved[rank][f"clip{mesh[0]}x{mesh[1]}"]["packed"]
        assert torch.equal(got, one[_rows(mesh, rank)]), f"rank {rank}"


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_ranks_match_jax_sharded(jax_clip, port_clip, mesh):
    _, _, logits = jax_clip
    _, _, saved = port_clip
    want = logits[mesh]
    span = np.abs(want).max()
    for rank in range(2):
        got = saved[rank][f"clip{mesh[0]}x{mesh[1]}"]["packed"].numpy()
        ref = want[_rows(mesh, rank)]
        assert (got.argmax(-1) == ref.argmax(-1)).all(), f"rank {rank}"
        assert np.abs(got - ref).max() <= 0.03 * span, (rank, np.abs(got - ref).max(), span)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_which_layers_split_and_gather(port_clip, mesh):
    _, reports, _ = port_clip
    rep = reports[0][f"clip{mesh[0]}x{mesh[1]}"]
    if mesh[1] == 1:
        assert rep["split"] == [] and rep["packed"] == {} and rep["load"] == {}
        return
    assert rep["split"] == sorted(IMAGE_SPLIT + TEXT_SPLIT)
    assert rep["packed"] == {"all-gather": len(IMAGE_SPLIT)}
    # the attention projections' and the LayerNorms' sharded leaves gathered
    # whole at load; zeroshot/weights (JAX's rules replicate it) needs none
    assert rep["load"]["all-gather"] > 0
