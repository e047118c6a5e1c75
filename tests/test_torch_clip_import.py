"""The CLIP and torchvision-ViT checkpoint importers, held against the JAX
package's on the CPU.

Each state dict is written by the test from a seeded generator
(``chip_smoke.clip_state_dict`` for the OpenAI CLIP layout: a ViT image
tower, a ModifiedResNet image tower with its BatchNorms, the causal text
tower; a torchvision ``vit_b_16`` layout at width 32 with its 12 layers).
The same dict goes through JAX's importer (``import_torch_checkpoint``)
into the JAX model's (abstract) variables and through the port's
``import_into_model``: the trees must be equal bit for bit, ``params`` and
``batch_stats`` (the RN tower with BN folded and unfolded), and both
packages' fp32 outputs on the imported weights (the zero-shot logits for
CLIP, the classifier logits for the ViT) within 1e-5 of max|out|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from quantize_tpu.models import import_auto as jax_import_auto
from quantize_tpu.models.clip import CLIPZeroShot as JZeroShot
from quantize_tpu.models.clip import build_zeroshot as jax_build_zeroshot
from quantize_tpu.models.clip.tokenizer import HashTokenizer as JHashTokenizer
from quantize_tpu.models.vit import VisionTransformer as JViT
from quantize_tpu.nn.intercept import QuantCtx as JaxQuantCtx
import quantize_tpu_torch as qtt
from quantize_tpu_torch import convert
from quantize_tpu_torch.models import import_auto
from quantize_tpu_torch.models.clip import CLIPZeroShot, HashTokenizer, build_zeroshot
from quantize_tpu_torch.models.manifest import sha256_of, verify_checkpoint
from quantize_tpu_torch.models.vit import VisionTransformer

torch.set_num_threads(2)

TINY_VIT = dict(embed_dim=32, vision_layers=2, vision_width=64, vision_patch_size=8,
                context_length=16, vocab_size=64, transformer_width=32,
                transformer_heads=2, transformer_layers=2)
TINY_RN = dict(embed_dim=32, vision_layers=(1, 2, 1, 1), vision_width=8,
               vision_patch_size=0, context_length=16, vocab_size=64,
               transformer_width=32, transformer_heads=2, transformer_layers=1)
# (model name, overrides, image side)
CLIPS = {"clip_vit-b16": (TINY_VIT, 32), "clip_rn50": (TINY_RN, 64)}
VIT_KW = dict(image_size=32, patch_size=8, num_layers=12, num_heads=2, hidden_dim=32,
              mlp_dim=64, num_classes=10)


def _fp32(fold):
    return {"default": {"weight": {"n_bits": 32}, "activation": {"n_bits": 32},
                        "bn_folding": fold}}


def _abstract(jm, x):
    tree = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, mode="calibrate"))
    return jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                  {k: v for k, v in dict(tree).items() if k != "taps"})


def _numpy_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _assert_trees_equal(mine, theirs, cols=("params", "batch_stats")):
    # JAX's CLIP importer leaves empty batch_stats nodes where BN folds
    for col in cols:
        m, t = convert.flatten(mine.get(col, {})), convert.flatten(theirs.get(col, {}))
        assert set(m) == set(t), col
        for key, val in t.items():
            np.testing.assert_array_equal(m[key], val, err_msg=f"{col}/{key}")


@pytest.mark.parametrize("name,fold", [("clip_vit-b16", True), ("clip_rn50", True),
                                       ("clip_rn50", False)])
def test_clip_importer_gives_jax_variables_and_outputs(name, fold):
    overrides, side = CLIPS[name]
    backbone = "ViT-B/16" if name == "clip_vit-b16" else "RN50"
    sd = chip_smoke.clip_state_dict({**overrides}, side, seed=16)
    jm = JZeroShot(backbone=backbone, num_classes=3, ctx=JaxQuantCtx(_fp32(fold)),
                   config_overrides=overrides)
    x = np.random.default_rng(1).normal(size=(2, side, side, 3)).astype(np.float32)
    theirs = jax_import_auto.import_torch_checkpoint(name, _numpy_sd(sd),
                                                     _abstract(jm, jnp.asarray(x)), fold_bn=fold)
    model = qtt.MODELS.build(name, num_classes=3, ctx=qtt.QuantCtx(_fp32(fold)),
                             config_overrides=overrides, image_size=side, device="cpu")
    import_auto.import_into_model(model, name, sd, fold_bn=fold)
    _assert_trees_equal(convert.to_numpy(model), theirs)
    scale = float(model.clip.get_var("params", "logit_scale").detach())
    assert scale == pytest.approx(np.log(1 / 0.07))

    theirs = jax_build_zeroshot(jm, theirs, ["cat", "dog", "bird"], tokenizer=JHashTokenizer(64))
    build_zeroshot(model, ["cat", "dog", "bird"], tokenizer=HashTokenizer(64))
    want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, mode="fp32"))(theirs, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), mode="fp32").numpy()
    assert got.shape == want.shape == (2, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_torchvision_vit_importer_gives_jax_variables_and_outputs():
    g = torch.Generator().manual_seed(32)
    h, s = VIT_KW["hidden_dim"], (32 // 8) ** 2 + 1

    def normal(shape, std):
        return torch.randn(shape, generator=g) * std

    sd = {"conv_proj.weight": normal((h, 3, 8, 8), (3 * 64) ** -0.5),
          "conv_proj.bias": normal((h,), 0.01), "class_token": normal((1, 1, h), 0.02),
          "encoder.pos_embedding": normal((1, s, h), 0.02),
          "encoder.ln.weight": 1 + normal((h,), 0.1), "encoder.ln.bias": normal((h,), 0.1),
          "heads.head.weight": normal((10, h), h ** -0.5), "heads.head.bias": normal((10,), 0.01)}
    for i in range(12):
        p = f"encoder.layers.encoder_layer_{i}"
        for ln in ("ln_1", "ln_2"):
            sd[f"{p}.{ln}.weight"], sd[f"{p}.{ln}.bias"] = 1 + normal((h,), 0.1), normal((h,), 0.1)
        sd[f"{p}.self_attention.in_proj_weight"] = normal((3 * h, h), h ** -0.5)
        sd[f"{p}.self_attention.in_proj_bias"] = normal((3 * h,), 0.01)
        sd[f"{p}.self_attention.out_proj.weight"] = normal((h, h), h ** -0.5)
        sd[f"{p}.self_attention.out_proj.bias"] = normal((h,), 0.01)
        sd[f"{p}.mlp.0.weight"] = normal((64, h), h ** -0.5)
        sd[f"{p}.mlp.0.bias"] = normal((64,), 0.01)
        sd[f"{p}.mlp.3.weight"], sd[f"{p}.mlp.3.bias"] = normal((h, 64), 0.125), normal((h,), 0.01)
    jm = JViT(ctx=JaxQuantCtx(_fp32(True)), **VIT_KW)
    x = np.random.default_rng(2).normal(size=(2, 32, 32, 3)).astype(np.float32)
    theirs = jax_import_auto.import_torch_checkpoint("vit_b_16", _numpy_sd(sd),
                                                     _abstract(jm, jnp.asarray(x)))
    model = VisionTransformer(ctx=qtt.QuantCtx(_fp32(True)), device="cpu", **VIT_KW)
    import_auto.import_into_model(model, "vit_b_16", sd)
    _assert_trees_equal(convert.to_numpy(model), theirs, cols=("params",))
    want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, mode="fp32"))(theirs, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), mode="fp32").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("name", ["vit_b_32", "vit_l_16", "vit_h_14", "clip_vit-l14",
                                  "clip_rn50x4"])
def test_vit_and_clip_names_dispatch_as_jax(name):
    fn = import_auto._importer_for(name)
    assert callable(fn) and callable(jax_import_auto._importer_for(name))
    with pytest.raises(KeyError):  # an empty state dict names its first missing key
        fn({}, {"params": {}})


def test_clip_checkpoint_round_trips_and_the_published_digest_guards_it(tmp_path):
    sd = chip_smoke.clip_state_dict(dict(TINY_RN), 64, seed=3)
    path = tmp_path / "clip_rn50.pth"
    torch.save(sd, path)
    loaded = import_auto.load_torch_state_dict(str(path))
    assert set(loaded) == set(sd) and all(torch.equal(loaded[k], sd[k]) for k in sd)
    verify_checkpoint(str(path), sha256_of(str(path)), model_name="clip_rn50")
    for expected in ("auto", "0" * 64):  # "auto": the published OpenAI RN50 digest
        with pytest.raises(ValueError, match="sha256 mismatch"):
            verify_checkpoint(str(path), expected, model_name="clip_rn50")
