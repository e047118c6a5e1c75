"""The port's data pipeline (quantize_tpu_torch.data) against the JAX
package's: the same config gives bit-equal batches (few-shot sampling with
the config's seed, two shuffled epochs, drop_last, worker threads), every
registered transform gives bit-equal output on a seeded uint8 batch, and
the package imports without Pillow; every dataset name builds a real
loader (a missing root raises FileNotFoundError).
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from quantize_tpu.data import TRANSFORMS as JAX_TRANSFORMS
from quantize_tpu.data import build_dataloader as jax_build_dataloader
from quantize_tpu.utils import Config as JaxConfig
from quantize_tpu_torch.data import TRANSFORMS, build_dataloader
from quantize_tpu_torch.utils import Config

ROOT = Path(__file__).resolve().parent.parent
CFG = "configs/runners/ptq/minmax/ptq_rn18_w8a8_synthetic.yaml"


def _cfgs(extra):
    out = []
    for cls in (JaxConfig, Config):
        cfg = cls()
        cfg.merge_from_yaml(str(ROOT / CFG))
        cfg.merge_from_dict(extra)
        out.append(cfg)
    return out


def _assert_batches_equal(mine, theirs):
    assert len(mine) == len(theirs) > 0
    for b_mine, b_theirs in zip(mine, theirs):
        assert set(b_mine) == set(b_theirs) == {"img", "label"}
        for key in b_theirs:
            assert b_mine[key].dtype == b_theirs[key].dtype, key
            np.testing.assert_array_equal(b_mine[key], b_theirs[key], err_msg=key)


@pytest.mark.parametrize("split,extra", [
    ("train", {}),  # the config as users run it: 16 shots x 10 classes, seed 1, shuffled
    ("train", {"train_loader": {"drop_last": True}}),
    ("train", {"train_loader": {"num_workers": 2}}),
    ("val", {}),
])
def test_dataloader_batches_match_jax(split, extra):
    jcfg, cfg = _cfgs(extra)
    jl, pl = jax_build_dataloader(jcfg, split), build_dataloader(cfg, split)
    assert len(pl) == len(jl)
    if split == "train":
        assert len(pl.dataset) == 160 and pl.shuffle
        assert len(pl) == (2 if extra.get("train_loader", {}).get("drop_last") else 3)
    for _ in range(2):  # two epochs: the shuffle is drawn anew from seed + epoch
        _assert_batches_equal(list(pl), list(jl))


_GRID = {"transforms": {"random_horizontal_flip": {}, "random_vertical_flip": {}}}
TRANSFORM_KWARGS = {
    "resize": {"size": 12},
    "center_crop": {"size": 10},
    "random_resized_crop": {"size": 12},
    "random_crop": {"size": 12, "padding": 2},
    "random_horizontal_flip": {},
    "to_tensor": {},
    "normalize": {"mean": [0.4, 0.5, 0.6], "std": [0.2, 0.3, 0.25]},
    "random_vertical_flip": {},
    "random_rotation": {"degrees": 30},
    "random_affine": {"degrees": 15, "translate": [0.1, 0.1], "scale": [0.9, 1.1], "shear": 5},
    "color_jitter": {"brightness": 0.4, "contrast": 0.4, "saturation": 0.4, "hue": 0.1},
    "pad": {"padding": 2},
    "lambda": {},
    "random_apply": {"transforms": {"random_horizontal_flip": {}}, "p": 0.5},
    "random_choice": _GRID,
    "random_order": _GRID,
    "grayscale": {"num_output_channels": 3},
    "random_grayscale": {"p": 0.5},
    "random_perspective": {},
    "random_erasing": {"p": 0.9},
    "five_crop": {"size": 12},
    "ten_crop": {"size": 12},
    "linear_transformation": {
        "transformation_matrix": np.random.default_rng(1).normal(size=(192, 192)).astype(np.float32),
        "mean_vector": np.full(192, 100.0, np.float32)},
    "gaussian_blur": {"kernel_size": 3},
    "augmix": {"preprocess": {"to_tensor": {}}, "n_views": 3},
    "augexpand": {"preprocess": {"to_tensor": {}}, "custom_funcs": ["random_rotate"],
                  "n_views": 2},
}


def test_every_registered_transform_is_covered():
    assert set(TRANSFORMS) == set(JAX_TRANSFORMS) == set(TRANSFORM_KWARGS)


@pytest.mark.parametrize("name", sorted(TRANSFORM_KWARGS))
def test_transform_matches_jax(name):
    """Two calls on a seeded uint8 batch (16 images of 8 x 8, the linear
    transformation's 192 = 8 * 8 * 3), so each transform's RNG, drawn from
    default_rng(0) inside it, advances alike. AugMix and AugExpand draw from
    numpy's global RNG, seeded alike before each package's calls."""
    batch = np.random.default_rng(7).integers(0, 256, size=(16, 8, 8, 3), dtype=np.uint8)
    if name in ("resize", "center_crop", "random_resized_crop", "five_crop", "ten_crop",
                "random_crop"):
        batch = np.random.default_rng(7).integers(0, 256, size=(4, 16, 14, 3), dtype=np.uint8)
    outs = []
    for registry in (JAX_TRANSFORMS, TRANSFORMS):
        np.random.seed(3)
        fn = registry.build(name, **TRANSFORM_KWARGS[name])
        outs.append([np.asarray(fn(batch.copy())) for _ in range(2)])
    theirs, mine = outs
    for got, want in zip(mine, theirs):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_data_imports_and_runs_without_pillow():
    """``import quantize_tpu_torch.data`` and the synthetic config's loaders
    need no PIL (the card's machine has none); a transform that uses PIL
    asks for it only when it is built."""
    code = f"""
import sys
sys.modules["PIL"] = None  # any import of PIL now raises ImportError
from quantize_tpu_torch.data import TRANSFORMS, build_dataloader
from quantize_tpu_torch.utils import Config
cfg = Config().merge_from_yaml({CFG!r})
batches = list(build_dataloader(cfg, "train"))
assert [len(b["label"]) for b in batches] == [64, 64, 32]
TRANSFORMS.build("normalize", mean=[0.5], std=[0.2])
try:
    TRANSFORMS.build("resize", size=8)
except ImportError:
    print("lazy")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "lazy"


@pytest.mark.parametrize("name", ["cifar10", "cifar100", "cifar10c", "imagenet", "imagenet_a",
                                  "imagenet_r", "imagenet_v2", "imagenet_sketch", "imagenet_c"])
def test_dataset_missing_root_raises_by_name(name, tmp_path):
    """Every dataset name builds its real loader: a root without the data
    raises FileNotFoundError naming the path it looked for."""
    cfg = Config({"train_dataset": {"name": name, "root": str(tmp_path / "absent")}})
    with pytest.raises(FileNotFoundError, match="absent"):
        build_dataloader(cfg, "train")
