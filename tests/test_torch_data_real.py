"""The port's real-data loaders (``quantize_tpu_torch.data.cifar`` and
``.imagenet``) against the JAX package's, on data the test writes in the
real on-disk formats.

* ``cifar10``, ``cifar100`` and ``cifar10c`` from python-pickle archives
  and ``.npy`` arrays: every split of each dataset config
  (``configs/datasets/cifar/*.yaml``, few-shot train split) gives batches
  bit-equal to JAX's, over two epochs.
* The six ``imagenet*`` names over PNG trees of ragged image sizes (written
  with Pillow), through their configs with smaller crops: bit-equal
  batches with serial and threaded decode, the few-shot split, and the
  base/new subclass split; JAX's ``test_input_pipeline.py`` folder cases
  (subclass split, threaded decode in index order, the index and few-shot
  caches that skip the directory walk and invalidate on a change) on the
  port; the two packages' cache files never collide; a decode without
  Pillow raises ImportError naming it.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from quantize_tpu.runners import _loader as jax_loader
from quantize_tpu.utils import Config as JaxConfig
import quantize_tpu_torch.data.imagenet as inet
from quantize_tpu_torch.data import FolderDataset
from quantize_tpu_torch.runners import _loader as port_loader
from quantize_tpu_torch.utils import Config

ROOT = Path(__file__).resolve().parent.parent
SPLITS = ("train", "val", "test")


def _cfgs(path, extra):
    out = []
    for cls in (JaxConfig, Config):
        cfg = cls()
        cfg.merge_from_yaml(str(ROOT / path))
        cfg.merge_from_dict(extra)
        out.append(cfg)
    return out


def _assert_same_batches(jcfg, cfg, epochs=2):
    n = 0
    for split in SPLITS:
        if not getattr(cfg, f"{split}_dataset", None):
            continue
        # the loaders the runners build: each split's transform applied
        jl, pl = jax_loader(jcfg, split), port_loader(cfg, split)
        assert len(pl) == len(jl) > 0
        for _ in range(epochs):
            mine, theirs = list(pl), list(jl)
            assert len(mine) == len(theirs) == len(pl)
            for b_mine, b_theirs in zip(mine, theirs):
                assert set(b_mine) == set(b_theirs) == {"img", "label"}
                for key in b_theirs:
                    assert b_mine[key].dtype == b_theirs[key].dtype, key
                    np.testing.assert_array_equal(b_mine[key], b_theirs[key], err_msg=key)
                n += len(b_mine["label"])
    return n


@pytest.fixture(scope="module")
def cifar_root(tmp_path_factory):
    """CIFAR-10 and -100 python-format archives (20 seeded images a file)
    and a CIFAR-10-C corruption array (30 images, level 1)."""
    root = tmp_path_factory.mktemp("cifar")
    rng = np.random.default_rng(0)

    def dump(path, n, label_key, classes):
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                         label_key: rng.integers(0, classes, n).tolist()}, f)

    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        dump(root / "cifar-10-batches-py" / name, 20, b"labels", 10)
    for name in ("train", "test"):
        dump(root / "cifar-100-python" / name, 60, b"fine_labels", 100)
    c = root / "CIFAR-10-C"
    c.mkdir()
    np.save(c / "gaussian_noise.npy", rng.integers(0, 256, (30, 32, 32, 3), dtype=np.uint8))
    np.save(c / "labels.npy", rng.integers(0, 10, 30).astype(np.int64))
    return root


@pytest.mark.parametrize("name,shots", [("cifar10", 4), ("cifar100", 0), ("cifar10c", 0)])
def test_cifar_batches_match_jax(cifar_root, monkeypatch, name, shots):
    monkeypatch.chdir(ROOT)
    extra = {f"{s}_loader": {"batch_size": 16} for s in SPLITS}
    for split in SPLITS:
        extra[f"{split}_dataset"] = {"root": str(cifar_root)}
    if shots:
        extra["train_dataset"]["num_shots"] = shots
    if name == "cifar10c":
        extra = {"test_dataset": extra["test_dataset"], "test_loader": extra["test_loader"]}
    jcfg, cfg = _cfgs(f"configs/datasets/cifar/{name}.yaml", extra)
    assert cfg.test_dataset.name == name
    n = _assert_same_batches(jcfg, cfg)
    assert n == {"cifar10": 2 * (40 + 20 + 20), "cifar100": 2 * (60 + 60 + 60),
                 "cifar10c": 2 * 30}[name]


def _write_tree(root: Path, classes: int, per_class: int, seed: int, same_aspect=True) -> None:
    """PNGs of several sizes; with ``same_aspect`` all 2:3 (height:width), the
    ragged trees that JAX's ``resize`` can stack after resizing."""
    rng = np.random.default_rng(seed)
    for ci in range(classes):
        d = root / f"n{ci:08d}"
        d.mkdir(parents=True)
        for j in range(per_class):
            h = 2 * int(rng.integers(6, 12))
            w = h * 3 // 2 if same_aspect else int(rng.integers(12, 24))
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(d / f"{j}.png")


@pytest.fixture(scope="module")
def imagenet_root(tmp_path_factory):
    """ImageNet-layout trees: ``train`` and ``val`` (5 classes x 3 PNGs of
    ragged sizes, one aspect ratio), and ImageNet-C's ``gaussian_noise/1``."""
    root = tmp_path_factory.mktemp("imagenet")
    _write_tree(root / "train", 5, 3, seed=1)
    _write_tree(root / "val", 5, 3, seed=2)
    _write_tree(root / "gaussian_noise" / "1", 5, 3, seed=3)
    return root


SMALL = {"resize": {"size": 20}, "center_crop": {"size": 16}}


@pytest.mark.parametrize("workers", ["0", "4"])
@pytest.mark.parametrize("name", ["imagenet", "imagenet_a", "imagenet_r", "imagenet_v2",
                                  "imagenet_sketch", "imagenet_c"])
def test_imagenet_batches_match_jax(imagenet_root, tmp_path, monkeypatch, name, workers):
    monkeypatch.chdir(ROOT)
    monkeypatch.setenv("QTPU_DECODE_WORKERS", workers)
    monkeypatch.setenv("QTPU_CACHE_DIR", str(tmp_path / "cache"))
    extra = {f"{s}_loader": {"batch_size": 4} for s in SPLITS}
    extra["test_dataset"] = {"root": str(imagenet_root), "transform": SMALL}
    if name == "imagenet":
        extra["val_dataset"] = {"root": str(imagenet_root), "subclass": "base",
                                "transform": SMALL}
        extra["test_dataset"]["subclass"] = "new"
    jcfg, cfg = _cfgs(f"configs/datasets/imagenet/{name}.yaml", extra)
    train = name == "imagenet" and workers == "0"
    if name == "imagenet" and not train:
        # the train split's random crop and flip draw from one generator in
        # every decode thread, so threaded batches follow the scheduling in
        # both packages (ROADMAP.md section 3): compared serially only
        jcfg.train_dataset = cfg.train_dataset = None
    elif train:
        for c in (jcfg, cfg):
            c.merge_from_dict({"train_dataset": {
                "root": str(imagenet_root), "num_shots": 2,
                "transform": {"random_resized_crop": {"size": 16}}}})
    n = _assert_same_batches(jcfg, cfg)
    assert n == 2 * ({"imagenet": 9 + 6} if name == "imagenet" else {}).get(name, 15) \
        + (2 * 10 if train else 0)
    cache = sorted(os.listdir(tmp_path / "cache"))
    assert any(f.startswith("qtt_index_") for f in cache)
    assert any(f.startswith("index_") for f in cache)  # JAX's: other files


def test_resize_of_mixed_aspect_ratios_then_center_crop(tmp_path, monkeypatch):
    """Images of different aspect ratios through ``resize`` and
    ``center_crop`` (the ImageNet eval transform): the port gives each image
    resized and cropped alone, where JAX's ``resize`` cannot stack its
    ragged outputs (ROADMAP.md section 3)."""
    from quantize_tpu.data import build_transform as jax_build_transform
    from quantize_tpu.data.imagenet import FolderDataset as JaxFolderDataset
    from quantize_tpu_torch.data import build_transform

    monkeypatch.setenv("QTPU_CACHE_DIR", str(tmp_path / "cache"))
    # serial decode: the transform sees the whole batch (with as many decode
    # threads as images, JAX's threads would each transform one image)
    monkeypatch.setenv("QTPU_DECODE_WORKERS", "0")
    _write_tree(tmp_path / "val", 2, 4, seed=5, same_aspect=False)
    cfg = {"resize": {"size": 20}, "center_crop": {"size": 16}, "to_tensor": None}
    ds = FolderDataset(str(tmp_path / "val"), transform=build_transform(cfg))
    batch = ds.get_batch(np.arange(8))
    assert batch["img"].shape == (8, 16, 16, 3)
    alone = FolderDataset(str(tmp_path / "val"), transform=build_transform(cfg))
    for i in range(8):
        np.testing.assert_array_equal(alone.get_batch(np.array([i]))["img"][0], batch["img"][i])
    jds = JaxFolderDataset(str(tmp_path / "val"), transform=jax_build_transform(cfg))
    with pytest.raises(ValueError, match="same shape"):
        jds.get_batch(np.arange(8))


def test_folder_dataset_subclass_split(imagenet_root):
    ds = FolderDataset(str(imagenet_root / "val"))
    base, new = ds.select_subclass("base"), ds.select_subclass("new")
    assert base.num_classes == 3 and new.num_classes == 2  # ceil(5/2) = 3
    assert len(base) == 9 and len(new) == 6
    assert sorted(np.unique(base.labels).tolist()) == [0, 1, 2]
    assert sorted(np.unique(new.labels).tolist()) == [0, 1]
    assert base.classnames == ds.classnames[:3] and new.classnames == ds.classnames[3:]
    assert ds.select_subclass("all") is ds


def test_folder_dataset_threaded_decode_keeps_index_order(tmp_path, monkeypatch):
    monkeypatch.setenv("QTPU_DECODE_WORKERS", "4")
    d = tmp_path / "val" / "class0"
    d.mkdir(parents=True)
    for j in range(16):
        Image.fromarray(np.full((8, 8, 3), j * 10, np.uint8)).save(d / f"{j:02d}.png")
    batch = FolderDataset(str(tmp_path / "val")).get_batch(np.arange(16))
    assert batch["img"].dtype == np.float32 and batch["img"].shape == (16, 8, 8, 3)
    assert [batch["img"][j, 0, 0, 0] for j in range(16)] == [j * 10 for j in range(16)]


def test_folder_index_and_fewshot_cache(tmp_path, monkeypatch):
    """The folder index and each (seed, shots) few-shot split are cached: a
    second construction walks no class directory; a new image invalidates."""
    monkeypatch.setenv("QTPU_CACHE_DIR", str(tmp_path / "cache"))
    root = tmp_path / "train"
    _write_tree(root, 3, 4, seed=4)
    ds1 = FolderDataset(str(root))
    fs1 = ds1.few_shot(2, seed=7)
    assert len(ds1) == 12 and len(fs1) == 6

    real_listdir = os.listdir
    walked = []

    def spy(p):
        walked.append(p)
        return real_listdir(p)

    monkeypatch.setattr(inet.os, "listdir", spy)
    ds2 = FolderDataset(str(root))
    fs2 = ds2.few_shot(2, seed=7)
    assert [p for p in walked if os.path.basename(p).startswith("n0")] == []
    assert ds2.paths == ds1.paths and ds2.labels_list == ds1.labels_list
    assert fs2.paths == fs1.paths
    assert ds2.few_shot(2, seed=8).paths == ds1.few_shot(2, seed=8).paths

    monkeypatch.setattr(inet.os, "listdir", real_listdir)
    Image.fromarray(np.full((8, 8, 3), 9, np.uint8)).save(root / "n00000000" / "zz.png")
    os.utime(root / "n00000000")
    assert len(FolderDataset(str(root))) == 13
    assert all(f.startswith("qtt_") for f in os.listdir(tmp_path / "cache"))


def test_folder_decode_without_pillow_raises(imagenet_root):
    code = f"""
import sys
sys.modules["PIL"] = None  # any import of PIL now raises ImportError
import numpy as np
from quantize_tpu_torch.data import FolderDataset
ds = FolderDataset({str(imagenet_root / "val")!r})
assert len(ds) == 15
try:
    ds.get_batch(np.arange(2))
except ImportError as exc:
    print("Pillow" in str(exc))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env={**os.environ, "QTPU_INDEX_CACHE": "0"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "True"
