"""Every YAML in configs/ means the same thing to the port as to the JAX
package (the port's twin of ``tests/test_config_corpus.py``).

* Each file parses through the port's ``Config`` (its ``_base_`` chain from
  the repository root) to the same ``to_dict()`` as through JAX's.
* Each runnable file's runner, model and ``range`` names resolve in the
  port's registries.
* For each file with a ``quant`` section, ``QuantCtx.resolve`` gives an
  equal ``LayerQuantCfg`` (its four fields and ``into_scale``) in both
  packages for each of the seven layer kinds and for each override key of
  the section taken as a layer path; ``bn_folding_enabled`` and
  ``act_layer_enabled`` agree too.
"""
import dataclasses
import os
from collections.abc import Mapping

import pytest

from quantize_tpu.nn.intercept import QuantCtx as JaxQuantCtx
from quantize_tpu.utils import Config as JaxConfig
from quantize_tpu_torch.nn.intercept import QuantCtx
from quantize_tpu_torch.utils import Config

from test_config_corpus import ALL_CONFIGS, REPO, RUNNABLE

KINDS = ("nn_conv2d", "nn_linear", "nn_conv2d_bn2d", "nn_multiheadattention", "nn_relu",
         "nn_maxpool2d", "nn_adaptiveavgpool2d")


def _load(cls, path):
    cwd = os.getcwd()
    os.chdir(REPO)  # _base_ paths are repo-relative
    try:
        cfg = cls()
        cfg.merge_from_yaml(path)
        return cfg
    finally:
        os.chdir(cwd)


def _plain(v):
    """Frozen mappings and tuples of either package as dicts and lists."""
    if isinstance(v, Mapping):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


def _layer(cfg):
    return {**{f.name: _plain(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)},
            "into_scale": cfg.into_scale}


def _ids(paths):
    return [os.path.relpath(p, REPO) for p in paths]


QUANT_CONFIGS = [p for p in ALL_CONFIGS if _load(JaxConfig, p).to_dict().get("quant")]


@pytest.mark.parametrize("path", ALL_CONFIGS, ids=_ids(ALL_CONFIGS))
def test_config_parses_as_jax(path):
    assert _load(Config, path).to_dict() == _load(JaxConfig, path).to_dict()


@pytest.mark.parametrize("path", RUNNABLE, ids=_ids(RUNNABLE))
def test_runnable_config_names_resolve_in_the_port(path):
    from quantize_tpu_torch.models import MODELS
    from quantize_tpu_torch.quant.observers import RANGES
    from quantize_tpu_torch.runners import RUNNERS

    cfg = _load(Config, path)
    if cfg.runner and cfg.runner.name:
        RUNNERS.lookup(cfg.runner.name)
    if cfg.model and cfg.model.name:
        assert cfg.model.name in MODELS, cfg.model.name

    def check_ranges(node):
        if not isinstance(node, dict):
            return
        for k, v in node.items():
            if k == "range" and isinstance(v, dict) and v.get("name"):
                RANGES.lookup(v["name"])
            elif isinstance(v, dict):
                check_ranges(v)

    check_ranges(cfg.quant.to_dict() if cfg.quant else {})


@pytest.mark.parametrize("path", QUANT_CONFIGS, ids=_ids(QUANT_CONFIGS))
def test_quant_section_resolves_as_jax(path):
    quant = _load(JaxConfig, path).to_dict()["quant"]
    jctx, tctx = JaxQuantCtx(_load(JaxConfig, path).quant), QuantCtx(_load(Config, path).quant)
    assert tctx.enabled == jctx.enabled and tctx.default == jctx.default
    assert tctx.bn_folding_enabled == jctx.bn_folding_enabled
    sites = [("/layer1/0/conv1", kind) for kind in KINDS]
    sites += [(key, "nn_conv2d") for key in quant if key != "default"]
    for path_, kind in sites:
        assert _layer(tctx.resolve(path_, kind)) == _layer(jctx.resolve(path_, kind)), (path_, kind)
    for kind in KINDS:
        assert tctx.act_layer_enabled(kind) == jctx.act_layer_enabled(kind), kind


def test_the_corpus_has_every_kind_of_file():
    assert len(ALL_CONFIGS) >= 57 and len(RUNNABLE) >= 40 and len(QUANT_CONFIGS) >= 100
    assert any(_layer(QuantCtx(_load(Config, p).quant).resolve("/conv1", "nn_conv2d"))
               ["bn_folding"] for p in QUANT_CONFIGS)
