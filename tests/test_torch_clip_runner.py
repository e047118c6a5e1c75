"""The port's PTQ runner on CLIP: ``python -m quantize_tpu_torch.cli`` with
the model and quant sections of ``configs/runners/ptq/clip_vitb16_zeroshot_in1k.yaml``
(``clip_vit-b16``, the five prompt templates of
``configs/datasets/imagenet/prompts.yaml``, MinMax W8A8) on the synthetic
dataset at tiny width (the CLIP config overridden to an image tower 64 wide
with 2 layers and patch 8 at 32 x 32, a text tower 32 wide with 2 layers, a
vocabulary of 1,024 for the hash tokenizer's ids), on the CPU.

The runner computes the zero-shot weights once after init (fp32 text
tower, the dataset's class names times the config's prompts), calibrates,
evaluates and checkpoints; the test top-1 lies in [0, 100]; the zero-shot
weights equal ``build_zeroshot`` on the runner's own model; a fresh runner
loaded from the best checkpoint gives bit-equal quant-mode logits.
"""
import json

import numpy as np
import pytest
import torch

import quantize_tpu_torch.runners as runners
from quantize_tpu_torch import cli
from quantize_tpu_torch.models.clip import CLIPZeroShot, class_prompt_tokens
from quantize_tpu_torch.models.clip.tokenizer import HashTokenizer
from quantize_tpu_torch.utils import Config

torch.set_num_threads(2)

RUNNER_CFG = "configs/runners/ptq/minmax/ptq_rn18_w8a8_synthetic.yaml"
CLIP_CFG = "configs/runners/ptq/clip_vitb16_zeroshot_in1k.yaml"
TINY = dict(embed_dim=32, vision_layers=2, vision_width=64, vision_patch_size=8,
            context_length=16, vocab_size=1024, transformer_width=32,
            transformer_heads=2, transformer_layers=2)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("clip_run")
    src = Config()
    src.merge_from_yaml(CLIP_CFG)
    assert src.model.name == "clip_vit-b16" and len(src.model.prompts) == 5
    section = {"model": {**src.model.to_dict(), "config_overrides": TINY, "image_size": 32},
               "quant": {"_replace_": True, **src.quant.to_dict()}}
    extra = out / "clip.yaml"
    extra.write_text(json.dumps(section))
    built = []
    build = runners.build_runner

    def keep(*args, **kw):
        built.append(build(*args, **kw))
        return built[-1]

    runners.build_runner = keep
    try:
        cli.main(["--cfg", RUNNER_CFG, str(extra), "--device", "cpu", "--output-dir", str(out)])
    finally:
        runners.build_runner = build
    return out, built[0], src


def test_the_runner_reaches_a_test_result(run):
    out, runner, _ = run
    log = (out / "output.log").read_text()
    assert "precomputing CLIP zero-shot weights for 10 classes" in log
    found = [line for line in log.splitlines() if "test result: {'top1': " in line]
    assert len(found) == 1 and "'n': 256}" in found[0]
    top1 = float(found[0].split("'top1': ")[1].split(",")[0])
    assert 0.0 <= top1 <= 100.0
    assert isinstance(runner.model, CLIPZeroShot)
    for name in ("cfg.yaml", "ckpt_last.pkl", "ckpt_best.pkl"):
        assert (out / name).exists(), name


def test_the_zero_shot_weights_are_the_class_prompts(run):
    _, runner, src = run
    w = runner.model.get_var("zeroshot", "weights")
    assert tuple(w.shape) == (32, 10)
    np.testing.assert_allclose(w.norm(dim=0).numpy(), 1.0, rtol=1e-5)
    toks = class_prompt_tokens([f"class_{i}" for i in range(10)], list(src.model.prompts),
                               HashTokenizer(1024), 16)
    fresh = runner.model.get_var("zeroshot", "weights").clone()
    with torch.no_grad():
        runner.model.precompute(toks, mode="fp32")
    assert torch.equal(runner.model.get_var("zeroshot", "weights"), fresh)


def test_the_best_checkpoint_reloads_bit_equal(run):
    _, runner, _ = run
    cfg = runner.cfg
    fresh = runners.build_runner(cfg, device="cpu")
    extra = fresh.load_checkpoint(cfg.runner.best)
    assert 0.0 <= extra["eval"]["top1"] <= 100.0
    assert torch.equal(fresh.model.get_var("zeroshot", "weights"),
                       runner.model.get_var("zeroshot", "weights"))
    batch = next(runner._prefetch(runner.test_loader))
    assert torch.equal(fresh.eval_step(batch, quantized=True),
                       runner.eval_step(batch, quantized=True))
