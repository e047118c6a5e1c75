"""The AdaRound runner on a ``(data, model)`` mesh of gloo ranks on the CPU
against the JAX package's runner run eagerly on the global batches
(``jax.disable_jit``: under ``jit`` XLA's rewrites move AdaRound's knife
edges, ROADMAP §3, PR 17), the companion of ``tests/
test_torch_mesh_adaround.py`` (its config, batches and criteria; JAX's
eager ops take ~30 s to compile, so they sit in a file of their own).

TestCNN W4 per-channel MinMax weights with ``adaround.apply`` and 32-bit
activations, Adam 1e-3, β dynamic, 3 global batches of 4, ``max_epoch`` 2,
from JAX's initial variables: blockwise at ``(2, 1)`` and ``(1, 2)``,
sequential at ``(1, 2)``. Each rank's variables, gathered whole: the layer
order and the rounding decisions (``floor(w / s - z) + [h(V) >= 0.5]``)
exact wherever JAX's |V| > 2e-2; its ``layer_losses`` within rtol 1e-4 plus
1e-6 of the losses JAX's runner logs (six decimals).
"""
import re

import jax
import pytest
import torch

from _torch_mesh import ArrayLoader, run_jobs
from test_torch_mesh_adaround import (LAYERS, _flat, _name, _runner_cfg, _ranks, hold_run,
                                      initial_variables, runner_job)
from quantize_tpu.runners.adaround import AdaRound as JaxAdaRound
from quantize_tpu.utils import Config as JaxConfig

torch.set_num_threads(2)

RUNS = [("blockwise", (2, 1)), ("blockwise", (1, 2)), ("sequential", (1, 2))]


def _jax_run(tmp, batches, v0, mode):
    """JAX's runner from ``v0``, eagerly: its variables (flat) and the layer
    losses it logs."""
    jr = JaxAdaRound(JaxConfig(_runner_cfg(tmp / f"jax_{mode}", mode)), ArrayLoader(batches))
    jr.variables = v0
    logged = []
    jr.logger.info = lambda *m: logged.append(" ".join(str(p) for p in m))
    with jax.disable_jit():
        jr.run()
    found = (re.search(r"adaround layer \[\d+/\d+\] (\S+): loss (\S+)", ln) for ln in logged)
    return _flat(jax.device_get(jr.variables)), {m.group(1): float(m.group(2))
                                                  for m in found if m}


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_adaround_jax")
    batches, v0 = initial_variables(tmp)
    refs = {mode: _jax_run(tmp, batches, v0, mode) for mode in sorted({m for m, _ in RUNS})}
    ranks = {2: run_jobs(2, [runner_job(tmp, mode, mesh) for mode, mesh in RUNS], tmp)}
    return None, refs, ranks


@pytest.mark.parametrize("mode,mesh", RUNS, ids=[f"{m}-{d}x{t}" for m, (d, t) in RUNS])
def test_runner_matches_eager_jax(cases, mode, mesh):
    reports, saved = _ranks(cases, _name(mode, mesh), mesh)
    flat, losses = cases[1][mode]
    assert list(losses) == LAYERS
    hold_run(reports, saved, flat, losses, "eager JAX")
