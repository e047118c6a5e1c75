"""The port's scaling harness in one process on the CPU
(``quantize_tpu_torch.parallel.scaling``), against the JAX package's
``quantize_tpu.parallel.scaling`` where the two share code.

* ``collective_stats`` gives JAX's counts and bytes on the HLO strings of
  ``tests/test_scaling.py`` (JAX's ``est_ici_ms``, a TPU link estimate, is
  not carried over).
* ``CollectiveCounter`` counts what the collective wrappers report inside
  it, per step.
* ``measure_scaling`` on a one-device mesh returns JAX's record (its keys
  but ``est_ici_ms``) with no collective and the sharded output equal to
  the one-device forward; ``_time_steps`` chains its inputs; the entry
  points refuse CUDA where there is none.
* ``host_slice`` agrees with JAX's; the engine's row reassembly raises on a
  gap, an overlap or a piece of the wrong length.

The ranks themselves (gloo, spawned processes) are in
``tests/test_torch_multiprocess.py``.
"""
import numpy as np
import pytest
import torch

from quantize_tpu.parallel import collective_stats as jax_collective_stats
from quantize_tpu.parallel.input_pipeline import host_slice as jax_host_slice
from quantize_tpu_torch.parallel import (CollectiveCounter, collective_stats, host_slice,
                                         measure_scaling, run_multiprocess_scaling)
from quantize_tpu_torch.parallel import scaling
from quantize_tpu_torch.parallel.serving import _materialize_local_rows

torch.set_num_threads(2)

# tests/test_scaling.py's HLO: plain ops, async pairs, tuple-shaped starts,
# an unknown dtype
HLO = {
    "plain": """
  %ar = f32[8,16]{1,0} all-reduce(f32[8,16]{1,0} %p0), replica_groups={}
  %ag = bf16[4,32]{1,0} all-gather(bf16[4,8]{1,0} %p1), dimensions={1}
  %rs = s8[128]{0} reduce-scatter(s8[1024]{0} %p2), dimensions={0}
    """,
    "async_pairs": """
  %s0 = f32[8,16]{1,0} all-reduce-start(f32[8,16]{1,0} %p0), replica_groups={}
  %d0 = f32[8,16]{1,0} all-reduce-done(f32[8,16]{1,0} %s0)
  %s1 = bf16[4,32]{1,0} all-gather-start(bf16[4,8]{1,0} %p1), dimensions={1}
  %d1 = bf16[4,32]{1,0} all-gather-done(bf16[4,32]{1,0} %s1)
    """,
    "tuple_starts": """
  %s0 = (f32[8,16]{1,0}, f32[8,16]{1,0}) all-reduce-start(f32[8,16]{1,0} %p0), replica_groups={}
  %d0 = f32[8,16]{1,0} all-reduce-done(%s0)
  %s1 = (bf16[4,8]{1,0}, u32[2]{0}, bf16[4,32]{1,0}, u32[2]{0}) all-gather-start(bf16[4,8]{1,0} %p1), dimensions={1}
  %d1 = bf16[4,32]{1,0} all-gather-done(%s1)
    """,
    "unknown_dtype": "%x = e5m2[16]{0} all-reduce(e5m2[16]{0} %p)",
}

# quantize_tpu/parallel/scaling.py:199-215, the record's keys (est_ici_ms
# comes from collective_stats: a TPU link estimate, not carried over)
JAX_KEYS = {"model", "w_bits", "mesh", "n_devices", "n_processes", "platform",
            "per_device_batch", "global_batch", "image_size", "t1_ms", "tn_ms",
            "img_per_s_per_chip_1dev", "img_per_s_per_chip_ndev", "weak_scaling_efficiency",
            "collective_counts", "collective_bytes_per_step"}


@pytest.mark.parametrize("name", sorted(HLO))
def test_collective_stats_matches_jax(name):
    want = jax_collective_stats(HLO[name])
    assert want.pop("est_ici_ms") >= 0
    got = collective_stats(HLO[name])
    assert got == want
    assert "est_ici_ms" not in got


def test_collective_counter_counts_per_step():
    scaling.record_collective("all-gather", 10, 0, seconds=1.0)  # no counter: dropped
    with CollectiveCounter() as outer:
        for _ in range(3):
            scaling.record_collective("all-gather", 100, 300, seconds=0.002)
        with CollectiveCounter() as inner:
            scaling.record_collective("all-reduce", 8, 0)
    scaling.record_collective("all-gather", 10, 0)
    assert outer.counts == {"all-gather": 3, "all-reduce": 1} and inner.counts == {"all-reduce": 1}
    step = outer.per_step(3)
    assert step["collective_counts"] == {"all-gather": 1, "all-reduce": 0}
    assert step["collective_bytes_per_step"] == (300 + 8) / 3
    assert step["staged_bytes_per_step"] == 300
    assert step["collective_ms"] == pytest.approx(2.0)


def test_measure_scaling_on_one_device():
    r = measure_scaling("resnet18", w_bits=8, per_device_batch=2, image_size=16,
                        num_classes=16, iters=2, device="cpu")
    assert JAX_KEYS <= set(r) and "est_ici_ms" not in r
    assert r["platform"] == "cpu" and r["mesh"] == {"data": 1, "model": 1}
    assert r["n_devices"] == r["n_processes"] == r["ranks_per_device"] == 1
    assert r["global_batch"] == 2 and r["t1_ms"] > 0 and r["tn_ms"] > 0
    assert np.isfinite(r["weak_scaling_efficiency"])
    assert r["collective_counts"] == {} and r["collective_bytes_per_step"] == 0
    assert r["staged_bytes_per_step"] == 0 and r["collective_ms"] == 0
    assert r["n_differ_vs_1dev"] == 0 and r["max_abs_err_vs_1dev"] == 0
    # the CPU runs the plain versions and counts no launch
    assert set(r["launches_ndev"]) == set(r["launches_1dev"]) and not any(
        r["launches_ndev"].values())


def test_time_steps_chains_its_inputs():
    seen = []

    def fn(x):
        seen.append(x.clone())
        return x * 2.0

    per_step = scaling._time_steps(fn, torch.ones(3), iters=3, warmup=2)
    assert per_step >= 0 and len(seen) == 5
    assert all(not torch.equal(a, b) for a, b in zip(seen, seen[1:]))


def test_cuda_entry_points_refuse_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device; pass device='cpu'"):
        measure_scaling("resnet18", image_size=16)
    with pytest.raises(RuntimeError, match="no CUDA device; pass device='cpu'"):
        run_multiprocess_scaling(2)
    with pytest.raises(ValueError, match="needs 4 processes, not 2"):
        run_multiprocess_scaling(2, dp=2, tp=2, device="cpu")


@pytest.mark.parametrize("index,count", [(0, 1), (0, 2), (1, 2), (2, 4), (3, 4)])
def test_host_slice_matches_jax(index, count):
    batch = {"img": np.arange(8 * 3, dtype=np.float32).reshape(8, 3),
             "label": np.arange(8, dtype=np.int32)}
    got = host_slice(batch, process_index=index, process_count=count)
    want = jax_host_slice(batch, process_index=index, process_count=count)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # outside a process group: this process is the only one
    assert all(np.array_equal(host_slice(batch)[k], batch[k]) for k in batch)


def test_local_rows_must_tile_the_batch():
    rows = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    whole = _materialize_local_rows(rows)
    np.testing.assert_array_equal(whole, rows.numpy())
    pieces = [(range(3, 6), rows[3:]), (slice(0, 3), rows[:3])]
    np.testing.assert_array_equal(_materialize_local_rows(pieces, 6), rows.numpy())
    with pytest.raises(ValueError, match=r"rows 2\.\.3 are missing"):
        _materialize_local_rows([(range(0, 2), rows[:2]), (range(3, 6), rows[3:])], 6)
    with pytest.raises(ValueError, match=r"rows 3\.\.4 overlap"):
        _materialize_local_rows([(range(0, 4), rows[:4]), (range(3, 6), rows[3:])], 6)
    with pytest.raises(ValueError, match="end at row 5, not 6"):
        _materialize_local_rows([(range(0, 5), rows[:5])], 6)
    with pytest.raises(ValueError, match=r"rows \[0, 3\) holds 2 rows"):
        _materialize_local_rows([(range(0, 3), rows[:2])], 3)
