"""The port's input pipeline (``quantize_tpu_torch.parallel.input_pipeline``)
on the CPU against the JAX package's: ``host_slice`` gives JAX's slices,
``PrefetchIterator`` yields every batch in order (equal to the loader's and
to what JAX's iterator yields), an exception of the source reaches the
consumer (JAX's iterator ends silently there), ``prefetch_to_mesh`` places
on a one-device mesh, and closing the iterator early stops its thread.
Every iterator runs in a context manager.
"""
import numpy as np
import pytest
import torch

from quantize_tpu.data import DataLoader as JaxDataLoader
from quantize_tpu.data import make_synthetic as jax_make_synthetic
from quantize_tpu.parallel.input_pipeline import PrefetchIterator as JaxPrefetchIterator
from quantize_tpu.parallel.input_pipeline import host_slice as jax_host_slice
from quantize_tpu_torch.data import DataLoader, make_synthetic
from quantize_tpu_torch.parallel import (PrefetchIterator, host_slice, make_mesh,
                                         prefetch_to_mesh, shard_batch_to_mesh)

torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.mark.parametrize("n,index,count", [(16, 0, 1), (16, 0, 4), (16, 3, 4), (18, 1, 4),
                                           (10, 2, 3)])
def test_host_slice_matches_jax(n, index, count):
    batch = {"img": np.arange(n * 2).reshape(n, 2), "label": np.arange(n)}
    got = host_slice(batch, process_index=index, process_count=count)
    want = jax_host_slice(batch, process_index=index, process_count=count)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    whole = host_slice(batch)  # one process: the whole batch
    np.testing.assert_array_equal(whole["label"], batch["label"])


def test_prefetch_iterator_yields_every_batch_in_order():
    loader = DataLoader(make_synthetic(n=70, image_size=8), batch_size=16, shuffle=True)
    jloader = JaxDataLoader(jax_make_synthetic(n=70, image_size=8), batch_size=16, shuffle=True)
    want = list(DataLoader(make_synthetic(n=70, image_size=8), batch_size=16, shuffle=True))
    with prefetch_to_mesh(loader, prefetch=2, device="cpu") as it:
        got = list(it)
    theirs = [{k: np.asarray(v) for k, v in b.items()}
              for b in JaxPrefetchIterator(iter(jloader), prefetch=2)]
    assert [len(b["label"]) for b in got] == [16, 16, 16, 16, 6]
    for g, w, t in zip(got, want, theirs):
        assert set(g) == {"img", "label"} and all(v.device == CPU for v in g.values())
        for k in w:
            assert isinstance(g[k], torch.Tensor)
            np.testing.assert_array_equal(g[k].numpy(), w[k])
            np.testing.assert_array_equal(g[k].numpy(), t[k])


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_source_exception_reaches_the_consumer():
    def source():
        for i in range(3):
            yield {"x": np.full((2,), i)}
        raise OSError("decode failed on image 7")

    seen = []
    with PrefetchIterator(source(), prefetch=2, device="cpu") as it:
        with pytest.raises(OSError, match="image 7"):
            for batch in it:
                seen.append(int(batch["x"][0]))
        with pytest.raises(StopIteration):
            next(it)
    assert seen == [0, 1, 2]
    # JAX's iterator ends there silently: a truncated eval (ROADMAP section 3)
    jit = JaxPrefetchIterator(source(), prefetch=2)
    assert [int(b["x"][0]) for b in jit] == [0, 1, 2]
    jit._thread.join(timeout=10)


def test_prefetch_to_mesh_on_one_device():
    mesh = make_mesh(1, 1, devices=[CPU])
    loader = DataLoader(make_synthetic(n=32, image_size=8), batch_size=8)
    with prefetch_to_mesh(loader, mesh=mesh) as it:
        batches = list(it)
    assert it.device == CPU and sum(len(b["label"]) for b in batches) == 32
    placed = shard_batch_to_mesh(mesh, {"img": np.ones((4, 2), np.float32)})
    assert placed["img"].device == CPU and torch.equal(placed["img"], torch.ones(4, 2))
    # a mesh of two ranks needs a process group of two (tests/test_torch_multiprocess.py)
    with pytest.raises(RuntimeError, match="needs torch.distributed initialised with 2"):
        prefetch_to_mesh(loader, mesh=make_mesh(2, 1, devices=[CPU, CPU]))


def test_close_stops_the_thread_early():
    def endless():
        i = 0
        while True:
            yield {"x": np.full((4,), i)}
            i += 1

    with PrefetchIterator(endless(), prefetch=2, device="cpu") as it:
        first = [int(next(it)["x"][0]) for _ in range(3)]
    assert first == [0, 1, 2]
    assert not it._thread.is_alive()
    with pytest.raises(StopIteration):
        next(it)
