"""The port's continuous-batching engine (``quantize_tpu_torch.parallel.
serving.InferenceEngine``) on the CPU, case by case as the JAX package's
``tests/test_serving.py``, on TestCNN W8A8 packed by the JAX package and
carried into the port (``convert.from_jax_variables``, through the engine's
``variables``).

Each case serves the same images through both engines. The port's results
equal the port's direct ``model(preprocess(x), mode="packed")`` bit for bit
(every forward is padded to ``batch_size`` and each packed operation works
row by row), and JAX's within 1e-3 of max|logits| (the packed-parity
criterion of ``tests/_torch_parity.py``: JAX's engine runs its forward
under ``jit``). The mesh cases run on a one-device CPU mesh; a mesh of two
devices is refused. Every engine runs in a context manager and every
``result()`` has a timeout.
"""
import queue
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantize_tpu.deploy import pack_model as jax_pack_model
from quantize_tpu.models import MODELS as JAX_MODELS
from quantize_tpu.nn.intercept import QuantCtx as JaxQuantCtx
from quantize_tpu.parallel import make_mesh as jax_make_mesh
from quantize_tpu.parallel.serving import InferenceEngine as JaxEngine
import quantize_tpu_torch as qtt
from quantize_tpu_torch.parallel import InferenceEngine, make_mesh, serving, shard_variables

torch.set_num_threads(2)

W8A8 = {
    "default": {
        "weight": {"n_bits": 8, "symmetric": True, "granularity": "channel",
                   "range": {"name": "minmax"}},
        "activation": {"n_bits": 8, "symmetric": False, "granularity": "layer",
                       "range": {"name": "minmax"}},
        "bn_folding": True,
    }
}
CPU = torch.device("cpu")
TIMEOUT = 60


@pytest.fixture(scope="module")
def packed():
    """JAX's packed TestCNN (tests/test_serving.py's) and its deploy
    variables as numpy."""
    model = JAX_MODELS.build("testcnn", num_classes=4, ctx=JaxQuantCtx(W8A8))
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(4, 16, 16, 3)).astype(np.float32))
    variables = dict(model.init(jax.random.PRNGKey(0), x, mode="calibrate"))
    variables.pop("taps", None)
    _, upd = model.apply(variables, x, mode="calibrate", mutable=["qobs", "qparams"])
    deploy = jax.device_get(jax_pack_model(model, {**variables, **upd}, x))
    return model, deploy


def port_model():
    return qtt.MODELS.build("testcnn", num_classes=4, ctx=qtt.QuantCtx(W8A8), device="cpu")


def direct(model, images, preprocess=None, postprocess=None, frame_pool=None):
    x = torch.as_tensor(np.asarray(images))
    if frame_pool is not None:
        x = frame_pool.index_select(0, x.long())
    with torch.inference_mode():
        x = preprocess(x) if preprocess is not None else x.float()
        out = model(x, mode="packed")
        return (postprocess(out) if postprocess is not None else out).numpy()


def jax_serve(packed, images, **kw):
    model, deploy = packed
    with JaxEngine(model, deploy, **kw) as eng:
        return [f.result(timeout=TIMEOUT) for f in eng.submit_many(images)]


def assert_close_to_jax(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= 1e-3 * np.max(np.abs(want))


def test_serving_matches_direct_forward(packed):
    rng = np.random.default_rng(1)
    images = [rng.normal(size=(16, 16, 3)).astype(np.float32) for _ in range(11)]
    with InferenceEngine(port_model(), packed[1], batch_size=4, max_wait_ms=5.0,
                         device="cpu") as eng:
        results = [f.result(timeout=TIMEOUT) for f in eng.submit_many(images)]
    np.testing.assert_array_equal(np.stack(results), direct(eng.model, images))
    assert eng.stats()["processed"] == 11 and eng.stats()["failed"] == 0
    assert_close_to_jax(np.stack(results),
                        np.stack(jax_serve(packed, images, batch_size=4, max_wait_ms=5.0)))


def test_serving_batches_coalesce(packed):
    rng = np.random.default_rng(2)
    images = [rng.normal(size=(16, 16, 3)).astype(np.float32) for _ in range(32)]
    with InferenceEngine(port_model(), packed[1], batch_size=8, max_wait_ms=50.0,
                         device="cpu") as eng:
        results = [f.result(timeout=TIMEOUT) for f in eng.submit_many(images)]
    assert eng.n_batches <= 8  # 32 requests at batch 8: about 4 full batches
    np.testing.assert_array_equal(np.stack(results), direct(eng.model, images))
    assert_close_to_jax(np.stack(results),
                        np.stack(jax_serve(packed, images, batch_size=8, max_wait_ms=50.0)))


def test_serving_overlaps_dispatch_and_drain(packed):
    """The dispatch loop does not wait for the drain: with the drain held
    back, 2 or more batches are seen in flight."""
    rng = np.random.default_rng(4)
    images = [rng.normal(size=(16, 16, 3)).astype(np.float32) for _ in range(24)]
    eng = InferenceEngine(port_model(), packed[1], batch_size=4, max_wait_ms=1.0,
                          max_in_flight=8, device="cpu")
    gate = threading.Event()
    orig_drain = eng._drain

    def slow_drain():
        gate.wait(timeout=10)
        orig_drain()

    eng._drain = slow_drain
    with eng:
        futs = eng.submit_many(images)
        deadline = time.perf_counter() + 10
        while eng.max_observed_in_flight < 2 and time.perf_counter() < deadline:
            time.sleep(0.005)
        gate.set()
        results = [f.result(timeout=TIMEOUT) for f in futs]
    assert eng.max_observed_in_flight >= 2
    assert eng.stats()["max_observed_in_flight"] == eng.max_observed_in_flight
    np.testing.assert_array_equal(np.stack(results), direct(eng.model, images))
    assert_close_to_jax(np.stack(results), np.stack(jax_serve(
        packed, images, batch_size=4, max_wait_ms=1.0, max_in_flight=8)))


def test_serving_bounded_queue_backpressure(packed):
    eng = InferenceEngine(port_model(), packed[1], batch_size=4, max_queue=2, device="cpu")
    assert eng._queue.maxsize == 2
    jeng = JaxEngine(packed[0], packed[1], batch_size=4, max_queue=2)
    assert jeng._queue.maxsize == eng._queue.maxsize
    # a full queue blocks the producer until the engine takes chunks
    eng._queue.put((np.zeros((1, 16, 16, 3), np.float32), []))
    eng._queue.put((np.zeros((1, 16, 16, 3), np.float32), []))
    with pytest.raises(queue.Full):
        eng._queue.put((np.zeros((1, 16, 16, 3), np.float32), []), timeout=0.05)


def test_serving_on_mesh(packed):
    """A one-device mesh: the engine serves on the mesh's device; a mesh of
    two devices is refused (not ported)."""
    mesh = make_mesh(1, 1, devices=[CPU])
    rng = np.random.default_rng(3)
    images = [rng.normal(size=(16, 16, 3)).astype(np.float32) for _ in range(8)]
    with InferenceEngine(port_model(), packed[1], batch_size=8, mesh=mesh,
                         max_wait_ms=50.0) as eng:
        results = [f.result(timeout=TIMEOUT) for f in eng.submit_many(images)]
    assert eng.device == CPU and all(r.shape == (4,) for r in results)
    np.testing.assert_array_equal(np.stack(results), direct(eng.model, images))
    assert_close_to_jax(np.stack(results), np.stack(jax_serve(
        packed, images, batch_size=8, mesh=jax_make_mesh(dp=4, tp=1), max_wait_ms=50.0)))
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        InferenceEngine(port_model(), batch_size=8, mesh=make_mesh(2, 1, devices=[CPU, CPU]))


def test_uint8_ingress_with_on_device_preprocess(packed):
    """uint8 submits with a normalize in ``preprocess`` equal float32
    submits of the normalized images."""
    rng = np.random.default_rng(5)
    imgs8 = [rng.integers(0, 255, (16, 16, 3)).astype(np.uint8) for _ in range(8)]
    pre = lambda x: x.float() / 128.0 - 1.0  # noqa: E731
    model = port_model()
    with InferenceEngine(model, packed[1], batch_size=4, input_dtype=np.uint8,
                         preprocess=pre, device="cpu") as eng:
        outs8 = [f.result(timeout=TIMEOUT) for f in eng.submit_many(imgs8)]
    with InferenceEngine(model, batch_size=4, device="cpu") as eng:
        outsf = [f.result(timeout=TIMEOUT) for f in eng.submit_many(
            [im.astype(np.float32) / 128.0 - 1.0 for im in imgs8])]
    np.testing.assert_array_equal(np.stack(outs8), np.stack(outsf))
    np.testing.assert_array_equal(np.stack(outs8), direct(model, imgs8, preprocess=pre))
    jpre = lambda x: x.astype(jnp.float32) / 128.0 - 1.0  # noqa: E731
    assert_close_to_jax(np.stack(outs8), np.stack(jax_serve(
        packed, imgs8, batch_size=4, input_dtype=np.uint8, preprocess=jpre)))


def test_serving_device_resident_frame_pool(packed):
    """Requests are int32 indices into a device-resident frame pool,
    gathered on the device."""
    rng = np.random.default_rng(3)
    pool_np = rng.normal(size=(6, 16, 16, 3)).astype(np.float32)
    pool = torch.from_numpy(pool_np)
    idxs = [int(i) for i in rng.integers(0, 6, 13)]
    with InferenceEngine(port_model(), packed[1], batch_size=4, max_wait_ms=5.0,
                         frame_pool=pool, device="cpu") as eng:
        results = [f.result(timeout=TIMEOUT) for f in [eng.submit(i) for i in idxs]]
    assert eng.input_dtype == np.int32 and eng.stats()["processed"] == 13
    np.testing.assert_array_equal(np.stack(results),
                                  direct(eng.model, np.asarray(idxs, np.int32), frame_pool=pool))
    model, deploy = packed
    with JaxEngine(model, deploy, batch_size=4, max_wait_ms=5.0,
                   frame_pool=jnp.asarray(pool_np)) as jeng:
        want = [f.result(timeout=TIMEOUT) for f in [jeng.submit(i) for i in idxs]]
    assert_close_to_jax(np.stack(results), np.stack(want))


def test_serving_on_device_postprocess(packed):
    """``postprocess`` runs on the batch output: each future resolves to
    the reduced result (top-1)."""
    rng = np.random.default_rng(4)
    images = [rng.normal(size=(16, 16, 3)).astype(np.float32) for _ in range(9)]
    post = lambda o: o.argmax(-1)  # noqa: E731
    with InferenceEngine(port_model(), packed[1], batch_size=4, max_wait_ms=5.0,
                         postprocess=post, device="cpu") as eng:
        results = [f.result(timeout=TIMEOUT) for f in eng.submit_many(images)]
    np.testing.assert_array_equal(np.asarray(results), direct(eng.model, images, postprocess=post))
    want = jax_serve(packed, images, batch_size=4, max_wait_ms=5.0,
                     postprocess=lambda o: jnp.argmax(o, -1))
    np.testing.assert_array_equal(np.asarray(results), np.asarray(want))


def test_serving_device_feed_on_mesh(packed):
    """Device feed on a one-device mesh: the variables placed by
    ``shard_variables``, the frame pool on the mesh's device."""
    mesh = make_mesh(1, 1, devices=[CPU])
    rng = np.random.default_rng(5)
    pool_np = rng.normal(size=(6, 16, 16, 3)).astype(np.float32)
    idxs = [int(i) for i in rng.integers(0, 6, 12)]
    deploy_mesh = shard_variables(mesh, packed[1])
    assert all(isinstance(t, torch.Tensor) for t in jax.tree_util.tree_leaves(deploy_mesh))
    with InferenceEngine(port_model(), deploy_mesh, batch_size=4, max_wait_ms=5.0, mesh=mesh,
                         frame_pool=torch.from_numpy(pool_np)) as eng:
        results = [f.result(timeout=TIMEOUT) for f in [eng.submit(i) for i in idxs]]
    np.testing.assert_array_equal(np.stack(results), direct(
        eng.model, np.asarray(idxs, np.int32), frame_pool=torch.from_numpy(pool_np)))
    model, deploy = packed
    with JaxEngine(model, deploy, batch_size=4, max_wait_ms=5.0,
                   frame_pool=jnp.asarray(pool_np)) as jeng:
        want = [f.result(timeout=TIMEOUT) for f in [jeng.submit(i) for i in idxs]]
    assert_close_to_jax(np.stack(results), np.stack(want))


def test_submit_batch_chunk_futures(packed):
    """One future per chunk of up to batch_size, resolving to the stacked
    results."""
    rng = np.random.default_rng(7)
    images = np.stack([rng.normal(size=(16, 16, 3)).astype(np.float32) for _ in range(11)])
    with InferenceEngine(port_model(), packed[1], batch_size=4, max_wait_ms=5.0,
                         device="cpu") as eng:
        chunks = [f.result(timeout=TIMEOUT) for f in eng.submit_batch(images)]
    assert [len(c) for c in chunks] == [4, 4, 3]
    np.testing.assert_array_equal(np.concatenate(chunks), direct(eng.model, images))
    assert eng.stats()["processed"] == 11
    model, deploy = packed
    with JaxEngine(model, deploy, batch_size=4, max_wait_ms=5.0) as jeng:
        want = [f.result(timeout=TIMEOUT) for f in jeng.submit_batch(images)]
    assert_close_to_jax(np.concatenate(chunks), np.concatenate(want))


def test_submit_batch_interleaves_with_per_request(packed):
    """Per-request submits between submit_batch chunks: a chunk's one
    future is deferred whole to the next batch where it straddles one."""
    rng = np.random.default_rng(8)
    singles = [rng.normal(size=(16, 16, 3)).astype(np.float32) for _ in range(3)]
    block = np.stack([rng.normal(size=(16, 16, 3)).astype(np.float32) for _ in range(4)])
    with InferenceEngine(port_model(), packed[1], batch_size=4, max_wait_ms=20.0,
                         device="cpu") as eng:
        fut_singles = [eng.submit(s) for s in singles]
        fut_block = eng.submit_batch(block)
        res_singles = [f.result(timeout=TIMEOUT) for f in fut_singles]
        res_block = [f.result(timeout=TIMEOUT) for f in fut_block]
    np.testing.assert_array_equal(np.stack(res_singles), direct(eng.model, singles))
    np.testing.assert_array_equal(np.concatenate(res_block), direct(eng.model, block))
    model, deploy = packed
    with JaxEngine(model, deploy, batch_size=4, max_wait_ms=20.0) as jeng:
        j_singles = [jeng.submit(s) for s in singles]
        j_block = jeng.submit_batch(block)
        want_singles = [f.result(timeout=TIMEOUT) for f in j_singles]
        want_block = [f.result(timeout=TIMEOUT) for f in j_block]
    assert_close_to_jax(np.stack(res_singles), np.stack(want_singles))
    assert_close_to_jax(np.concatenate(res_block), np.concatenate(want_block))


def test_bad_request_fails_its_batch_not_the_engine(packed):
    """A request of the wrong shape fails its batch's futures; the dispatch
    thread survives and serves the next request."""
    rng = np.random.default_rng(9)
    good = rng.normal(size=(16, 16, 3)).astype(np.float32)
    bad = rng.normal(size=(8, 8, 3)).astype(np.float32)
    with InferenceEngine(port_model(), packed[1], batch_size=4, max_wait_ms=5.0,
                         device="cpu") as eng:
        f_good0 = eng.submit(good)
        f_bad = eng.submit(bad)  # same window: the batch cannot be assembled
        with pytest.raises(ValueError, match="shape"):
            f_bad.result(timeout=TIMEOUT)
        with pytest.raises(ValueError, match="shape"):
            f_good0.result(timeout=TIMEOUT)  # its batchmate shares the failure
        res = eng.submit(good).result(timeout=TIMEOUT)
    np.testing.assert_array_equal(res, direct(eng.model, good[None])[0])
    assert eng.stats()["failed"] >= 2 and eng.stats()["processed"] >= 1
    assert_close_to_jax(res, jax_serve(packed, [good], batch_size=4, max_wait_ms=5.0)[0])


def test_drain_fetches_a_bf16_output_to_host(packed):
    """The drain's fetch to the host of a one-process output (JAX's
    ``_materialize_local_rows`` on a fully addressable array): at bf16
    carry the logits come back widened to float32, equal to the direct
    bf16 forward's; a 1-D output comes back whole."""
    rng = np.random.default_rng(10)
    images = [rng.normal(size=(16, 16, 3)).astype(np.float32) for _ in range(6)]
    model = port_model()
    with qtt.packed_carry(torch.bfloat16):
        with InferenceEngine(model, packed[1], batch_size=4, max_wait_ms=5.0,
                             device="cpu") as eng:
            results = [f.result(timeout=TIMEOUT) for f in eng.submit_many(images)]
        want = direct(model, images, postprocess=lambda o: o.float())
    assert all(r.dtype == np.float32 for r in results)
    np.testing.assert_array_equal(np.stack(results), want)
    with InferenceEngine(model, batch_size=4, postprocess=lambda o: o.amax(-1),
                         device="cpu") as eng:
        (chunk,) = [f.result(timeout=TIMEOUT) for f in eng.submit_batch(np.stack(images[:4]))]
    np.testing.assert_array_equal(chunk, direct(model, images[:4]).max(-1))


def test_precision_switch_after_start_fails_the_batch(packed):
    """The engine records the precision switches at start(): a batch
    dispatched after one changed fails its futures with RuntimeError, and
    the engine serves again once they are back."""
    rng = np.random.default_rng(11)
    image = rng.normal(size=(16, 16, 3)).astype(np.float32)
    with InferenceEngine(port_model(), packed[1], batch_size=4, max_wait_ms=5.0,
                         device="cpu") as eng:
        first = eng.submit(image).result(timeout=TIMEOUT)
        with qtt.packed_carry(torch.bfloat16):
            with pytest.raises(RuntimeError, match="precision switches"):
                eng.submit(image).result(timeout=TIMEOUT)
        with qtt.fused_residual(True):
            with pytest.raises(RuntimeError, match="precision switches"):
                eng.submit(image).result(timeout=TIMEOUT)
        again = eng.submit(image).result(timeout=TIMEOUT)
    np.testing.assert_array_equal(first, again)
    assert eng.stats()["failed"] == 2


def test_stop_timeout_fails_queued_requests_and_keeps_threads(packed, monkeypatch):
    """stop() with the dispatch loop held in a forward: past its timeout
    the requests not yet dispatched fail with RuntimeError, the threads stay
    recorded (start() refuses to run a second loop beside them), the batch
    in its forward still resolves, and after a stop() that ends the threads
    the engine serves again."""
    rng = np.random.default_rng(12)
    images = [rng.normal(size=(16, 16, 3)).astype(np.float32) for _ in range(16)]
    eng = InferenceEngine(port_model(), packed[1], batch_size=4, max_wait_ms=1.0,
                          device="cpu")
    in_forward, gate = threading.Event(), threading.Event()
    orig_forward = eng._forward

    def slow_forward(x):
        in_forward.set()
        gate.wait(timeout=TIMEOUT)
        return orig_forward(x)

    eng._forward = slow_forward
    try:
        eng.start()
        first = eng.submit_many(images[:4])
        assert in_forward.wait(timeout=TIMEOUT)
        later = eng.submit_many(images[4:])
        deadline = time.perf_counter() + TIMEOUT
        while not eng._staged.full() and time.perf_counter() < deadline:
            time.sleep(0.005)  # two batches staged, the third held by the staging thread
        monkeypatch.setattr(serving, "_STOP_TIMEOUT_S", 0.2)
        eng.stop()
        monkeypatch.undo()
        assert sum(f.done() for f in later) >= 8  # the two staged batches failed at once
        assert eng._thread is not None and eng._drain_thread is not None
        with pytest.raises(RuntimeError, match="stop"):
            eng.start()
        gate.set()
        eng.stop()
        assert eng._thread is None and eng._drain_thread is None
        for f in later:
            with pytest.raises(RuntimeError, match="not yet served"):
                f.result(timeout=TIMEOUT)
        results = [f.result(timeout=TIMEOUT) for f in first]
        assert eng.stats()["processed"] == 4 and eng.stats()["failed"] == 12
        eng._forward = orig_forward
        with eng:
            again = [f.result(timeout=TIMEOUT) for f in eng.submit_many(images[:4])]
    finally:
        gate.set()
        eng.stop()
    want = direct(eng.model, images[:4])
    np.testing.assert_array_equal(np.stack(results), want)
    np.testing.assert_array_equal(np.stack(again), want)
