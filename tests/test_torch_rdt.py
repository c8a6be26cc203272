"""The port's device objects (RDT, ``ray_tpu_torch/core/device_objects.py``)
on the CPU: the contracts of ``tests/test_rdt.py``, re-run with torch
tensors on the port's cluster, plus what the port adds: a bf16 leaf's
bits survive the export, the export writes the same segment bytes as the
JAX package's for the same data, containers of a state dict keep their
types, a producer's tensors are released once the ref is dropped, and a
CUDA leaf in a process that sees no card raises.

Every ``torch.Tensor`` takes the device path here, as every ``jax.Array``
does on JAX's CPU backend. Functions and classes shipped to the actors are
pickled by value, so this module names no module of the JAX package among
its globals: the JAX package is imported inside the test that uses it.
"""

import os
import time
from collections import OrderedDict

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.core import cluster_utils
from ray_tpu_torch.core import device_objects as dev_mod
from ray_tpu_torch.core import worker as worker_mod
from ray_tpu_torch.core.device_objects import DeviceValue
from ray_tpu_torch.utils.config import config


@pytest.fixture(scope="module")
def rt():
    cluster_utils.sweep_stale_runtime()
    # the actors inherit it: torch on one intra-op thread each, as other
    # test files run beside this one
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        ray_tpu_torch.init(num_cpus=4)
        yield ray_tpu_torch
        ray_tpu_torch.shutdown()


_ACTORS = []


def _own(actor):
    """An actor the running test creates: killed when it ends, so that its
    process (holding torch) does not outlive the test."""
    _ACTORS.append(actor)
    return actor


@pytest.fixture(autouse=True)
def _kill_actors():
    yield
    while _ACTORS:
        ray_tpu_torch.kill(_ACTORS.pop())


def _bits(t: torch.Tensor) -> bytes:
    return t.detach().contiguous().numpy().tobytes() if t.dtype != torch.bfloat16 else \
        t.detach().contiguous().view(torch.int16).numpy().tobytes()


def test_driver_put_device_roundtrip_zero_copy(rt):
    x = torch.arange(64.0).reshape(8, 8)
    ref = rt.put(x, _tensor_transport="device")
    w = worker_mod.global_worker()
    stored = w.memory_store.try_get(ref.id)
    assert isinstance(stored, DeviceValue), "payload must NOT be pickled"
    got = rt.get(ref)
    # same process: the very same tensor object comes back (zero copy)
    assert got is x


def test_actor_device_return_fetched_by_driver(rt):
    @rt.remote
    class Producer:
        def make(self, n):
            import torch

            return torch.arange(float(n)) * 2.0

    p = _own(Producer.remote())
    ref = p.make.options(tensor_transport="device").remote(16)
    w = worker_mod.global_worker()
    got = rt.get(ref, timeout=60)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.arange(16.0) * 2.0)
    # the owner held only metadata; payload stayed at the actor
    stored = w.memory_store.try_get(ref.id)
    assert isinstance(stored, DeviceValue)
    assert stored.worker_address != w.address
    assert stored.leaves_meta == [((16,), "float32", "cpu")]


def test_actor_to_actor_handoff(rt):
    @rt.remote
    class Producer:
        def make(self):
            import torch

            return {"w": torch.ones((4, 4)), "step": 7}

    @rt.remote
    class Consumer:
        def total(self, tree):
            import torch

            assert isinstance(tree["w"], torch.Tensor)
            return float(tree["w"].sum()) + tree["step"]

    p = _own(Producer.remote())
    c = _own(Consumer.remote())
    ref = p.make.options(tensor_transport="device").remote()
    out = rt.get(c.total.remote(ref), timeout=60)
    assert out == 16.0 + 7


def test_same_actor_roundtrip_is_zero_copy(rt):
    @rt.remote
    class SelfConsumer:
        def make(self):
            import torch

            self._made = torch.arange(8.0)
            return self._made

        def is_same(self, arr):
            # in-process tier: the arg must be the SAME tensor we stored —
            # no copy, no transfer
            return arr is self._made and arr.data_ptr() == self._made.data_ptr()

    a = _own(SelfConsumer.remote())
    ref = a.make.options(tensor_transport="device").remote()
    assert rt.get(a.is_same.remote(ref), timeout=60) is True


def test_method_decorator_tensor_transport(rt):
    @rt.remote
    class Decorated:
        @ray_tpu_torch.method(tensor_transport="device")
        def make(self):
            import torch

            return torch.full((3,), 5.0)

    d = _own(Decorated.remote())
    ref = d.make.remote()
    w = worker_mod.global_worker()
    got = rt.get(ref, timeout=60)
    np.testing.assert_allclose(got.numpy(), [5.0, 5.0, 5.0])
    assert isinstance(w.memory_store.try_get(ref.id), DeviceValue)


def test_device_object_freed_on_ref_drop(rt):
    """Besides the store's count (the JAX file's check): the producer's
    tensor itself is released, so a card's memory would come back."""

    @rt.remote
    class Producer:
        def make(self):
            import weakref

            import torch

            t = torch.ones((256,))
            self._watch = weakref.ref(t)
            return t

        def store_stats(self):
            from ray_tpu_torch.core import worker as wm

            w = wm.global_worker()
            return w.rpc_device_store_stats(None)

        def alive(self):
            return self._watch() is not None

    p = _own(Producer.remote())
    ref = p.make.options(tensor_transport="device").remote()
    rt.get(ref, timeout=60)
    assert rt.get(p.store_stats.remote()) == {"device_objects": 1, "device_bytes": 1024}
    del ref
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        if rt.get(p.store_stats.remote())["device_objects"] == 0:
            break
        time.sleep(0.2)
    assert rt.get(p.store_stats.remote())["device_objects"] == 0
    deadline = time.monotonic() + 10
    while rt.get(p.alive.remote()) and time.monotonic() < deadline:
        time.sleep(0.2)  # the eager export may hold it a moment longer
    assert not rt.get(p.alive.remote())


def test_device_object_taken_by_an_actor_is_freed_on_ref_drop(rt):
    """A ref passed to another actor's task: once the task is done and the
    driver drops the ref, the producer's store frees it. (The actor sender
    loop used to hold the last task's dependency list until that actor's
    next call.)"""

    @rt.remote
    class Producer:
        def make(self):
            import torch

            return torch.ones((64,))

        def objects(self):
            from ray_tpu_torch.core import worker as wm

            return wm.global_worker().rpc_device_store_stats(None)["device_objects"]

    @rt.remote
    class Consumer:
        def total(self, x):
            return float(x.sum())

    p, c = _own(Producer.remote()), _own(Consumer.remote())
    ref = p.make.options(tensor_transport="device").remote()
    assert rt.get(c.total.remote(ref), timeout=60) == 64.0
    assert rt.get(p.objects.remote()) == 1
    del ref
    deadline = time.monotonic() + 20
    while rt.get(p.objects.remote()) and time.monotonic() < deadline:
        time.sleep(0.2)
    assert rt.get(p.objects.remote()) == 0


def test_non_array_value_falls_back_to_object_path(rt):
    ref = rt.put({"a": 1, "b": "text"}, _tensor_transport="device")
    w = worker_mod.global_worker()
    assert not isinstance(w.memory_store.try_get(ref.id), DeviceValue)
    assert rt.get(ref) == {"a": 1, "b": "text"}
    # a numpy array is not a tensor: the object path too
    arr = np.arange(4.0)
    ref = rt.put({"x": arr}, _tensor_transport="device")
    assert not isinstance(w.memory_store.try_get(ref.id), DeviceValue)
    np.testing.assert_array_equal(rt.get(ref)["x"], arr)


def test_plain_task_device_transport(rt):
    @rt.remote(tensor_transport="device")
    def make(n):
        import torch

        return torch.arange(float(n)) + 1.0

    ref = make.remote(4)
    got = rt.get(ref, timeout=60)
    np.testing.assert_allclose(got.numpy(), [1.0, 2.0, 3.0, 4.0])


# -- overlapped chunked export ---------------------------------------------


def _write_and_readback(arrays, tmp_path, overlap: bool, mod=dev_mod, cfg=config):
    offsets, total = mod.plan_export_layout(arrays)
    path = str(tmp_path / f"seg_{overlap}_{mod.__name__}")
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o600)
    prev = cfg.rdt_d2h_overlap
    try:
        os.ftruncate(fd, total)
        cfg.set("rdt_d2h_overlap", overlap)
        mod.write_arrays_overlapped(fd, arrays, offsets)
    finally:
        cfg.set("rdt_d2h_overlap", prev)
        os.close(fd)
    with open(path, "rb") as f:
        blob = f.read()
    return offsets, blob


def _export_leaves():
    return [
        np.arange(5000.0, dtype=np.float32),          # crosses chunk boundaries below
        np.zeros((0,), dtype=np.float32),             # zero-size leaf
        np.arange(7.0, dtype=np.float32),             # odd size -> padding after
        (np.arange(300.0, dtype=np.float32) * 2).reshape(30, 10),
    ]


def test_overlapped_export_layout_and_bytes(rt, tmp_path):
    """The double-buffered writer must produce byte-identical segments
    to the serial path: multi-leaf, odd sizes (alignment padding), a
    zero-size leaf, chunk boundaries inside a leaf."""
    arrays = [torch.from_numpy(a) for a in _export_leaves()]
    prev_chunk = config.rdt_d2h_chunk_bytes
    try:
        config.set("rdt_d2h_chunk_bytes", 64 * 1024)  # force many chunks
        offsets, blob_overlap = _write_and_readback(arrays, tmp_path, overlap=True)
        offsets2, blob_serial = _write_and_readback(arrays, tmp_path, overlap=False)
    finally:
        config.set("rdt_d2h_chunk_bytes", prev_chunk)
    assert offsets == offsets2
    assert blob_overlap == blob_serial
    # every offset 64B-aligned, every leaf's bytes land at its offset
    for a, off in zip(arrays, offsets):
        assert off % 64 == 0
        expect = _bits(a)
        assert blob_overlap[off:off + len(expect)] == expect


def test_export_segment_equals_the_jax_packages(tmp_path):
    """For the same data, the port's export (torch tensors) and the JAX
    package's (jax arrays on the CPU) write the same segment, byte for
    byte, at the same offsets, serial and overlapped."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from ray_tpu.core import device_objects as jax_dev
    from ray_tpu.utils.config import config as jax_config

    leaves = _export_leaves() + [np.arange(-6, 6, dtype=np.int32).reshape(3, 4),
                                 np.float32(2.5)]
    for overlap in (True, False):
        want = _write_and_readback([jnp.asarray(a) for a in leaves], tmp_path, overlap,
                                   jax_dev, jax_config)
        got = _write_and_readback([torch.from_numpy(np.asarray(a)) for a in leaves],
                                  tmp_path, overlap)
        assert got == want


def test_bf16_leaf_bits_survive_the_export(rt, tmp_path):
    """numpy has no bfloat16: a bf16 leaf crosses as its bits and comes
    back a bf16 tensor, bitwise; its segment bytes are the tensor's own."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(33, 17, generator=gen).to(torch.bfloat16)
    x[0, :4] = torch.tensor([float("inf"), float("-inf"), float("nan"), -0.0])
    offsets, blob = _write_and_readback([x], tmp_path, overlap=True)
    assert blob[offsets[0]:offsets[0] + x.nbytes] == _bits(x)
    (back,) = dev_mod.device_put(memoryview(blob), offsets, [((33, 17), "bfloat16", "cpu")])
    assert back.dtype == torch.bfloat16 and _bits(back) == _bits(x)

    @rt.remote
    class Producer:
        def make(self, seed):
            import torch

            g = torch.Generator().manual_seed(seed)
            w = torch.randn(33, 17, generator=g).to(torch.bfloat16)
            w[0, :4] = torch.tensor([float("inf"), float("-inf"), float("nan"), -0.0])
            return {"w": w, "f32": torch.arange(5.0)}

    @rt.remote
    class Consumer:
        def bits(self, tree):
            import torch

            w = tree["w"]
            assert w.dtype == torch.bfloat16 and w.device.type == "cpu"
            return w.reshape(-1).view(torch.uint8).numpy().tobytes()

    p, c = _own(Producer.remote()), _own(Consumer.remote())
    ref = p.make.options(tensor_transport="device").remote(0)
    assert rt.get(c.bits.remote(ref), timeout=60) == _bits(x)
    got = rt.get(ref, timeout=60)  # the driver's fetch rides the same segment
    assert got["w"].dtype == torch.bfloat16 and _bits(got["w"]) == _bits(x)
    assert worker_mod.global_worker().memory_store.try_get(ref.id).leaves_meta == [
        ((33, 17), "bfloat16", "cpu"), ((5,), "float32", "cpu")]


def test_state_dict_containers_round_trip(rt):
    """A state dict (an OrderedDict of tensors) with a list, a tuple, a
    namedtuple and plain leaves around it comes back with the same types,
    keys, order and values; the tensors are the consumer's own, writable."""

    @rt.remote
    class Producer:
        def make(self):
            from collections import OrderedDict, namedtuple

            import torch

            Pair = namedtuple("Pair", "a b")
            sd = torch.nn.Linear(3, 2).state_dict()
            return {"sd": sd, "extra": [torch.zeros(2, dtype=torch.int64), 3, None],
                    "pair": Pair(torch.ones(1), "x"), "t": (1.5, torch.eye(2)),
                    "od": OrderedDict(z=1, a=2)}

    p = _own(Producer.remote())
    got = rt.get(p.make.options(tensor_transport="device").remote(), timeout=60)
    assert type(got["sd"]) is OrderedDict and list(got["sd"]) == ["weight", "bias"]
    assert got["sd"]["weight"].shape == (2, 3)
    assert got["extra"][1:] == [3, None] and got["extra"][0].dtype == torch.int64
    assert type(got["pair"]).__name__ == "Pair" and got["pair"].b == "x"
    assert isinstance(got["t"], tuple) and got["t"][0] == 1.5
    assert torch.equal(got["t"][1], torch.eye(2))
    assert got["od"] == OrderedDict(z=1, a=2)
    got["sd"]["bias"].add_(1.0)  # a tensor of its own: no read-only shm view


def test_cuda_leaf_without_a_card_raises(monkeypatch):
    """A consumer that sees no card raises on a CUDA leaf; it does not
    carry on with a CPU tensor. A CPU leaf still comes back on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seg = memoryview(np.arange(16, dtype=np.float32).tobytes())
    with pytest.raises(RuntimeError, match="sees no card"):
        dev_mod.device_put(seg, [0], [((16,), "float32", "cuda")])
    (t,) = dev_mod.device_put(seg, [0], [((16,), "float32", "cpu")])
    assert t.device.type == "cpu" and torch.equal(t, torch.arange(16.0))


def test_overlapped_export_producer_error_propagates(rt, tmp_path):
    """An exploding leaf conversion surfaces in the caller, not a hang."""

    class Boom:
        nbytes = 128

        def __array__(self, dtype=None):
            raise RuntimeError("d2h exploded")

    arrays = [torch.arange(10.0), Boom()]
    offsets, total = dev_mod.plan_export_layout(arrays)
    path = str(tmp_path / "boom")
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o600)
    try:
        os.ftruncate(fd, total)
        with pytest.raises(RuntimeError, match="d2h exploded"):
            dev_mod.write_arrays_overlapped(fd, arrays, offsets)
    finally:
        os.close(fd)


def test_eager_export_caches_segment(rt):
    """With rdt_eager_export on (default), the consumer's first export
    RPC finds the producer-side export already built (or joins it) —
    and the bytes are right."""

    @rt.remote
    class P:
        def make(self, n):
            import torch

            return torch.arange(float(n))

        def export_cached(self):
            from ray_tpu_torch.core import worker as worker_mod

            w = worker_mod.global_worker()
            with w._device_exports_lock:
                return [
                    k for k, v in w._device_exports.items()
                    if isinstance(v, dict)
                ]

    p = _own(P.remote())
    ref = p.make.options(tensor_transport="device").remote(1024)
    rt.wait([ref], num_returns=1, timeout=60)
    deadline = time.monotonic() + 15
    cached = []
    while time.monotonic() < deadline and not cached:
        cached = rt.get(p.export_cached.remote(), timeout=30)
        time.sleep(0.1)
    assert cached, "eager export never landed in the cache"
    got = rt.get(ref, timeout=60)  # driver fetch rides the cached segment
    np.testing.assert_allclose(got.numpy(), np.arange(1024.0))
