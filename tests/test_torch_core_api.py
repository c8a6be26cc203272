"""The port's core runtime (``ray_tpu_torch.core``, a pinned copy of
``ray_tpu.core``) on the CPU: the functional contracts of
``tests/test_core_api.py`` on one module-scoped port cluster, plus what the
port changes: the GPU probe of ``accelerators/``, num_gpus on cards, and the
API boundary of the device transport. ``test_parallel_tasks`` and the first-item latency bound of
``test_streaming_generator`` are wall-clock checks and are left to the JAX
file."""

import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.accelerators import detect_node_resources_and_labels
from ray_tpu_torch.accelerators.gpu import Card
from ray_tpu_torch.core import cluster_utils


@pytest.fixture(scope="module")
def rt():
    # the port's daemons and files left by a killed run, as tests/conftest.py
    # sweeps the JAX package's: each sweep matches only its own runtime's
    cluster_utils.sweep_stale_runtime()
    # two cards declared on a host that has none: a GPU lease's worker is
    # spawned seeing its card's id, which is all the CPU can check
    ray_tpu_torch.init(num_cpus=4, num_gpus=2)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_put_get_small(rt):
    ref = rt.put({"a": 1, "b": [1, 2, 3]})
    assert rt.get(ref) == {"a": 1, "b": [1, 2, 3]}


def test_put_get_large_numpy_zero_copy(rt):
    arr = np.arange(1 << 20, dtype=np.float32)  # 4 MB -> plasma path
    out = rt.get(rt.put(arr))
    np.testing.assert_array_equal(out, arr)
    assert not out.flags.writeable  # backed by a read-only shm mapping


def test_simple_task(rt):
    @rt.remote
    def add(a, b):
        return a + b

    assert rt.get(add.remote(2, 3)) == 5


def test_task_with_ref_args(rt):
    @rt.remote
    def mul(a, b):
        return a * b

    y = mul.remote(rt.put(6), 7)
    assert rt.get(y) == 42
    assert rt.get(mul.remote(y, 2)) == 84


def test_task_exception_propagates(rt):
    @rt.remote
    def boom():
        raise ValueError("bad input")

    with pytest.raises(ray_tpu_torch.exceptions.TaskError, match="bad input"):
        rt.get(boom.remote())


def test_multiple_returns(rt):
    @rt.remote(num_returns=3)
    def three():
        return 1, 2, 3

    a, b, c = three.remote()
    assert rt.get([a, b, c]) == [1, 2, 3]


def test_wait(rt):
    @rt.remote
    def sleepy(t):
        import time

        time.sleep(t)
        return t

    fast, slow = sleepy.remote(0.05), sleepy.remote(2.0)
    ready, pending = rt.wait([fast, slow], num_returns=1, timeout=3.0)
    assert ready == [fast] and pending == [slow]


def test_get_timeout(rt):
    @rt.remote
    def forever():
        import time

        time.sleep(8)

    with pytest.raises(ray_tpu_torch.exceptions.GetTimeoutError):
        rt.get(forever.remote(), timeout=0.3)


def test_nested_tasks(rt):
    @rt.remote
    def inner(x):
        return x * 2

    @rt.remote
    def outer(x):
        import ray_tpu_torch as rt2

        return rt2.get(inner.remote(x)) + 1

    assert rt.get(outer.remote(10)) == 21


def test_options_override(rt):
    @rt.remote
    def ident(x):
        return x

    assert rt.get(ident.options(num_cpus=2, name="renamed").remote(5)) == 5


def test_task_retry_on_worker_crash(rt):
    @rt.remote(max_retries=2)
    def crashy(attempt_key):
        import os

        from ray_tpu_torch.core import worker

        # the first execution writes the flag in the control store's KV and dies
        seen = worker.global_worker().control.call(
            "kv_put", ns="test", key=attempt_key, value=b"1", overwrite=False)
        if seen:
            os._exit(1)
        return "survived"

    assert rt.get(crashy.remote("crash-once"), timeout=60) == "survived"


def test_cluster_resources(rt):
    total = rt.cluster_resources()
    assert total.get("CPU") == 4.0
    assert "TPU" not in total


def test_num_gpus_is_refused_naming_the_roadmap(rt):
    """num_gpus asks for cards, as the JAX package's asks for TPU chips: a
    task with num_gpus=1 runs in a worker that sees one card of the node's
    two, a task without sees none, and num_tpus, which no node of the port
    has, is refused as an option of a task and of an actor."""
    import os

    def visible():
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    class A:
        def ping(self):
            return 1

    assert rt.cluster_resources().get("GPU") == 2.0
    assert rt.get(rt.remote(num_gpus=1)(visible).remote(), timeout=60) in ("0", "1")
    assert rt.get(rt.remote(visible).options(num_gpus=0.5).remote(), timeout=60) in ("0", "1")
    assert rt.get(rt.remote(visible).remote(), timeout=60) == ""
    with pytest.raises(ValueError, match="num_tpus"):
        rt.remote(num_tpus=1)(visible)
    with pytest.raises(ValueError, match="num_tpus"):
        rt.remote(visible).options(num_tpus=1)
    with pytest.raises(ValueError, match="num_tpus"):
        rt.remote(num_tpus=1)(A).remote()


def test_streaming_generator(rt):
    """num_returns="streaming": the items in order, the first read while the
    task is still yielding."""

    @rt.remote(num_returns="streaming")
    def produce(n):
        import time

        import numpy as np

        for i in range(n):
            yield {"i": i, "big": np.full(50_000, i, dtype=np.int64)}
            time.sleep(0.3)

    gen = produce.remote(6)
    first = rt.get(next(gen), timeout=60)
    assert first["i"] == 0 and int(first["big"][0]) == 0
    rest = [rt.get(r, timeout=60) for r in gen]
    assert [x["i"] for x in rest] == [1, 2, 3, 4, 5]
    assert gen.completed()


def test_streaming_generator_error(rt):
    @rt.remote(num_returns="streaming", max_retries=0)
    def flaky():
        yield 1
        raise ValueError("stream kaboom")

    gen = flaky.remote()
    assert rt.get(next(gen), timeout=60) == 1
    with pytest.raises(Exception, match="stream kaboom"):
        next(gen)


def test_device_transport_is_refused_naming_the_roadmap(rt):
    """The API boundary refuses an unknown transport before anything is
    stored. The device transport itself is ported (tests/test_torch_rdt.py)
    and is no longer refused: a value with no tensor under it takes the
    object path."""
    ref = rt.put(np.zeros(4), _tensor_transport="device")
    np.testing.assert_array_equal(rt.get(ref), np.zeros(4))
    assert rt.method(tensor_transport="device") is not None
    with pytest.raises(ValueError, match="unknown tensor_transport"):
        rt.put(1, _tensor_transport="bogus")
    with pytest.raises(ValueError, match="unknown tensor_transport"):
        rt.method(tensor_transport="bogus")
    assert rt.get(rt.put(7, _tensor_transport="object")) == 7


def test_history_and_alerts_answer_at_the_default_interval(rt):
    """The control store starts the metrics history and the alert engine
    at the default sample interval, and the state API reads both."""
    from ray_tpu_torch import state
    from ray_tpu_torch.utils.config import config

    assert float(config.metrics_sample_interval_s) > 0 and bool(config.alerts_enabled)
    deadline = time.monotonic() + 30
    while state.metrics_history().get("ticks", 0) < 1 and time.monotonic() < deadline:
        time.sleep(0.2)
    inv = state.metrics_history()
    assert inv["enabled"] and inv["ticks"] >= 1, inv
    alerts = state.alerts()
    assert alerts["enabled"] and {a["name"] for a in alerts["alerts"]} >= {
        "serve_ttft_p95_burn", "node_heartbeat_missed"}


H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("visible, cards, want", [
    (None, [], None),
    ("1", [Card(0, "GPU-aaaa", H100), Card(1, "GPU-bbbb", H100)], 1.0),
    (None, [Card(0, "GPU-aaaa", H100), Card(1, "GPU-bbbb", H100)], 2.0),
    ("", [Card(0, "GPU-aaaa", H100)], None),
    ("GPU-bb,0,7,1", [Card(0, "GPU-aaaa", H100), Card(1, "GPU-bbbb", H100)], 2.0),
], ids=["no-card", "two-cards-one-visible", "two-cards", "none-visible", "uuid-then-invalid"])
def test_gpu_probe(monkeypatch, visible, cards, want):
    """No card gives no GPU resource; CUDA_VISIBLE_DEVICES restricts the
    cards as CUDA does (indices or UUID prefixes, up to the first entry
    that names no card); the card's name is the accelerator-type label."""
    if visible is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    resources, labels = detect_node_resources_and_labels(probe=lambda: cards)
    assert resources.get("GPU") == want
    assert labels == ({"accelerator-type": H100} if want else {})
    assert resources["CPU"] >= 1 and resources["memory"] > 0
