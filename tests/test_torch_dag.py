"""The port's compiled graphs (``ray_tpu_torch.dag``) and channels
(``ray_tpu_torch.core.channels``) on one module-scoped port cluster on the
CPU: the contracts of ``tests/test_dag.py`` and ``tests/test_native_channel.py``
re-run on the port. The port's channel segments are ``rttchan_*``, never the
JAX runtime's ``rtchan_*``.

The wall-clock ratio of ``test_dag.py::test_compiled_path_beats_rpc_path``
is not asserted here: ``chip_smoke.py`` prints it on the card.
"""

import logging
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import native
from ray_tpu_torch.core import cluster_utils
from ray_tpu_torch.core.channels import ShmChannel
from ray_tpu_torch.dag import _STOP, InputNode, MultiOutputNode, _is_stop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def rt():
    cluster_utils.sweep_stale_runtime()
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
class Adder:
    def __init__(self, delta):
        self.delta = delta

    def add(self, x):
        return x + self.delta

    def slow_add(self, x):
        time.sleep(6.0)
        return x + self.delta

    def boom(self, x):
        raise ValueError("boom")


# -- compiled graphs (tests/test_dag.py) -------------------------------------


def test_lazy_subpackage():
    import ray_tpu_torch.dag as dag_mod

    assert ray_tpu_torch.dag is dag_mod


def test_single_actor_chain(rt):
    a = Adder.remote(10)
    with InputNode() as inp:
        dag = a.add.bind(inp)
    cdag = dag.experimental_compile()
    try:
        assert cdag.execute(1).get() == 11
        assert cdag.execute(2).get() == 12
        for i in range(50):  # channel reuse across many rounds
            assert cdag.execute(i).get() == i + 10
    finally:
        cdag.teardown()


def test_two_actor_chain(rt):
    a = Adder.remote(1)
    b = Adder.remote(100)
    with InputNode() as inp:
        dag = b.add.bind(a.add.bind(inp))
    cdag = dag.experimental_compile()
    try:
        assert cdag.execute(5).get() == 106
        assert cdag.execute(6).get() == 107
    finally:
        cdag.teardown()


def test_multi_output(rt):
    a = Adder.remote(1)
    b = Adder.remote(2)
    with InputNode() as inp:
        dag = MultiOutputNode([a.add.bind(inp), b.add.bind(inp)])
    cdag = dag.experimental_compile()
    try:
        assert cdag.execute(10).get() == [11, 12]
    finally:
        cdag.teardown()


def test_error_propagates_and_dag_survives(rt):
    a = Adder.remote(1)
    b = Adder.remote(2)
    with InputNode() as inp:
        dag = b.add.bind(a.boom.bind(inp))
    cdag = dag.experimental_compile()
    try:
        for x in (1, 2):  # the loop keeps serving after an application error
            with pytest.raises(ValueError, match="boom"):
                cdag.execute(x).get()
    finally:
        cdag.teardown()


def test_actor_usable_after_teardown(rt):
    a = Adder.remote(5)
    with InputNode() as inp:
        dag = a.add.bind(inp)
    cdag = dag.experimental_compile()
    assert cdag.execute(1).get() == 6
    cdag.teardown()
    assert rt.get(a.add.remote(10), timeout=30) == 15


def test_constant_args(rt):
    @rt.remote
    class Mixer:
        def mix(self, x, y, z):
            return (x, y, z)

    m = Mixer.remote()
    with InputNode() as inp:
        dag = m.mix.bind(inp, "const", 3)
    cdag = dag.experimental_compile()
    try:
        assert cdag.execute(1).get() == (1, "const", 3)
    finally:
        cdag.teardown()


def test_numpy_payload_through_two_actors(rt):
    """A payload past the scatter-gather threshold rides out of band."""
    a = Adder.remote(1)
    b = Adder.remote(2)
    with InputNode() as inp:
        dag = b.add.bind(a.add.bind(inp))
    cdag = dag.experimental_compile(channel_capacity=1 << 20)
    try:
        x = np.arange(50_000, dtype=np.float32)
        np.testing.assert_array_equal(cdag.execute(x).get(), x + 3)
    finally:
        cdag.teardown()


def test_teardown_with_unconsumed_results(rt):
    """teardown() must not wedge the actor when rounds were never consumed;
    the actor serves normal calls afterwards."""
    a = Adder.remote(1)
    with InputNode() as inp:
        dag = a.add.bind(inp)
    cdag = dag.experimental_compile()
    cdag.execute(1)
    cdag.execute(2)  # two unconsumed rounds: exec loop blocked on write
    t0 = time.monotonic()
    cdag.teardown()
    assert time.monotonic() - t0 < 30.0, "teardown stalled"
    assert rt.get(a.add.remote(10), timeout=60) == 11


@pytest.mark.parametrize("max_inflight", [None, 4])
def test_execute_inflight_bound(rt, max_inflight):
    """Unconsumed rounds beyond max_inflight (default 2) raise instead of
    blocking inside execute()."""
    a = Adder.remote(1)
    with InputNode() as inp:
        dag = a.add.bind(inp)
    n = max_inflight or 2
    cdag = (dag.experimental_compile() if max_inflight is None
            else dag.experimental_compile(max_inflight=max_inflight))
    try:
        refs = [cdag.execute(i) for i in range(n)]
        with pytest.raises(RuntimeError, match="unconsumed"):
            cdag.execute(99)
        assert [r.get() for r in refs] == list(range(1, n + 1))
        assert cdag.execute(10).get() == 11  # drained: capacity back
    finally:
        cdag.teardown()


def test_compile_rejects_bad_bounds(rt):
    a = Adder.remote(1)
    with InputNode() as inp:
        dag = a.add.bind(inp)
    with pytest.raises(ValueError, match="max_inflight"):
        dag.experimental_compile(max_inflight=0)
    with pytest.raises(ValueError, match="channel_slots"):
        dag.experimental_compile(channel_slots=0)


def test_teardown_warns_and_unlinks_on_wedged_loop(rt, caplog):
    """A loop stuck in user code past the drain deadline: teardown says so
    and still unlinks every channel."""
    a = Adder.remote(1)
    with InputNode() as inp:
        dag = a.slow_add.bind(inp)
    cdag = dag.experimental_compile()
    paths = [ch.path for ch in (cdag._input_channels + cdag._output_channels
                                + cdag._edge_channels)]
    assert paths and all(os.path.basename(p).startswith("rttchan_") for p in paths)
    cdag.execute(1)
    time.sleep(0.3)  # the loop is now inside slow_add's sleep
    with caplog.at_level(logging.WARNING, logger="ray_tpu_torch.dag"):
        t0 = time.monotonic()
        cdag.teardown(timeout_s=1.5)
        assert time.monotonic() - t0 < 6.0
    assert "still running" in caplog.text
    for p in paths:
        assert not os.path.exists(p), f"teardown leaked {p}"
        assert not os.path.exists(p + ".d"), f"teardown leaked {p}.d"


def test_multi_actor_edge_channels_unlinked(rt):
    a = Adder.remote(1)
    b = Adder.remote(2)
    with InputNode() as inp:
        dag = b.add.bind(a.add.bind(inp))
    cdag = dag.experimental_compile()
    assert len(cdag._edge_channels) == 1  # the a->b hop
    paths = [ch.path for ch in cdag._edge_channels]
    assert cdag.execute(1).get() == 4
    cdag.teardown()
    for p in paths:
        assert not os.path.exists(p), f"edge channel leaked {p}"


def test_shm_channel_between_two_actors(rt):
    """A channel handed to two actors: messages arrive in order."""

    @rt.remote
    class Producer:
        def __init__(self, handle):
            self.ch = ShmChannel.from_handle(handle)

        def send(self, n):
            for i in range(n):
                self.ch.write(f"msg-{i}".encode())
            return True

    @rt.remote
    class Consumer:
        def __init__(self, handle):
            self.ch = ShmChannel.from_handle(handle)

        def recv(self, n):
            return [self.ch.read(timeout_s=30).decode() for _ in range(n)]

    ch = ShmChannel.create(capacity=1024)
    try:
        prod = Producer.remote(ch.handle())
        cons = Consumer.remote(ch.handle())
        recv_ref = cons.recv.remote(50)
        assert rt.get(prod.send.remote(50), timeout=60)
        assert rt.get(recv_ref, timeout=60) == [f"msg-{i}" for i in range(50)]
    finally:
        ch.close(unlink=True)


# -- channels (tests/test_native_channel.py) ---------------------------------


def test_native_core_builds():
    if native.channel_lib() is None:
        pytest.skip("no native toolchain in this environment")


def test_channel_segments_carry_the_port_prefix():
    ch = ShmChannel.create(4096)
    try:
        assert os.path.basename(ch.path).startswith("rttchan_")
        assert os.path.exists(ch.path)
    finally:
        ch.close(unlink=True)
    assert not os.path.exists(ch.path)


def test_roundtrip_and_flow_control():
    ch = ShmChannel.create(1 << 20)
    rd = ShmChannel.from_handle(ch.handle())
    try:
        ch.write(b"hello")
        assert rd.read(10.0) == b"hello"
        payload = os.urandom(300_000)
        ch.write(payload)
        assert rd.read(10.0) == payload
        ch.write(b"a")
        with pytest.raises(TimeoutError):
            ch.write(b"b", timeout_s=0.2)  # unconsumed slot blocks the writer
        assert rd.read(10.0) == b"a"
        ch.write(b"b")
        assert rd.read(10.0) == b"b"
        with pytest.raises(ValueError):
            ch.write(b"x" * ((1 << 20) + 1))
    finally:
        rd.close()
        ch.close(unlink=True)


def test_message_written_before_attach_is_delivered():
    ch = ShmChannel.create(4096)
    try:
        ch.write(b"early")
        late = ShmChannel.from_handle(ch.handle())
        try:
            assert late.read(10.0) == b"early"
        finally:
            late.close()
    finally:
        ch.close(unlink=True)


def test_multi_slot_ring_wrap():
    ch = ShmChannel.create(4096, slots=3)
    rd = ShmChannel.from_handle(ch.handle())
    try:
        for m in (b"m0", b"m1", b"m2"):
            ch.write(m)
        with pytest.raises(TimeoutError):
            ch.write(b"m3", timeout_s=0.2)  # ring full
        assert rd.read(5.0) == b"m0"
        ch.write(b"m3", timeout_s=5.0)  # one slot freed
        assert [rd.read(5.0) for _ in range(3)] == [b"m1", b"m2", b"m3"]
        for i in range(40):  # many wraps of the 3-slot ring
            ch.write(f"w{i}".encode())
            assert rd.read(5.0) == f"w{i}".encode()
    finally:
        rd.close()
        ch.close(unlink=True)


def test_reader_behind_writer_delivers_in_order():
    ch = ShmChannel.create(4096, slots=4)
    try:
        for m in (b"a", b"b", b"c"):
            ch.write(m)
        late = ShmChannel.from_handle(ch.handle())
        try:
            assert late.read(5.0) == b"a"
            ch.write(b"d")
            ch.write(b"e")
            assert [late.read(5.0) for _ in range(4)] == [b"b", b"c", b"d", b"e"]
        finally:
            late.close()
    finally:
        ch.close(unlink=True)


def test_stop_sentinel_delivered_behind_inflight_slots():
    ch = ShmChannel.create(4096, slots=4)
    rd = ShmChannel.from_handle(ch.handle())
    try:
        ch.write_value({"round": 1})
        ch.write_value({"round": 2})
        ch.write(_STOP)
        assert rd.read_value(5.0) == {"round": 1}
        assert rd.read_value(5.0) == {"round": 2}
        assert _is_stop(rd.read(5.0))
    finally:
        rd.close()
        ch.close(unlink=True)


def test_write_value_scatter_gather_roundtrip():
    ch = ShmChannel.create(1 << 20, slots=2)
    rd = ShmChannel.from_handle(ch.handle())
    try:
        for i in range(6):
            x = {"i": i, "arr": np.arange(i * 1000 + 7, dtype=np.int64)}
            ch.write_value(x)
            got = rd.read_value(5.0)
            assert got["i"] == i
            np.testing.assert_array_equal(got["arr"], x["arr"])
    finally:
        rd.close()
        ch.close(unlink=True)


def _echo_peer_script(path, cap, env_native, slots):
    return (
        f"import os, sys\n"
        f"os.environ['RT_NATIVE'] = {env_native!r}\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"from ray_tpu_torch.core.channels import ShmChannel\n"
        f"a = ShmChannel.attach({path + '_in'!r}, {cap}, slots={slots})\n"
        f"b = ShmChannel.attach({path + '_out'!r}, {cap}, slots={slots})\n"
        f"for i in range(20):\n"
        f"    b.write(b'echo:' + a.read(30.0))\n"
        f"a.close(); b.close()\n"
    )


@pytest.mark.parametrize("peer_native", ["1", "0"])
@pytest.mark.parametrize("slots", [1, 3])
def test_cross_process_echo_mixed_tiers(tmp_path, peer_native, slots):
    """A subprocess peer on the native or the Python tier: the ring layout
    interoperates both ways."""
    base = str(tmp_path / "chan")
    cap = 1 << 16
    a = ShmChannel(base + "_in", cap, create=True, slots=slots)
    b = ShmChannel(base + "_out", cap, create=True, slots=slots)
    proc = subprocess.Popen([sys.executable, "-c",
                             _echo_peer_script(base, cap, peer_native, slots)])
    try:
        for i in range(20):
            msg = f"m{i}".encode()
            a.write(msg, timeout_s=30.0)
            assert b.read(30.0) == b"echo:" + msg
        assert proc.wait(timeout=30) == 0
    finally:
        proc.kill()
        a.close(unlink=True)
        b.close(unlink=True)
