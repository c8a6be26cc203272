"""The port's host collectives (``ray_tpu_torch.collective``) on one
module-scoped port cluster on the CPU: the contracts of
``tests/test_collective.py`` (allreduce, allgather, broadcast,
reducescatter, send and recv) on torch CPU tensors and on numpy arrays,
the pure-python packing and spec tests of ``tests/test_grad_sync.py``
(held to the JAX package's packer on the same leaves), and the bucketed
``grad_sync`` against the exact f64 sum on a tree of torch f32, bf16 and
int64 leaves.

What comes back is what the JAX package hands back: numpy arrays. A torch
tensor goes on the wire as a host copy (``collective._host_array``); a bf16
tensor is widened to f32 there, so its sum comes back as f32, rounded
once per add in f32 (JAX's comes back as bf16, rounded to 2^-8 at each
add).

The module names no ``ray_tpu`` module among its globals: its actor class
is pickled by value, with the modules its globals name (tests import the
JAX package inside the functions that use it).
"""

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.core import cluster_utils

WORLD = 2
SEED = 7
# Two ranks: each f32 add is rounded once (2^-24 relative), and /2 is
# exact; the bf16 leaf is widened to f32 exactly before the wire, so it
# is held to the same limit. The f64 reference is exact.
SUM_RTOL = 1e-6
RING_ELEMS = 100_000  # 400 kB of f32: above collective_p2p_min_bytes (32 KiB), on the ring


def _tensor(kind, arr):
    return torch.from_numpy(np.ascontiguousarray(arr)) if kind == "torch" else arr


def _tree(rank, seed=SEED):
    """Per-rank gradient tree of torch leaves: f32 kernels on the ring and
    biases under the p2p floor, a bf16 leaf, an int64 leaf, and one numpy
    leaf beside them."""
    rng = np.random.default_rng(seed + rank)

    def f32(*shape):
        return torch.from_numpy(rng.uniform(-1.0, 1.0, shape).astype(np.float32))

    return {
        "layer0": {"kernel": f32(64, 256), "bias": f32(256)},
        "layer1": {"kernel": f32(256, 300).to(torch.bfloat16), "bias": f32(300)},
        "head": [f32(300, 3), rng.uniform(-1.0, 1.0, 3).astype(np.float32)],
        "steps": torch.tensor([rank + 1], dtype=torch.int64),
    }


def _exact(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.to(torch.float64).numpy()
    return np.asarray(leaf, dtype=np.float64)


@pytest.fixture(scope="module")
def rt():
    cluster_utils.sweep_stale_runtime()
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
class Member:
    def __init__(self, rank, world):
        self.rank, self.world = rank, world

    def setup(self, group):
        from ray_tpu_torch import collective

        collective.init_collective_group(self.world, self.rank, "cpu", group)
        return True

    def do_allreduce(self, group, kind, n=4):
        from ray_tpu_torch import collective

        return collective.allreduce(_tensor(kind, np.full((n,), self.rank + 1.0)),
                                    group_name=group)

    def p2p_stats(self):
        from ray_tpu_torch.collective import p2p

        return p2p.snapshot_stats()

    def do_allreduce_bf16(self, group, n):
        from ray_tpu_torch import collective

        x = torch.full((n,), 0.5 * (self.rank + 1), dtype=torch.bfloat16)
        return collective.allreduce(x, group_name=group)

    def do_allgather(self, group, kind):
        from ray_tpu_torch import collective

        return collective.allgather(_tensor(kind, np.array([self.rank])), group_name=group)

    def do_broadcast(self, group, kind):
        from ray_tpu_torch import collective

        x = np.arange(3.0) if self.rank == 0 else np.zeros(3)
        return collective.broadcast(_tensor(kind, x), 0, group)

    def do_reducescatter(self, group, kind):
        from ray_tpu_torch import collective

        return collective.reducescatter(_tensor(kind, np.ones((4, 2))), group_name=group)

    def do_sendrecv(self, group, kind, n=1):
        from ray_tpu_torch import collective

        if self.rank == 0:
            collective.send(_tensor(kind, np.arange(n, dtype=np.float32) + 42.0), 1, group)
            return None
        return collective.recv(0, group)

    def grad_sync(self, group, bucket_kib=64):
        from ray_tpu_torch.collective import bucketed

        tree = _tree(self.rank)
        h = bucketed.GradSync(group, bucket_bytes=bucket_kib * 1024)
        h.push(tree)
        out = h.join()
        # the caller's tensors are where they were, and unchanged
        same = all(torch.equal(a, b) for a, b in zip(
            (tree["layer0"]["kernel"], tree["layer1"]["kernel"]),
            (_tree(self.rank)["layer0"]["kernel"], _tree(self.rank)["layer1"]["kernel"])))
        return out, dict(h.stats), same

    def grad_sync_without_a_group(self):
        """grad_sync with no group (one worker) passes through locally and
        still hands back numpy arrays."""
        from ray_tpu_torch.collective import bucketed

        out = bucketed.GradSync(None).push(_tree(self.rank)).join()
        return out


@pytest.fixture(scope="module")
def members(rt):
    ms = [Member.remote(i, WORLD) for i in range(WORLD)]
    rt.get([m.setup.remote("g") for m in ms], timeout=120)
    return ms


KINDS = ("numpy", "torch")


@pytest.mark.parametrize("kind", KINDS)
def test_allreduce_and_allgather(rt, members, kind):
    out = rt.get([m.do_allreduce.remote("g", kind) for m in members], timeout=60)
    assert all(isinstance(o, np.ndarray) for o in out)
    np.testing.assert_array_equal(out[0], np.full((4,), 3.0))
    np.testing.assert_array_equal(out[0], out[1])

    gathered = rt.get([m.do_allgather.remote("g", kind) for m in members], timeout=60)
    assert [int(g[0]) for g in gathered[0]] == [0, 1]


@pytest.mark.parametrize("kind", KINDS)
def test_allreduce_on_the_ring(rt, members, kind):
    """A payload above the p2p floor rides the ring, not the KV fallback."""
    before = rt.get(members[0].p2p_stats.remote())
    out = rt.get([m.do_allreduce.remote("g", kind, RING_ELEMS) for m in members], timeout=60)
    sent = rt.get(members[0].p2p_stats.remote())["bytes_sent"] - before["bytes_sent"]
    assert sent >= RING_ELEMS * 8 // WORLD  # f64: half the tensor, each ring phase
    np.testing.assert_array_equal(out[0], np.full((RING_ELEMS,), 3.0))
    np.testing.assert_array_equal(out[0], out[1])


@pytest.mark.parametrize("n", [4, RING_ELEMS])
def test_allreduce_bf16_comes_back_as_f32(rt, members, n):
    out = rt.get([m.do_allreduce_bf16.remote("g", n) for m in members], timeout=60)
    for o in out:
        assert o.dtype == np.float32 and o.shape == (n,)
        np.testing.assert_array_equal(o, np.full((n,), 1.5, np.float32))


@pytest.mark.parametrize("kind", KINDS)
def test_broadcast_reducescatter_sendrecv(rt, members, kind):
    out = rt.get([m.do_broadcast.remote("g", kind) for m in members], timeout=60)
    np.testing.assert_array_equal(out[1], np.arange(3))

    rs = rt.get([m.do_reducescatter.remote("g", kind) for m in members], timeout=60)
    assert rs[0].shape == (2, 2)
    np.testing.assert_array_equal(rs[0], np.full((2, 2), 2.0))

    for n in (1, RING_ELEMS):  # the KV path and the direct p2p path
        sr = rt.get([m.do_sendrecv.remote("g", kind, n) for m in members], timeout=60)
        np.testing.assert_array_equal(sr[1], np.arange(n, dtype=np.float32) + 42.0)


def test_bucketed_grad_sync_equals_the_exact_sum(rt, members):
    from ray_tpu_torch.collective.bucketed import _flatten

    got = rt.get([m.grad_sync.remote("g") for m in members], timeout=120)
    (out0, stats0, same0), (out1, _, same1) = got
    assert same0 and same1
    assert stats0["buckets"] >= 3 and stats0["bytes"] > 0
    leaves0, spec0 = _flatten(out0)
    leaves1, spec1 = _flatten(out1)
    assert spec0 == spec1 == _flatten(_tree(0))[1]
    inputs = [_flatten(_tree(r))[0] for r in range(WORLD)]
    for i, (a, b) in enumerate(zip(leaves0, leaves1)):
        assert isinstance(a, np.ndarray)
        np.testing.assert_array_equal(a, b)  # every rank adopts the same bits
        want = sum(_exact(rank_leaves[i]) for rank_leaves in inputs) / WORLD
        np.testing.assert_allclose(a.astype(np.float64), want, rtol=SUM_RTOL, atol=0)
    by_name = dict(zip(["head0", "head1", "l0b", "l0k", "l1b", "l1k", "steps"], leaves0))
    assert by_name["l1k"].dtype == np.float32  # the bf16 leaf, widened
    assert by_name["l0k"].dtype == np.float32
    assert by_name["steps"].tolist() == [1.5]  # int64 summed exactly, then averaged


def test_single_worker_grad_sync_passes_through(rt, members):
    from ray_tpu_torch.collective.bucketed import _flatten

    out = rt.get(members[0].grad_sync_without_a_group.remote(), timeout=60)
    for got, want in zip(_flatten(out)[0], _flatten(_tree(0))[0]):
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got.astype(np.float64), _exact(want))


# ---------------------------------------------------------------------------
# No cluster: the wire helper, packing and the pytree spec
# ---------------------------------------------------------------------------


def test_host_array_copies_and_leaves_the_tensor_alone():
    from ray_tpu_torch.collective.collective import _host_array

    t = torch.arange(6, dtype=torch.float32, requires_grad=True).reshape(2, 3)
    a = _host_array(t)
    assert isinstance(a, np.ndarray) and a.dtype == np.float32 and a.shape == (2, 3)
    with torch.no_grad():
        t.add_(1.0)
    assert a[0, 0] == 0.0  # a copy, not a view of the tensor's memory
    b = _host_array(torch.tensor([1.5, -2.25], dtype=torch.bfloat16))
    assert b.dtype == np.float32 and b.tolist() == [1.5, -2.25]
    assert _host_array(torch.tensor([3], dtype=torch.int64)).dtype == np.int64
    n = np.ones(3, np.float16)
    assert _host_array(n) is n  # numpy goes through np.asarray, as in the JAX package


def _packing_leaves():
    rng = np.random.default_rng(0)
    leaves = []
    for i in range(37):
        shape = [(64, 64), (3,), (1,), (257,), (128, 9)][i % 5]
        dtype = [np.float32, np.float32, np.float64, np.int32][i % 4]
        leaves.append((rng.standard_normal(shape) * 100).astype(dtype))
    leaves.append(np.zeros((0, 4), np.float32))  # empty leaf
    return leaves


def test_bucket_packing_property():
    """Every leaf lands in exactly one bucket, reverse-order fill, byte
    limits respected (modulo the closing leaf), and concat->slice is a
    bit-exact round trip; torch leaves pack as their host arrays."""
    from ray_tpu_torch.collective.bucketed import pack_buckets

    leaves = _packing_leaves()
    mixed = [torch.from_numpy(x) if i % 3 == 0 else x for i, x in enumerate(leaves)]
    limit = 8 * 1024
    buckets, slots = pack_buckets(mixed, limit)
    assert len(slots) == len(leaves)

    seen = {}
    for b in buckets:
        assert all(flat.dtype == b.dtype for _, flat in b.parts)
        assert b.nbytes == sum(flat.nbytes for _, flat in b.parts)
        if len(b.parts) > 1:
            assert b.nbytes - b.parts[-1][1].nbytes < limit
        flat = b.concat()
        off = 0
        for slot, part in b.parts:
            assert slot not in seen
            seen[slot] = flat[off:off + part.size]
            off += part.size
        assert off == flat.size
    assert sorted(seen) == list(range(len(leaves)))  # exactly once
    for slot, flat in seen.items():
        shape, dtype = slots[slot]
        got = flat.reshape(shape)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got, leaves[slot])

    f32_order = [slot for b in buckets if b.dtype == np.dtype(np.float32)
                 for slot, _ in b.parts]
    assert f32_order == sorted(f32_order, reverse=True)


def test_bucket_packing_equals_the_jax_packages():
    """The same leaves give the same buckets, in the same order, with the
    same slots as the JAX package's packer (the ring's schedule depends on
    it: every rank must pack alike)."""
    from ray_tpu.collective.bucketed import pack_buckets as jax_pack
    from ray_tpu_torch.collective.bucketed import pack_buckets

    leaves = _packing_leaves()
    for limit in (1, 8 * 1024, 4 << 20):
        got, got_slots = pack_buckets(leaves, limit)
        want, want_slots = jax_pack(leaves, limit)
        assert got_slots == want_slots
        assert [(b.dtype, b.nbytes, [s for s, _ in b.parts]) for b in got] == \
            [(b.dtype, b.nbytes, [s for s, _ in b.parts]) for b in want]


def test_flatten_unflatten_round_trip():
    from ray_tpu.collective.bucketed import _flatten as jax_flatten
    from ray_tpu_torch.collective.bucketed import _flatten, _unflatten

    tree = _tree(0)
    leaves, spec = _flatten(tree)
    assert spec == jax_flatten(tree)[1]
    back = _unflatten(spec, leaves)
    for a, b in zip(_flatten(back)[0], leaves):
        assert a is b
    assert isinstance(back["head"], list) and isinstance(back["layer0"], dict)
