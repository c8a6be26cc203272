"""The port's ring attention against the JAX package's, on the CPU.

The torch ring runs on four gloo ranks, processes spawned once for the
module from this file run as a script (``python
tests/test_torch_ring_attention.py RANK DIR``). They join through a
``file://`` store in a temporary directory (no TCP port, so files running in
parallel cannot collide) and run every case: world 4 over all four, world 2
in two groups of their own (ranks 0-1 and 2-3, so group ranks differ from
global ones), world 1 on each rank alone. Each rank reads the inputs the
test wrote and writes its outputs; the test gathers the shards in group
rank order. A rank that hangs fails the module after ``JOIN_TIMEOUT_S``.

The JAX side runs ``ring_attention_sharded(..., head_axis=None)`` on a cp
mesh of the same size from the 8-device CPU mesh, the flash blocks in
Pallas interpret mode, the einsum blocks as they are; the port's blocks run
their plain versions (CPU tensors). World 1 is held to the JAX world-2 ring
(exact attention over the same sequence either way). Inputs: f32 from a
seeded numpy generator, handed to both. Tolerances as
tests/test_torch_flash_attention.py: 1e-5 on the outputs, 1e-4 on the
gradients, whose sums run in other orders.

The ring emulated in one process (``ring_attention_emulated``, what
chip_smoke.py runs on the card) is held to the same JAX results.

The same ranks run two more cases on inputs of B 2, T 64, H 4, Dh 32 (the
JAX package's own ring tests' shape, f32):
  - the twin of tests/test_ring_attention.py's test_ring_matches_reference
    and test_ring_gradients_match: the ring over all four ranks against
    JAX's reference attention, outputs within 2e-5 (rtol and atol),
    causal and not, and the gradients of sum(out^2) within 5e-4 rtol and
    5e-5 atol, causal: that file's tolerances;
  - ``ring_attention_sharded`` on a dp 2 x cp 2 mesh (``build_mesh``),
    each rank its batch row and its half of the sequence, against JAX's
    ``ring_attention_sharded`` on a dp 2 x cp 2 mesh: output and
    gradients at this file's tolerances.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
B, T, H, D = 1, 64, 2, 16  # the global sequence; each rank of a group holds T / world rows
RANKS = 4
# (world, causal) of the flash and einsum rings: causal at worlds 2 and 4,
# the non-causal ring (every block visible) at world 4
CASES = [(2, True), (4, True), (4, False)]
FWD_TOL, GRAD_TOL = 1e-5, 1e-4
JOIN_TIMEOUT_S = 120
NAMES = ("out", "dq", "dk", "dv")
SHAPE32 = (2, 64, 4, 32)  # B, T, H, Dh of tests/test_ring_attention.py
TWIN_FWD_TOL, TWIN_GRAD_RTOL, TWIN_GRAD_ATOL = 2e-5, 5e-4, 5e-5
MESH_DP, MESH_CP = 2, 2


def _inputs():
    rng = np.random.default_rng(0)
    x = {n: rng.standard_normal((B, T, H, D), dtype=np.float32) for n in ("q", "k", "v", "do")}
    rng = np.random.default_rng(1)
    x.update({f"{n}32": rng.standard_normal(SHAPE32, dtype=np.float32)
              for n in ("q", "k", "v", "do")})
    return x


def _tag(causal):
    return "causal" if causal else "full"


def _case_id(case):
    return f"world{case[0]}_{_tag(case[1])}"


# ---------------------------------------------------------------------------
# One gloo rank (run as a script)
# ---------------------------------------------------------------------------


def _flash_ring(x, rows, group, causal):
    """out and (dq, dk, dv) of this rank's rows through attention(impl="ring")."""
    from ray_tpu_torch.ops.attention import attention

    q, k, v = (torch.from_numpy(np.ascontiguousarray(x[n][:, rows])).requires_grad_()
               for n in ("q", "k", "v"))
    out = attention(q, k, v, causal=causal, impl="ring", group=group)
    out.backward(torch.from_numpy(np.ascontiguousarray(x["do"][:, rows])))
    return [t.detach().numpy() for t in (out, q.grad, k.grad, v.grad)]


def _dh32_cases(x, rank, res) -> None:
    """The Dh-32 twin over all four ranks, and ring_attention_sharded on
    the dp x cp mesh: this rank's blocks of out (and dq, dk, dv)."""
    import torch.distributed as dist

    from ray_tpu_torch.ops.attention import attention
    from ray_tpu_torch.ops.ring_attention import ring_attention_sharded
    from ray_tpu_torch.parallel import MeshConfig, build_mesh

    Tl = SHAPE32[1] // RANKS
    rows = slice(rank * Tl, (rank + 1) * Tl)
    for causal in (True, False):
        q, k, v = (torch.from_numpy(np.ascontiguousarray(x[f"{n}32"][:, rows])).requires_grad_()
                   for n in ("q", "k", "v"))
        out = attention(q, k, v, causal=causal, impl="ring", group=dist.group.WORLD)
        res[f"twin_{_tag(causal)}_out"] = out.detach().numpy()
        if causal:  # the gradients of sum(out^2)
            (out ** 2).sum().backward()
            for name, t in zip(NAMES[1:], (q, k, v)):
                res[f"twin_causal_{name}"] = t.grad.numpy()
    mesh = build_mesh(MeshConfig(dp=MESH_DP, cp=MESH_CP), device_type="cpu")
    dp, cp = (mesh.get_local_rank(a) for a in ("dp", "cp"))
    Bl, Tl = SHAPE32[0] // MESH_DP, SHAPE32[1] // MESH_CP
    block = (slice(dp * Bl, (dp + 1) * Bl), slice(cp * Tl, (cp + 1) * Tl))
    q, k, v = (torch.from_numpy(np.ascontiguousarray(x[f"{n}32"][block])).requires_grad_()
               for n in ("q", "k", "v"))
    out = ring_attention_sharded(q, k, v, mesh, causal=True)
    out.backward(torch.from_numpy(np.ascontiguousarray(x["do32"][block])))
    for name, t in zip(NAMES, (out, q.grad, k.grad, v.grad)):
        res[f"sharded_{name}"] = t.detach().numpy()
    res["sharded_coords"] = np.array([dp, cp])


def _rank_main(rank: int, workdir: Path) -> None:
    import torch.distributed as dist

    from ray_tpu_torch.ops.ring_attention import ring_attention_einsum

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir / 'store'}",
                            world_size=RANKS, rank=rank)
    # every rank builds every group, in the same order
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    alone = [dist.new_group([r]) for r in range(RANKS)]
    groups = {4: dist.group.WORLD, 2: pairs[rank // 2], 1: alone[rank]}
    x = dict(np.load(workdir / "inputs.npz"))
    res = {}
    for world, causal in CASES + [(1, True)]:
        group = groups[world]
        Tl, r = T // world, dist.get_rank(group)
        rows = slice(r * Tl, (r + 1) * Tl)
        key = f"world{world}_{_tag(causal)}"
        for name, arr in zip(NAMES, _flash_ring(x, rows, group, causal)):
            res[f"flash_{key}_{name}"] = arr
        if world > 1:
            q, k, v = (torch.from_numpy(np.ascontiguousarray(x[n][:, rows])) for n in ("q", "k", "v"))
            res[f"einsum_{key}_out"] = ring_attention_einsum(q, k, v, group, causal=causal).numpy()
    _dh32_cases(x, rank, res)
    np.savez(workdir / f"rank{rank}.npz", **res)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The spawn and the JAX references, once for the module
# ---------------------------------------------------------------------------


def run_ranks(script: str, workdir: Path, ranks: int = RANKS) -> list:
    """Run ``python script RANK workdir`` for ``ranks`` ranks at once (the
    port's package on the path, one thread each, gloo on the loopback) and
    fail the calling test if a rank exits non-zero or outlives
    JOIN_TIMEOUT_S. Returns each rank's ``workdir/rank{r}.npz`` as a dict.
    tests/test_torch_moe.py and tests/test_torch_sharded_step.py run their
    ranks through it too."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen([sys.executable, script, str(r), str(workdir)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(ranks)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank of {script} did not finish within {JOIN_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    return [dict(np.load(workdir / f"rank{r}.npz")) for r in range(ranks)]


@pytest.fixture(scope="module")
def torch_ring(tmp_path_factory):
    """Run the four ranks; returns get(kind, world, causal), which gives each
    group's results gathered in group rank order ([B, T, H, D] each)."""
    workdir = tmp_path_factory.mktemp("ring")
    np.savez(workdir / "inputs.npz", **_inputs())
    shards = run_ranks(__file__, workdir)

    def get(kind, world=RANKS, causal=True):
        """[one list of NAMES' arrays per group of this world size]; for
        kind "twin", the four ranks' rows joined; for "sharded", the ranks'
        blocks put back in the global arrays by their mesh coordinates."""
        if kind == "twin":
            names = NAMES if causal else NAMES[:1]
            return [np.concatenate([shards[r][f"twin_{_tag(causal)}_{n}"] for r in range(RANKS)],
                                   axis=1) for n in names]
        if kind == "sharded":
            full = [np.zeros(SHAPE32, np.float32) for _ in NAMES]
            Bl, Tl = SHAPE32[0] // MESH_DP, SHAPE32[1] // MESH_CP
            for shard in shards:
                dp, cp = shard["sharded_coords"]
                for arr, n in zip(full, NAMES):
                    arr[dp * Bl:(dp + 1) * Bl, cp * Tl:(cp + 1) * Tl] = shard[f"sharded_{n}"]
            return full
        names = NAMES if kind == "flash" else NAMES[:1]
        key = f"{kind}_world{world}_{_tag(causal)}"
        return [[np.concatenate([shards[r][f"{key}_{n}"] for r in members], axis=1)
                 for n in names] for members in np.arange(RANKS).reshape(-1, world)]

    return get


def _jax_ring(devices, world, causal, block_impl):
    """JAX ring_attention_sharded on a cp mesh of ``world`` CPU devices:
    [out] for the einsum blocks, [out, dq, dk, dv] for the flash blocks."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.ops.ring_attention import ring_attention_sharded
    from ray_tpu.parallel import MeshConfig, build_mesh

    mesh = build_mesh(MeshConfig(dp=1, cp=world), devices=devices[:world])
    x = {n: jnp.asarray(a) for n, a in _inputs().items()}
    fn = jax.jit(lambda q, k, v: ring_attention_sharded(q, k, v, mesh, causal=causal,
                                                        head_axis=None, block_impl=block_impl))
    if block_impl == "einsum":
        return [np.asarray(fn(x["q"], x["k"], x["v"]))]
    out, vjp = jax.vjp(fn, x["q"], x["k"], x["v"])
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(x["do"])]


@pytest.fixture(scope="module")
def jax_rings(cpu_mesh_devices):
    cache = {}

    def get(world, causal, block_impl="flash"):
        key = (world, causal, block_impl)
        if key not in cache:
            cache[key] = _jax_ring(cpu_mesh_devices, world, causal, block_impl)
        return cache[key]

    return get


def _close(got, want, what):
    for name, g, w in zip(NAMES, got, want):
        tol = FWD_TOL if name == "out" else GRAD_TOL
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=f"{what}: {name}")


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_ring_matches_jax(torch_ring, jax_rings, case):
    """Output and all three gradients of the gloo ring (each group of the
    world size) against the JAX ring with flash blocks."""
    for i, got in enumerate(torch_ring("flash", *case)):
        _close(got, jax_rings(*case), f"{_case_id(case)}, group {i}")


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_einsum_ring_matches_jax(torch_ring, jax_rings, case):
    for i, got in enumerate(torch_ring("einsum", *case)):
        _close(got, jax_rings(*case, "einsum"), f"einsum ring, {_case_id(case)}, group {i}")


def test_world_one_matches_jax(torch_ring, jax_rings):
    """Each rank alone in its group: one causal block, no exchange."""
    results = torch_ring("flash", 1, True)
    assert len(results) == RANKS
    for rank, got in enumerate(results):
        _close(got, jax_rings(2, True), f"world 1 on rank {rank}")


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_emulated_ring_matches_jax(jax_rings, case):
    """The n-rank ring in one process (what chip_smoke.py runs on the card), plain path."""
    from ray_tpu_torch.ops.ring_attention import ring_attention_emulated

    world, causal = case
    shards = {n: list(torch.from_numpy(a).chunk(world, dim=1)) for n, a in _inputs().items()}
    res = ring_attention_emulated(shards["q"], shards["k"], shards["v"], shards["do"], causal)
    got = [torch.cat(parts, dim=1).numpy() for parts in res]
    _close(got, jax_rings(world, causal), f"emulated ring, {_case_id(case)}")
    fwd_only = ring_attention_emulated(shards["q"], shards["k"], shards["v"], causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(fwd_only, res[0]))


@pytest.mark.parametrize("causal", [True, False], ids=_tag)
def test_ring_matches_reference(torch_ring, cpu_mesh_devices, causal):
    """The twin of tests/test_ring_attention.py's test: the gloo ring over
    four ranks at B 2, T 64, H 4, Dh 32 against JAX's reference attention
    on the whole sequence, within that test's 2e-5."""
    import jax.numpy as jnp

    from ray_tpu.ops.attention import _reference_attention

    x = _inputs()
    want = _reference_attention(*(jnp.asarray(x[f"{n}32"]) for n in ("q", "k", "v")), causal)
    got = torch_ring("twin", causal=causal)[0]
    np.testing.assert_allclose(got, np.asarray(want), rtol=TWIN_FWD_TOL, atol=TWIN_FWD_TOL)


def test_ring_gradients_match(torch_ring, cpu_mesh_devices):
    """The twin of tests/test_ring_attention.py's gradient test: the
    gradients of sum(out^2) through the causal ring against those through
    JAX's reference attention, within its 5e-4 rtol and 5e-5 atol."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.ops.attention import _reference_attention

    x = _inputs()
    want = jax.grad(lambda q, k, v: (_reference_attention(q, k, v, True) ** 2).sum(),
                    argnums=(0, 1, 2))(*(jnp.asarray(x[f"{n}32"]) for n in ("q", "k", "v")))
    for name, got, w in zip(NAMES[1:], torch_ring("twin")[1:], want):
        np.testing.assert_allclose(got, np.asarray(w), rtol=TWIN_GRAD_RTOL, atol=TWIN_GRAD_ATOL,
                                   err_msg=name)


def test_ring_attention_sharded_matches_jax(torch_ring, cpu_mesh_devices):
    """ring_attention_sharded on the dp 2 x cp 2 mesh of the four ranks
    against JAX's ring_attention_sharded on a dp 2 x cp 2 mesh (flash
    blocks), output and gradients."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.ops.ring_attention import ring_attention_sharded
    from ray_tpu.parallel import MeshConfig, build_mesh

    mesh = build_mesh(MeshConfig(dp=MESH_DP, cp=MESH_CP), devices=cpu_mesh_devices[:RANKS])
    x = {n: jnp.asarray(a) for n, a in _inputs().items()}
    fn = jax.jit(lambda q, k, v: ring_attention_sharded(q, k, v, mesh, causal=True))
    out, vjp = jax.vjp(fn, x["q32"], x["k32"], x["v32"])
    want = [np.asarray(out)] + [np.asarray(g) for g in vjp(x["do32"])]
    _close(torch_ring("sharded"), want, "ring_attention_sharded, dp 2 x cp 2")


def test_ring_needs_a_group():
    from ray_tpu_torch.ops.attention import attention

    x = torch.zeros(1, 8, 2, 16)
    with pytest.raises(NotImplementedError, match="process group"):
        attention(x, x, x, impl="ring")


def test_einsum_ring_refuses_gradients():
    from ray_tpu_torch.ops.ring_attention import ring_attention_einsum

    x = torch.zeros(1, 8, 2, 16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="gradient"):
        ring_attention_einsum(x, x, x, group=None)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), Path(sys.argv[2]))
