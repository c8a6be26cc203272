"""The port's MoE block against the JAX package's, on the CPU.

``router_dispatch`` and ``moe_block_local`` run in this process beside
their JAX twins. ``moe_block`` runs on four gloo ranks, processes spawned
once for the module from this file run as a script (``python
tests/test_torch_moe.py RANK DIR``), joined through a ``file://`` store in a
temporary directory: ep 4 over all four, ep 2 in two groups of their own
(ranks 0-1 and 2-3). Each rank takes its slice of the tokens and of the
experts, computes the loss sum(out^2) of its rows and its gradients (the
spawn is tests/test_torch_ring_attention.py's ``run_ranks``); the
test gathers outputs and gradients in group rank order and sums the
router's gradient over the group (the router is replicated, so JAX's
gradient is the sum). The JAX side is ``moe_block_sharded`` on an ep mesh
of the same size, its loss and gradients as in the dryrun's MoE leg
(``__graft_entry__.py:279-342``). A rank that hangs fails the module.
The same ranks run ``moe_block_sharded`` on meshes from ``build_mesh``
(ep 4, and dp 2 x ep 2), held to the same JAX results.

Inputs: f32 from a seeded numpy generator, handed to both. Tolerances: the
dryrun leg's, 1e-3 on the loss (relative) and 1e-2 on every gradient (max
abs); the outputs, the dispatch and combine tensors and the local block
within 1e-5 (the same f32 arithmetic, summed in other orders).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_ring_attention import RANKS, run_ranks
N_TOKENS, D, F_, E = 32, 16, 32, 8
CAPACITY = 3  # below the mean load at ep 2 (16 tokens x 2 choices / 8 experts): tokens drop
WORLDS = (2, 4)
TOL = 1e-5
LOSS_RTOL, GRAD_ATOL = 1e-3, 1e-2
GRADS = ("x", "wg", "w_in", "w_out")


def _inputs():
    rng = np.random.default_rng(4)
    return {"x": rng.standard_normal((N_TOKENS, D), dtype=np.float32),
            "wg": rng.standard_normal((D, E), dtype=np.float32) * 0.1,
            "w_in": rng.standard_normal((E, D, F_), dtype=np.float32) * 0.1,
            "w_out": rng.standard_normal((E, F_, D), dtype=np.float32) * 0.1}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# One gloo rank (run as a script)
# ---------------------------------------------------------------------------


def _rank_main(rank: int, workdir: Path) -> None:
    import torch.distributed as dist

    from ray_tpu_torch.ops.moe import moe_block, moe_block_sharded
    from ray_tpu_torch.parallel import MeshConfig, build_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir / 'store'}",
                            world_size=RANKS, rank=rank)
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]  # every rank builds both
    groups = {4: dist.group.WORLD, 2: pairs[rank // 2]}
    meshes = {world: build_mesh(MeshConfig(dp=RANKS // world, ep=world), device_type="cpu")
              for world in WORLDS}
    x = dict(np.load(workdir / "inputs.npz"))
    res = {}
    for world in WORLDS:
        group, mesh = groups[world], meshes[world]
        for kind, r in (("group", dist.get_rank(group)), ("mesh", mesh.get_local_rank("ep"))):
            bl, el = N_TOKENS // world, E // world
            args = {"x": _t(x["x"][r * bl:(r + 1) * bl]), "wg": _t(x["wg"]),
                    "w_in": _t(x["w_in"][r * el:(r + 1) * el]),
                    "w_out": _t(x["w_out"][r * el:(r + 1) * el])}
            for a in args.values():
                a.requires_grad_()
            a = [args[n] for n in GRADS]
            out = (moe_block(*a, CAPACITY, group) if kind == "group"
                   else moe_block_sharded(*a, mesh, capacity=CAPACITY))
            (out.float() ** 2).sum().backward()
            key = f"{kind}_ep{world}"
            res[f"{key}_out"] = out.detach().numpy()
            res[f"{key}_rank"] = np.array(r)
            for name in GRADS:
                res[f"{key}_d{name}"] = args[name].grad.numpy()
    np.savez(workdir / f"rank{rank}.npz", **res)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The spawn and the JAX references, once for the module
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def torch_moe(tmp_path_factory):
    """Run the four ranks; returns get(world) -> one dict per group of that
    size: out and the four gradients, gathered (the router's summed)."""
    workdir = tmp_path_factory.mktemp("moe")
    np.savez(workdir / "inputs.npz", **_inputs())
    shards = run_ranks(__file__, workdir)

    def get(world, kind="group"):
        groups = []
        for members in np.arange(RANKS).reshape(-1, world):
            # in ep rank order (moe_block_sharded's from the mesh coordinate)
            members = sorted(members, key=lambda r: int(shards[r][f"{kind}_ep{world}_rank"]))
            part = lambda key: [shards[r][f"{kind}_ep{world}_{key}"] for r in members]
            res = {k: np.concatenate(part(k)) for k in ("out", "dx", "dw_in", "dw_out")}
            res["dwg"] = np.sum(part("dwg"), axis=0)
            groups.append(res)
        return groups

    return get


@pytest.fixture(scope="module")
def jax_moe(cpu_mesh_devices):
    """JAX moe_block_sharded on an ep mesh of each world size: out, the loss
    sum(out^2) and the gradients of the four inputs."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.ops.moe import moe_block_sharded
    from ray_tpu.parallel import MeshConfig, build_mesh

    args = [jnp.asarray(a) for a in _inputs().values()]
    res = {}
    for world in WORLDS:
        mesh = build_mesh(MeshConfig(dp=1, ep=world), devices=cpu_mesh_devices[:world])
        fwd = jax.jit(lambda *a: moe_block_sharded(*a, mesh, capacity=CAPACITY))
        out, vjp = jax.vjp(fwd, *args)
        grads = vjp(2 * out)  # the gradients of sum(out^2)
        res[world] = {"out": np.asarray(out), "loss": float((out ** 2).sum()),
                      **{f"d{n}": np.asarray(g) for n, g in zip(GRADS, grads)}}
    return res


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


def _hold_to_jax(torch_moe, jax_moe, world, kind):
    want = jax_moe[world]
    for i, got in enumerate(torch_moe(world, kind)):
        where = f"ep {world} ({kind}), group {i}"
        np.testing.assert_allclose(got["out"], want["out"], rtol=TOL, atol=TOL, err_msg=where)
        loss = float((got["out"].astype(np.float64) ** 2).sum())
        assert abs(loss - want["loss"]) <= LOSS_RTOL * max(1.0, abs(want["loss"])), where
        for name in GRADS:
            gap = np.abs(got[f"d{name}"] - want[f"d{name}"]).max()
            assert gap <= GRAD_ATOL, f"{where}: d{name} max abs {gap:.2e}"


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"ep{w}")
def test_moe_block_matches_jax(torch_moe, jax_moe, world):
    _hold_to_jax(torch_moe, jax_moe, world, "group")


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"ep{w}")
def test_moe_block_sharded_matches_jax(torch_moe, jax_moe, world):
    """moe_block_sharded on a mesh from build_mesh (ep 4; dp 2 x ep 2)
    against JAX's moe_block_sharded on an ep mesh of the same size."""
    _hold_to_jax(torch_moe, jax_moe, world, "mesh")


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("capacity", [2, 8])
def test_router_dispatch_matches_jax(cpu_mesh_devices, capacity, top_k):
    import jax.numpy as jnp

    from ray_tpu.ops import moe as jm
    from ray_tpu_torch.ops import moe as tm

    x = _inputs()
    want = jm.router_dispatch(jnp.asarray(x["x"]), jnp.asarray(x["wg"]), capacity, top_k)
    got = tm.router_dispatch(_t(x["x"]), _t(x["wg"]), capacity, top_k)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))  # one-hots
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=TOL, atol=TOL)


def test_router_breaks_ties_as_lax_top_k(cpu_mesh_devices):
    """A zero router gives every expert the same gate: lax.top_k takes the
    lower indices first, and so must the port (torch.topk does not promise
    an order)."""
    import jax.numpy as jnp

    from ray_tpu.ops import moe as jm
    from ray_tpu_torch.ops import moe as tm

    x, wg = _inputs()["x"], np.zeros((D, E), np.float32)
    want = jm.router_dispatch(jnp.asarray(x), jnp.asarray(wg), 8, 2)
    got = tm.router_dispatch(_t(x), _t(wg), 8, 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0][:, :2].sum().item() == 2 * 8 and got[0][:, 2:].sum().item() == 0


def test_moe_block_local_matches_jax(cpu_mesh_devices):
    """All experts in one place: output and the four gradients."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.ops import moe as jm
    from ray_tpu_torch.ops import moe as tm

    x = _inputs()
    fwd = jax.jit(lambda *a: jm.moe_block_local(*a, capacity=CAPACITY))
    want_out, vjp = jax.vjp(fwd, *(jnp.asarray(a) for a in x.values()))
    want = vjp(2 * want_out)  # the gradients of sum(out^2)
    want_out = np.asarray(want_out)
    args = [_t(a).requires_grad_() for a in x.values()]
    out = tm.moe_block_local(*args, capacity=CAPACITY)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=TOL, atol=TOL)
    for name, a, w in zip(GRADS, args, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), rtol=TOL, atol=TOL, err_msg=name)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), Path(sys.argv[2]))
