"""The port's sharded GPT-2 train step against the JAX single-device step, on the CPU.

Eight gloo ranks, spawned once for the module from this file run as a
script (tests/test_torch_ring_attention.py's ``run_ranks``: a ``file://``
store under a temporary directory, one thread each, JAX never imported
there). Each case builds its mesh with ``build_mesh``, places a model
holding the JAX init's parameters with ``shard_model(model, mesh,
gpt_rules())`` and takes one step of ``make_train_step`` with
``torch.optim.AdamW`` at optax.adamw(1e-3)'s values (betas 0.9 and 0.999,
eps 1e-8, weight decay 1e-4), every rank given the global batch. The
parameters after the step are gathered whole (``to_jax``) and the loss is
read on every rank. The JAX side runs ``make_train_step`` jitted on one
device, on the same parameters and tokens, once in the pytest process.

Cases (f32, the d 64, L 2, H 4 model with vocabulary 256 and 64 positions
of the JAX tests):
  - the twin of tests/test_parallel.py's
    test_gpt2_sharded_train_step_matches_single_device: dp 2 x fsdp 2 x tp
    2 on all eight ranks, remat off, tokens (8, 33); held at that test's
    tolerances, loss rtol 1e-5, parameters rtol 2e-4 and atol 2e-5;
  - legs 1 and 2 of ``__graft_entry__._dryrun_multichip_inproc`` at world 4
    (ranks 0-3 and 4-7 at once): dp 1 x fsdp 2 x tp 2, and dcn 2 x dp 1 x
    tp 2, each with remat on; held at the dryrun's 1e-3 on the loss
    (relative to max(1, |loss|)) and on every parameter (max abs);
  - the fused loss under tp: dp 2 x tp 2 (ranks 0-3), loss_impl "fused" in
    two chunks, remat off; held at the twin's tolerances, as f32 leaves
    the vocabulary-parallel softmax only its order of sums;
  - a selective remat policy under tp, whose recompute re-runs the tp
    collectives: fsdp 2 x tp 2 (ranks 4-7), remat_policy "dots_saveable",
    against JAX's step under the same policy at the twin's tolerances;
  - a vocabulary that needs padding under tp: vocab_size 250, padded to
    256, so the last tp rank's half holds the six padded rows that the
    loss masks by global id; chunked (dp 2 x tp 2, ranks 4-7) and fused
    (fsdp 2 x tp 2, ranks 0-3), at the twin's tolerances.

Tokens: those of the JAX tests (``jax.random.randint`` with PRNGKey 1 for
the twin and leg 1, 2 for leg 2 as in the dryrun; 3 to 6 for the others),
made in the pytest process and handed to the ranks. Adam's first step
moves an element by lr * g / (|g| + 1e-8), so where a gradient is near
1e-8 a rounding-sized change of g moves the parameter by up to lr: with
tokens from numpy's default_rng(1) one fc_in element's gradient is
2.2e-9, and there JAX's own sharded step misses its single-device step by
5.6e-5 (the test's atol is 2e-5), as does the port's unsharded step by
2.2e-5. The JAX tests' own tokens have no such element.
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_ring_attention import run_ranks

WORLD = 8
MODEL = dict(vocab_size=256, n_positions=64, d_model=64, n_layer=2, n_head=4)
PADDED = dict(vocab_size=250)  # padded to 256: the loss masks ids 250-255
FUSED = dict(loss_impl="fused", loss_chunk=16)
# name: (mesh axes, ranks, config overrides, token PRNG key)
CASES = {
    "twin": (dict(dp=2, fsdp=2, tp=2), range(0, 8), dict(remat=False), 1),
    "leg1": (dict(dp=1, fsdp=2, tp=2), range(0, 4), dict(remat=True), 1),
    "leg2": (dict(dcn=2, dp=1, tp=2), range(4, 8), dict(remat=True), 2),
    "fused": (dict(dp=2, tp=2), range(0, 4), dict(remat=False, **FUSED), 3),
    "policy": (dict(fsdp=2, tp=2), range(4, 8), dict(remat=True, remat_policy="dots_saveable"), 4),
    "padded": (dict(dp=2, tp=2), range(4, 8), dict(remat=False, **PADDED), 5),
    "padded_fused": (dict(fsdp=2, tp=2), range(0, 4), dict(remat=False, **PADDED, **FUSED), 6),
}
BATCH, SEQ = 8, 33
LR, WEIGHT_DECAY = 1e-3, 1e-4  # optax.adamw(1e-3)


def _model(overrides):
    """The case's model fields: MODEL, less what its overrides replace."""
    return {**MODEL, **{k: v for k, v in overrides.items() if k in MODEL}}


def _tokens(key, vocab_size):
    """[BATCH, SEQ] as the JAX tests draw them (in the pytest process)."""
    import jax

    return np.asarray(jax.random.randint(jax.random.PRNGKey(key), (BATCH, SEQ), 0,
                                         vocab_size, dtype="int32"))


def _flat(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", val


def _nest(flat):
    tree = {}
    for path, val in flat.items():
        *keys, leaf = path.split("/")
        node = tree
        for key in keys:
            node = node.setdefault(key, {})
        node[leaf] = val
    return tree


# ---------------------------------------------------------------------------
# One gloo rank (run as a script)
# ---------------------------------------------------------------------------


def _rank_main(rank: int, workdir: Path) -> None:
    import torch.distributed as dist

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel import MeshConfig, build_mesh, shard_model
    from ray_tpu_torch.parallel.sharding import gpt_rules

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir / 'store'}",
                            world_size=WORLD, rank=rank)
    tokens = dict(np.load(workdir / "tokens.npz"))
    # every rank builds every mesh, in the same order: a mesh creates groups
    meshes = {name: build_mesh(MeshConfig(**axes), ranks=ranks, device_type="cpu")
              for name, (axes, ranks, _, _) in CASES.items()}
    res = {}
    for name, (axes, ranks, overrides, _) in CASES.items():
        if rank not in ranks:
            continue
        cfg = gpt2.GPT2Config(**{**MODEL, **overrides}, dtype=torch.float32)
        params = _nest(dict(np.load(workdir / f"params{cfg.vocab_size}.npz")))
        model = shard_model(gpt2.from_jax(params, cfg, "cpu"), meshes[name], gpt_rules())
        opt = torch.optim.AdamW(model.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=WEIGHT_DECAY)
        res[f"{name}_loss"] = np.array(gpt2.make_train_step(model, opt)(tokens[name]).item())
        after = gpt2.to_jax(model)  # collective over the case's ranks
        if rank == ranks[0]:
            res.update({f"{name}_param/{k}": v for k, v in _flat(after)})
    np.savez(workdir / f"rank{rank}.npz", **res)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The spawn and the JAX references, once for the module
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_params(cpu_mesh_devices):
    """{vocab_size: the JAX init of the model with that vocabulary}."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt2 as jg

    vocabs = {_model(case[2])["vocab_size"] for case in CASES.values()}
    return {v: jg.init(jax.random.PRNGKey(0), jg.GPT2Config(**{**MODEL, "vocab_size": v},
                                                            dtype=jnp.float32))
            for v in sorted(vocabs)}


@pytest.fixture(scope="module")
def torch_steps(tmp_path_factory, jax_params):
    """Run the eight ranks; returns {case: (the loss on each of its ranks,
    {path: parameter after the step})}."""
    workdir = tmp_path_factory.mktemp("sharded_step")
    for vocab, params in jax_params.items():
        np.savez(workdir / f"params{vocab}.npz", **{k: np.asarray(v) for k, v in _flat(params)})
    np.savez(workdir / "tokens.npz", **{name: _tokens(case[3], _model(case[2])["vocab_size"])
                                        for name, case in CASES.items()})
    shards = run_ranks(__file__, workdir, WORLD)
    out = {}
    for name, (_, ranks, _, _) in CASES.items():
        first = shards[ranks[0]]
        prefix = f"{name}_param/"
        out[name] = ([float(shards[r][f"{name}_loss"]) for r in ranks],
                     {k[len(prefix):]: v for k, v in first.items() if k.startswith(prefix)})
    return out


@pytest.fixture(scope="module")
def jax_steps(jax_params):
    """{case: (loss, {path: parameter})} of the JAX step on one device."""
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.models import gpt2 as jg

    opt = optax.adamw(LR)  # weight decay 1e-4 by default
    out = {}
    for name, (_, _, overrides, key) in CASES.items():
        cfg = jg.GPT2Config(**{**MODEL, **overrides}, dtype=jnp.float32)
        init = jax_params[cfg.vocab_size]
        step = jax.jit(jg.make_train_step(cfg, opt))
        params, _, loss = step(init, opt.init(init), jnp.asarray(_tokens(key, cfg.vocab_size)))
        out[name] = (float(loss), {k: np.asarray(v) for k, v in _flat(params)})
    return out


def _check(torch_steps, jax_steps, name, loss_ok, params_close):
    losses, params = torch_steps[name]
    want_loss, want = jax_steps[name]
    assert len(set(losses)) == 1, f"{name}: the ranks disagree on the loss {losses}"
    assert math.isfinite(losses[0]) and loss_ok(losses[0], want_loss), (name, losses[0], want_loss)
    assert sorted(params) == sorted(want)
    for path, w in want.items():
        params_close(params[path], w, f"{name}: {path}")


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


def test_gpt2_sharded_train_step_matches_single_device(torch_steps, jax_steps):
    """dp 2 x fsdp 2 x tp 2 at world 8, at the JAX test's tolerances."""
    _check(torch_steps, jax_steps, "twin",
           lambda got, want: abs(got - want) <= 1e-5 * abs(want),
           lambda got, want, msg: np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5,
                                                             err_msg=msg))


@pytest.mark.parametrize("leg", ["leg1", "leg2"])
def test_dryrun_legs_match_single_device(torch_steps, jax_steps, leg):
    """dp 1 x fsdp 2 x tp 2 and dcn 2 x dp 1 x tp 2 at world 4, remat on,
    at the dryrun's 1e-3 on the loss and the parameters."""
    def params_close(got, want, msg):
        gap = float(np.abs(got - want).max())
        assert gap <= 1e-3, f"{msg}: max abs {gap:.2e}"

    _check(torch_steps, jax_steps, leg,
           lambda got, want: abs(got - want) / max(1.0, abs(want)) <= 1e-3, params_close)


def test_fused_loss_under_tp_matches_single_device(torch_steps, jax_steps):
    """The vocabulary-parallel fused CE (dp 2 x tp 2) against JAX's fused
    step on one device, at the twin's tolerances."""
    _check(torch_steps, jax_steps, "fused",
           lambda got, want: abs(got - want) <= 1e-5 * abs(want),
           lambda got, want, msg: np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5,
                                                             err_msg=msg))


def test_remat_policy_under_tp_matches_single_device(torch_steps, jax_steps):
    """remat_policy "dots_saveable" at fsdp 2 x tp 2 against JAX's step
    under the same policy, at the twin's tolerances."""
    _check(torch_steps, jax_steps, "policy",
           lambda got, want: abs(got - want) <= 1e-5 * abs(want),
           lambda got, want, msg: np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5,
                                                             err_msg=msg))


@pytest.mark.parametrize("case", ["padded", "padded_fused"])
def test_padded_vocab_under_tp_matches_single_device(torch_steps, jax_steps, case):
    """vocab_size 250 (padded to 256, the padded rows on the last tp rank)
    under tp 2, chunked and fused CE, against JAX's step on one device at
    the twin's tolerances."""
    _check(torch_steps, jax_steps, case,
           lambda got, want: abs(got - want) <= 1e-5 * abs(want),
           lambda got, want, msg: np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5,
                                                             err_msg=msg))


def test_cases_shard_what_they_name():
    """Each case's mesh covers its ranks and splits its batch evenly; the
    padded cases put padded rows on the last tp rank alone."""
    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.parallel.mesh import MeshConfig, data_axes

    for name, (axes, ranks, overrides, _) in CASES.items():
        sizes = MeshConfig(**axes).resolve(len(ranks))
        shards = math.prod(sizes[a] for a in data_axes())
        assert BATCH % shards == 0 and sizes["tp"] == 2, name
        cfg = GPT2Config(**_model(overrides))
        part = cfg.padded_vocab // sizes["tp"]
        assert cfg.n_head % sizes["tp"] == 0 and cfg.padded_vocab % sizes["tp"] == 0
        if cfg.padded_vocab != cfg.vocab_size:
            assert cfg.padded_vocab - part < cfg.vocab_size < cfg.padded_vocab, name


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), Path(sys.argv[2]))
