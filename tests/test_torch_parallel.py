"""The port's mesh and partition rules against the JAX package's, on the CPU
(no process group: what needs one runs in tests/test_torch_sharded_step.py).

- ``MeshConfig.resolve`` gives JAX's sizes and raises where JAX raises
  (the cases of tests/test_parallel.py::test_mesh_presets and more);
- ``rank_layout``, the order ``build_mesh`` puts the ranks in, equals the
  device ids of JAX's ``build_mesh`` on the 8 CPU devices;
- ``gpt_rules`` gives each of the port's parameters the spec JAX's gives
  the matching leaf of its pytree, less the leading layer axis of the
  stacked blocks, with and without fsdp;
- ``PartitionRules``: first match wins, replicated by default, specs cut to
  the parameter's rank (the twin of tests/test_parallel.py::
  test_shard_pytree_and_constraint); specs become DTensor placements.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import gpt2 as tg
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import sharding as tsh

RESOLVE_CASES = [
    dict(dp=-1, tp=2), dict(dp=2, fsdp=2, tp=2), dict(dp=3, tp=2), dict(dcn=2, dp=2, tp=2),
    dict(dp=2, cp=4), dict(dp=-1, ep=4), dict(dp=-1, fsdp=-1), dict(dp=1, fsdp=2, tp=2),
    dict(dp=-1, tp=3), dict(dp=2, cp=2, ep=2),
]
LAYOUT_CASES = [
    dict(dp=2, fsdp=2, tp=2), dict(dcn=2, dp=2, tp=2), dict(dp=4, tp=2), dict(dp=2, cp=4),
    dict(dp=2, ep=2, tp=2), dict(dcn=2, dp=1, tp=2, cp=2), dict(dp=8),
]


@pytest.mark.parametrize("axes", RESOLVE_CASES, ids=str)
def test_mesh_config_resolves_as_jax(cpu_mesh_devices, axes):
    from ray_tpu.parallel import MeshConfig

    try:
        want = MeshConfig(**axes).resolve(8)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            tmesh.MeshConfig(**axes).resolve(8)
        assert str(got.value) == str(err)
        return
    assert tmesh.MeshConfig(**axes).resolve(8) == want


def test_mesh_presets():
    """tests/test_parallel.py::test_mesh_presets on the port's config."""
    assert tmesh.MeshConfig(dp=-1, tp=2).resolve(8) == dict(dcn=1, dp=4, fsdp=1, ep=1, cp=1, tp=2)
    assert tmesh.MeshConfig(dp=2, fsdp=2, tp=2).resolve(8)["fsdp"] == 2
    with pytest.raises(ValueError):
        tmesh.rank_layout(tmesh.MeshConfig(dp=3, tp=2), range(8))  # 6 doesn't divide 8


@pytest.mark.parametrize("axes", LAYOUT_CASES, ids=str)
def test_rank_layout_is_jax_device_order(cpu_mesh_devices, axes):
    from ray_tpu.parallel import MeshConfig, build_mesh

    mesh = build_mesh(MeshConfig(**axes), devices=cpu_mesh_devices)
    assert tuple(mesh.axis_names) == tmesh.AXIS_ORDER
    want = np.vectorize(lambda d: d.id)(mesh.devices)
    got = tmesh.rank_layout(tmesh.MeshConfig(**axes), [d.id for d in cpu_mesh_devices])
    np.testing.assert_array_equal(got, want)


def test_data_axes_as_jax():
    from ray_tpu.parallel import mesh as jmesh
    from ray_tpu.parallel import sharding as jsh

    assert tmesh.data_axes() == jmesh.data_axes()
    assert tuple(tsh.batch_spec()) == tuple(jsh.batch_spec())


@pytest.mark.parametrize("fsdp", [True, False])
def test_gpt_rules_match_jax(cpu_mesh_devices, fsdp):
    import jax

    from ray_tpu.models import gpt2 as jg
    from ray_tpu.parallel.sharding import gpt_rules, path_str

    cfg = jg.CONFIGS["gpt2-tiny"]
    jspecs = gpt_rules(fsdp).tree_specs(jax.eval_shape(lambda: jg.init(jax.random.PRNGKey(0), cfg)))
    want = {path_str(path): tuple(spec) for path, spec in
            jax.tree_util.tree_flatten_with_path(jspecs, is_leaf=lambda x: x is None or
                                                 isinstance(x, tuple))[0]}
    model = tg.GPT2(tg.CONFIGS["gpt2-tiny"], "cpu")
    got = tsh.gpt_rules(fsdp).tree_specs(model)
    assert len(got) == cfg.n_layer * (len(want) - 4) + 4  # wte, wpe and ln_f's two
    for name, spec in got.items():
        parts = name.split(".")
        if parts[0] == "blocks":  # the port's blocks.<i>.x is JAX's blocks/x with L first
            jspec = want["/".join(["blocks"] + parts[2:])]
            jspec = jspec[1:] if jspec else jspec
        else:
            jspec = want["/".join(parts)]
        assert tuple(spec) == jspec, (name, spec, jspec)


def test_gpt_rules_place_tp_and_fsdp_where_expected():
    """Two of the issue's examples, and every spec fits its parameter."""
    model = tg.GPT2(tg.CONFIGS["gpt2-tiny"], "cpu")
    specs = tsh.gpt_rules().tree_specs(model)
    assert specs["blocks.0.attn.qkv.kernel"] == tsh.P("fsdp", None, "tp", None)
    assert specs["wte"] == tsh.P("tp", "fsdp")
    assert specs["blocks.1.ln2.scale"] == tsh.P()
    for name, p in model.named_parameters():
        assert len(specs[name]) <= p.dim(), name


def test_partition_rules_first_match_and_replicated_default():
    """The twin of test_shard_pytree_and_constraint: w matches (tp, None)
    before the broader rule, b the broader rule before its own, a name no
    rule matches is replicated, and a spec longer than the leaf is cut to
    its rank."""
    rules = tsh.PartitionRules([(r"w", tsh.P("tp", None)), (r"w|b", tsh.P("fsdp")),
                                (r"b", tsh.P())])
    model = torch.nn.Module()
    model.w = torch.nn.Parameter(torch.ones(8, 4))
    model.b = torch.nn.Parameter(torch.ones(4))
    model.c = torch.nn.Parameter(torch.ones(2))
    model.v = torch.nn.Parameter(torch.ones(3))
    assert rules.spec_for("w") == tsh.P("tp", None)
    specs = rules.tree_specs(model)
    assert specs == {"w": ("tp", None), "b": ("fsdp",), "c": (), "v": ()}
    cut = tsh.PartitionRules([(r"v", tsh.P("tp", None, "fsdp"))]).tree_specs(model)
    assert cut["v"] == tsh.P("tp")
    assert tsh.path_str("blocks.0.attn.qkv.kernel") == "blocks/0/attn/qkv/kernel"


def test_specs_become_placements():
    from torch.distributed.tensor import Replicate, Shard

    names = tmesh.AXIS_ORDER
    got = tsh.placements(tsh.P("tp", None, "fsdp"), names)
    assert got == (Replicate(), Replicate(), Shard(2), Replicate(), Replicate(), Shard(0))
    assert tsh.placements(tsh.P(), names) == (Replicate(),) * len(names)
    assert tsh.placements(tsh.P(("dp",)), names)[1] == Shard(0)
    with pytest.raises(NotImplementedError):
        tsh.placements(tsh.batch_spec(), names)  # one dim over three axes
    x = torch.ones(2)
    assert tsh.with_sharding_constraint(x, None, "tp") is x


def test_remat_policy_is_a_config_field():
    cfg = dataclasses.replace(tg.CONFIGS["gpt2-tiny"], remat=True)
    assert cfg.remat_policy == "full"
    assert set(tg.REMAT_KEEPS) == {"full", "dots", "dots_saveable", "attn_out"}
