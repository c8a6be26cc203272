"""Partition rules: map a model's parameter names to placements on the mesh.

Counterpart of ``ray_tpu/parallel/sharding.py``. Rules are (regex,
PartitionSpec) pairs matched against "path/like/this" parameter names,
first match wins, replicated by default, and a spec is cut to the
parameter's rank. ``gpt_rules`` gives the JAX package's GPT-2 specs on the
port's per-layer parameters.

Where JAX hands the specs to GSPMD, which inserts the collectives,
``shard_model`` places the parameters in PyTorch's idiom:

  - "tp": Megatron-style tensor parallelism. Each rank keeps its slice of
    the dimension as a plain tensor and the model computes on it with the
    collectives of ``tensor_parallel``;
  - "fsdp": ZeRO-3 through FSDP2 (``fully_shard``) over the data axes,
    replicated over dcn x dp and sharded over fsdp (HSDP), the shard on the
    dimension the spec names. FSDP2 shards every parameter it holds: one
    whose spec names no fsdp dimension (biases and layernorms; every
    parameter under ``gpt_rules(fsdp=False)``) is sharded on its first
    dimension. That is storage only: FSDP2 gathers each parameter whole
    before a module runs and averages its gradient over the data axes, so
    what is computed is the same.

``named_sharding`` and ``with_sharding_constraint`` keep their meaning
outside ``jit``: a sharding is a mesh and one DTensor placement per mesh
dimension, and a constraint redistributes a DTensor to it.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ray_tpu_torch.parallel.mesh import data_parallel_meshes
from ray_tpu_torch.parallel.tensor_parallel import AxisGroup


class PartitionSpec(tuple):
    """One entry per tensor dimension: a mesh axis name, a tuple of names
    (the dimension split over their product, the first outermost), or None
    (not split). ``jax.sharding.PartitionSpec``'s counterpart."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


class PartitionRules:
    def __init__(self, rules: Sequence[Tuple[str, PartitionSpec]]):
        self._rules = [(re.compile(pat), spec) for pat, spec in rules]

    def spec_for(self, path: str) -> PartitionSpec:
        for pat, spec in self._rules:
            if pat.search(path):
                return spec
        return P()  # replicated by default

    def tree_specs(self, model: torch.nn.Module) -> Dict[str, PartitionSpec]:
        """The spec of every parameter of ``model``, by its dotted name,
        cut to the parameter's rank."""
        specs = {}
        for name, param in model.named_parameters():
            spec = self.spec_for(path_str(name))
            specs[name] = P(*spec[:param.dim()])  # drop axes the leaf doesn't have
        return specs


def path_str(name: str) -> str:
    """"blocks.0.attn.qkv.kernel" -> "blocks/0/attn/qkv/kernel": the
    JAX package's path form, which its rules match."""
    return name.replace(".", "/")


class NamedSharding(NamedTuple):
    """A mesh and one DTensor placement per mesh dimension:
    ``distribute_tensor(x, *sharding)`` places a tensor so."""

    mesh: DeviceMesh
    placements: Tuple[Any, ...]


def placements(spec: Sequence, mesh_dim_names: Sequence[str]) -> Tuple[Any, ...]:
    """The DTensor placements of ``spec`` on a mesh with these dimensions:
    Shard(d) on the mesh dimension that splits tensor dimension d,
    Replicate() on the rest. A tensor dimension split over several mesh
    dimensions has no single-placement form here."""
    out: List[Any] = [Replicate()] * len(mesh_dim_names)
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        if len(names) != 1:
            raise NotImplementedError(f"dimension {dim} split over several axes {names}")
        out[list(mesh_dim_names).index(names[0])] = Shard(dim)
    return tuple(out)


def named_sharding(mesh: DeviceMesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, placements(spec, mesh.mesh_dim_names))


def with_sharding_constraint(x: Any, mesh: Optional[DeviceMesh], *spec) -> Any:
    """Lay a DTensor out as ``spec`` says (``DTensor.redistribute``): the
    collectives run now, where JAX's constraint lets the compiler place
    them. No-op without a mesh or on a trivial all-ones mesh. A plain
    tensor holds no layout to change: it raises on a real mesh."""
    if mesh is None or all(s == 1 for s in mesh.shape):
        return x
    if not isinstance(x, DTensor):
        raise TypeError("with_sharding_constraint changes the layout of a DTensor; "
                        f"got {type(x).__name__}")
    return x.redistribute(mesh, placements(spec, mesh.mesh_dim_names))


# ---------------------------------------------------------------------------
# Placing a model on the mesh
# ---------------------------------------------------------------------------


def _axis(mesh: DeviceMesh, name: str) -> Optional[AxisGroup]:
    """The group along one dimension of the mesh; None where it has one rank."""
    sub = mesh[name]
    if sub.size() == 1:
        return None
    return AxisGroup(sub.get_group(), sub.size(), sub.get_local_rank())


def shard_model(model: torch.nn.Module, mesh: DeviceMesh,
                rules: PartitionRules) -> torch.nn.Module:
    """Place ``model``'s parameters on ``mesh`` as ``rules`` say, in place;
    returns the model. Every rank of the mesh calls it, on a model holding
    the same full parameters.

    A spec may name "tp" and "fsdp" (see the module's docstring), each on
    at most one dimension. The model declares what it computes on shards:
    every submodule with a ``tp`` attribute gets the tp group (None where
    tp has one rank), ``model.blocks`` are FSDP2's units beside the root,
    and the model's ``loss`` method runs under FSDP2's hooks like
    ``forward`` (GPT2 in ``models/gpt2.py``). The model also gets ``data``,
    the group over dcn x dp x fsdp that splits the batch, and
    ``partition_specs``, each parameter's spec."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method

    hsdp, flat = data_parallel_meshes(mesh)
    tp = _axis(mesh, "tp")
    specs = rules.tree_specs(model)
    params = dict(model.named_parameters())
    for name, spec in specs.items():  # every spec checked before any parameter moves
        unknown = [a for a in spec if a not in (None, "tp", "fsdp")]
        if unknown or spec.count("tp") > 1 or spec.count("fsdp") > 1:
            raise NotImplementedError(f"{name}: spec {spec} (shard_model places tp and fsdp, "
                                      "one dimension each)")
        if tp is not None and "tp" in spec and params[name].shape[spec.index("tp")] % tp.size:
            raise ValueError(f"{name}: dimension {spec.index('tp')} of "
                             f"{tuple(params[name].shape)} does not split over tp {tp.size}")
    fsdp_dim = {}
    for name, param in params.items():
        spec = specs[name]
        if tp is not None and "tp" in spec:
            param.data = param.data.chunk(tp.size, spec.index("tp"))[tp.rank].clone()
        fsdp_dim[param] = spec.index("fsdp") if "fsdp" in spec else 0

    def placement(param):
        return Shard(fsdp_dim[param])

    for block in getattr(model, "blocks", ()):
        fully_shard(block, mesh=hsdp, shard_placement_fn=placement)
    fully_shard(model, mesh=hsdp, shard_placement_fn=placement)
    if hasattr(model, "loss"):
        register_fsdp_forward_method(model, "loss")
    for module in model.modules():
        if hasattr(module, "tp"):
            module.tp = tp
    model.data = AxisGroup(flat.get_group(), flat.size(), flat.get_local_rank())
    model.partition_specs = specs
    return model


def full_parameters(model: torch.nn.Module, grads: bool = False) -> Dict[str, torch.Tensor]:
    """Every parameter (or, with ``grads``, its gradient) of a model placed
    by ``shard_model``, whole, by name: gathered over the data axes and
    over tp. Collective: every rank of the mesh calls it."""
    tp = next((m.tp for m in model.modules() if getattr(m, "tp", None) is not None), None)
    out = {}
    for name, param in model.named_parameters():
        t = param.grad if grads else param
        t = t.full_tensor() if isinstance(t, DTensor) else t
        t = t.detach()
        spec = model.partition_specs[name]
        if tp is not None and "tp" in spec:
            parts = [torch.empty_like(t) for _ in range(tp.size)]
            dist.all_gather(parts, t.contiguous(), group=tp.group)
            t = torch.cat(parts, dim=spec.index("tp"))
        out[name] = t
    return out


# ---------------------------------------------------------------------------
# Standard rule sets
# ---------------------------------------------------------------------------


def gpt_rules(fsdp: bool = True) -> PartitionRules:
    """Sharding for ray_tpu_torch.models.gpt2's per-layer parameters.

    TP shards attention heads, the MLP hidden width and the vocabulary;
    FSDP shards the complementary (large) dimension of each matrix:
    Megatron-style TP composed with ZeRO-3. The JAX package's specs less
    their leading layer axis (the scan's, never sharded).

    Shapes: wte (V,D) · wpe (T,D) · qkv.kernel (D,3,H,Dh) ·
    qkv.bias (3,H,Dh) · proj.kernel (H,Dh,D) · fc_in (D,F) · fc_out (F,D).
    """
    f = "fsdp" if fsdp else None
    return PartitionRules([
        (r"wte", P("tp", f)),
        (r"wpe", P(None, f)),
        (r"attn/qkv/kernel", P(f, None, "tp", None)),
        (r"attn/qkv/bias", P(None, "tp", None)),
        (r"attn/proj/kernel", P("tp", None, f)),
        (r"mlp/fc_in/kernel", P(f, "tp")),
        (r"mlp/fc_in/bias", P("tp")),
        (r"mlp/fc_out/kernel", P("tp", f)),
        # everything else (layernorms, remaining biases) replicated
        (r"bias|scale", P()),
    ])


def batch_spec() -> PartitionSpec:
    """Batch dims shard over all data axes (dcn outer, then dp, fsdp)."""
    return P(("dcn", "dp", "fsdp"))
