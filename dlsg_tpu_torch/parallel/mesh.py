"""The (data, model) mesh over ranks and the tensor-parallel layout
(counterpart of `dlsg_tpu/parallel/mesh.py`).

The JAX package reshapes its devices into a `(data, model)` mesh and lets
XLA partition the program. Here one process drives one card, so the mesh
is over the ranks of the process group, in JAX's reshape order: rank
`data_index * n_model + model_index`, the model axis fastest. `make_mesh`
creates the two kinds of process group that the collectives run over (the
model group: the ranks of one data index, which hold the same rows; the
data group: the ranks of one model index, which hold the same shard) and
makes the mesh the live one for `parallel/dist.py`.

The tensor-parallel rules are JAX's `TP_RULES` under this package's
parameter names: the vocab projection `decoder.step.word_restore` is split
over the model axis by its output columns. The torch `Dense` stores its
kernel as [out, in], so its weight [V, Hd] is split by rows and its bias
[V] with it; everything else is replicated. As in JAX, a leaf whose split
dimension does not divide by the model axis stays replicated (a 39-word
vocabulary on model 2). `shard_train_state` cuts the Adam moments with
their parameters, and `whole_state_dict`/`whole_optimizer_state` gather the
shards back (checkpoints hold whole tensors, independent of the layout).

`batch_sharding`, `replicated` and `shard_batch` have no counterpart: they
place arrays for XLA, and here every collective is explicit.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from dlsg_tpu_torch.parallel import dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# parameter-name substring -> the dimension split over `model`
TP_RULES: Tuple[Tuple[str, int], ...] = (
    ("decoder.step.word_restore.weight", 0),
    ("decoder.step.word_restore.bias", 0),
)

Specs = Dict[str, Optional[int]]


@dataclass(frozen=True)
class Mesh:
    """A (data, model) mesh over the ranks: the axis sizes, this rank's
    place on it and the groups of its two axes (None where the group is the
    whole world or a single rank, which need no group of their own)."""

    n_data: int
    n_model: int
    data_index: int = 0
    model_index: int = 0
    data_group: Any = None  # the ranks of this model index
    model_group: Any = None  # the ranks of this data index

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The (n_data, n_model) mesh over the process group's ranks, made the
    live mesh (`parallel/dist.py::current_mesh`). `n_data` None or -1
    takes the rest of the world. The product must be the world size
    (without a process group, 1: the (1, 1) mesh, with no group and no
    collective).

    Every rank must call this with the same arguments: it creates every
    group on every rank, in one order, as `torch.distributed.new_group`
    requires."""
    world = dist.world_size()
    if n_model < 1:
        raise ValueError(f"mesh_model_axis={n_model}: must be >= 1")
    hint = "" if dist.is_distributed() else (
        " (no process group: launch one process per rank with torchrun and --distributed)"
    )
    if n_data is None or n_data < 0:
        if world % n_model:
            raise ValueError(f"mesh_model_axis={n_model} does not divide the world size {world}{hint}")
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(
            f"mesh_data_axis={n_data} x mesh_model_axis={n_model} = {n_data * n_model} ranks, "
            f"but the world size is {world}{hint}"
        )
    r = dist.rank()
    data_group = model_group = None
    if dist.is_distributed() and n_model > 1:
        import torch.distributed as tdist

        for d in range(n_data):
            g = tdist.new_group([d * n_model + m for m in range(n_model)])
            if d == r // n_model:
                model_group = g
        for m in range(n_model):
            g = tdist.new_group([d * n_model + m for d in range(n_data)])
            if m == r % n_model:
                data_group = g
    mesh = Mesh(n_data, n_model, r // n_model, r % n_model, data_group, model_group)
    dist.set_mesh(mesh)
    return mesh


def param_sharding_specs(
    params: Mapping[str, torch.Tensor], rules=TP_RULES, mesh: Optional[Mesh] = None
) -> Specs:
    """{name: the dimension split over `model`, or None (replicated)} for a
    state_dict or named parameters. With `mesh`, a rule applies only where
    that dimension divides by the model axis (JAX's rule)."""

    def spec(name, t):
        for sub, dim in rules:
            if sub in name and (mesh is None or t.shape[dim] % mesh.n_model == 0):
                return dim
        return None

    return {name: spec(name, t) for name, t in params.items()}


def _shard_rows(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    n = t.shape[dim] // mesh.n_model
    return t.narrow(dim, mesh.model_index * n, n).clone()


def sharded_parameters(module: nn.Module) -> Dict[str, int]:
    """{name: split dimension} of every parameter that `shard_params` split
    (the rows of a Dense marked with `out_shard`); empty for a whole model."""
    return {f"{mname}.{pname}" if mname else pname: 0
            for mname, m in module.named_modules() if getattr(m, "out_shard", None) is not None
            for pname, _ in m.named_parameters(recurse=False)}


def shard_params(module: nn.Module, mesh: Mesh, rules=TP_RULES) -> Dict[str, int]:
    """Keep this rank's rows of every parameter the rules split (in place:
    the Parameter objects stay, their data shrinks), and mark each split
    module with `out_shard = (first column, whole width)`. Returns the split
    parameters' {name: dim}; a model axis of 1, or a vocabulary that does
    not divide by it, splits nothing."""
    if mesh.n_model == 1:
        return {}
    named = dict(module.named_parameters())
    specs = {n: d for n, d in param_sharding_specs(named, rules, mesh).items() if d is not None}
    owners = {}
    for mname, m in module.named_modules():
        for pname, _ in m.named_parameters(recurse=False):
            owners[f"{mname}.{pname}" if mname else pname] = m
    with torch.no_grad():
        for name, dim in specs.items():
            p = named[name]
            whole = p.shape[dim]
            p.data = _shard_rows(p.data, dim, mesh)
            m = owners[name]
            n = whole // mesh.n_model
            m.out_shard = (mesh.model_index * n, whole)
    return specs


def shard_train_state(state, mesh: Mesh, rules=TP_RULES) -> Dict[str, int]:
    """`shard_params` on a TrainState's module, and the same rows of the
    Adam moments of each split parameter (present after a restore; a fresh
    optimizer makes them at the shard's shape). Returns the split names."""
    specs = shard_params(state.module, mesh, rules)
    by_name = dict(zip(state.names, state.params))
    for name, dim in specs.items():
        p = by_name.get(name)
        st = state.optimizer.state.get(p) if p is not None else None
        for key in ("exp_avg", "exp_avg_sq"):
            if st and key in st and st[key].shape != p.shape:
                st[key] = _shard_rows(st[key], dim, mesh)
    return specs


def _gather_rows(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The model group's slices of `t` joined along `dim` (a collective)."""
    m = dist.current_mesh()
    (parts,) = dist.all_gather_tensors([t], m.model_group)
    return torch.cat(list(parts.unbind(0)), dim=dim)


def whole_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The module's state_dict with every split parameter gathered whole
    over the model group: a collective that every rank of the group must
    join. For a whole model, its state_dict."""
    sd = module.state_dict()
    split = sharded_parameters(module)
    if not split:
        return sd
    return {k: (_gather_rows(v, split[k]) if k in split else v) for k, v in sd.items()}


def whole_optimizer_state(state) -> Dict[str, Any]:
    """A TrainState's optimizer state_dict with the Adam moments of split
    parameters gathered whole (a collective, as `whole_state_dict`)."""
    sd = state.optimizer.state_dict()
    split = sharded_parameters(state.module)
    if not split:
        return sd
    sd = {"state": copy.copy(sd["state"]), "param_groups": sd["param_groups"]}
    for i, name in enumerate(state.names):
        if name not in split or i not in sd["state"]:
            continue
        entry = dict(sd["state"][i])
        for key in ("exp_avg", "exp_avg_sq"):
            if key in entry:
                entry[key] = _gather_rows(entry[key], split[name])
        sd["state"][i] = entry
    return sd
