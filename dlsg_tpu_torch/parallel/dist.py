"""Data and tensor parallelism over `torch.distributed` (with
`parallel/mesh.py`, the counterpart of `dlsg_tpu/parallel/mesh.py`).

The JAX package lays a `(data, model)` mesh over its devices and lets XLA
insert the collectives. Here one process drives one card, as `torchrun`
launches them. Without a mesh (or with a model axis of 1) the whole world
is the data axis; a mesh with a model axis (`parallel/mesh.py::make_mesh`)
splits the world into data groups (the ranks of one model index) and model
groups (the ranks of one data index, which hold the same rows). Every
data-parallel helper below works over the data axis: its size
(`data_size`), this rank's index on it (`data_rank`) and its group. The
collectives are explicit:

- a train step's loss on each rank is that rank's share of the global loss
  (its local sum over the global count), so the global gradient is the sum
  of the ranks' gradients: `all_reduce_grads`, one collective per state
  update;
- computations that the JAX package takes over the global batch (the masked
  CE's token count, PSLScore2's batch mean, the penalty's row mean) go
  through `global_sum`, an all-reduce whose backward is itself;
- the eval fan-in `gather_eval` merges the ranks' decoded shards;
- the column-split vocab head (model axis) runs `copy_to_model` on its input
  (identity; the backward all-reduces the partial input gradient over the
  model group) and `gather_from_model` on its logits (an all-gather of the
  last dimension; the backward keeps this rank's slice, since the loss
  downstream is replicated over the model group).

Every rank must run the same collectives in the same order: no rank may
branch around one.

Random draws: every rank seeds the same generator from (seed, step), so a
draw made once for the whole batch (the scheduled-sampling coins) is the
same on every rank. A draw made per row (dropout masks, the penalty's mixing
weights) is drawn at `(data_size, *shape)` and each rank keeps the block of
its data index (`rank_block_rand`): the generators stay in step, the data
ranks' masks are independent, model peers (which hold the same rows) draw
the same masks, and world size 1 draws exactly the single-process numbers.
The JAX package draws such masks over the global batch instead: the
distributions are the same, the bits are not.

Without a process group every function here is the single-process
identity: world size 1, rank 0, no collective. Without a mesh, or with a
mesh whose model axis is 1, every call is the whole-world one it was before
the model axis existed.
"""

from __future__ import annotations

import datetime
import os
from typing import TYPE_CHECKING, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from dlsg_tpu_torch.device import DeviceLike

if TYPE_CHECKING:
    from dlsg_tpu_torch.parallel.mesh import Mesh

_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(
    device: DeviceLike = None,
    backend: Optional[str] = None,
    timeout: Optional[datetime.timedelta] = None,
) -> torch.device:
    """Join the process group that `torchrun` describes in the environment
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and return this
    rank's device: `cuda:LOCAL_RANK` (default), the card `device` names by
    index, or the CPU (`device="cpu"`).

    The backend is NCCL on a card and gloo on the CPU unless `backend` names
    one (two ranks on one card need gloo: NCCL refuses to put them there)."""
    missing = [k for k in _ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--distributed: {', '.join(missing)} not set; launch with torchrun "
            "(python -m torch.distributed.run --nproc_per_node=N -m dlsg_tpu_torch.cli ...)"
        )
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method="env://",
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
        **kw,
    )
    return dev


def is_distributed() -> bool:
    """True inside a process group."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def is_leader() -> bool:
    return rank() == 0


def barrier() -> None:
    if is_distributed():
        dist.barrier()


# the mesh `parallel/mesh.py::make_mesh` made last; live while the process
# group that it was made in is
_MESH: Optional["Mesh"] = None


def set_mesh(mesh: Optional["Mesh"]) -> None:
    """Make `mesh` the live mesh (make_mesh does); None drops it."""
    global _MESH
    _MESH = mesh


def current_mesh() -> Optional["Mesh"]:
    """The live mesh inside a process group, else None."""
    return _MESH if _MESH is not None and is_distributed() else None


def data_size() -> int:
    """The size of the data axis: the world without a mesh."""
    m = current_mesh()
    return m.n_data if m is not None else world_size()


def data_rank() -> int:
    """This rank's index on the data axis (the shard of the batch it holds)."""
    m = current_mesh()
    return m.data_index if m is not None else rank()


def _data_axis() -> Tuple[bool, Optional[dist.ProcessGroup]]:
    """(whether data-axis collectives run, their group): the whole world
    (group None, at any world size) without a mesh or with a model axis of
    1; with a model axis, the data group, and none when the data axis is
    one rank."""
    if not is_distributed():
        return False, None
    m = current_mesh()
    if m is None or m.n_model == 1:
        return True, None
    return m.n_data > 1, m.data_group


def data_axis_active() -> bool:
    """Whether data-axis collectives run (`global_sum`, `all_reduce_grads`)."""
    return _data_axis()[0]


def global_rows(n: int) -> int:
    """The global row count of a batch of which this rank holds `n` rows:
    every data rank holds the same number (train batches drop the
    remainder)."""
    return n * data_size()


class _GlobalSum(torch.autograd.Function):
    """Sum over the ranks, replicated on every rank. The gradient of a
    replicated sum at each input is the sum of the ranks' upstream
    gradients, so the backward is this function again; applied through
    `.apply`, it is differentiable to any order (the gradient penalty's
    double backward passes through it)."""

    @staticmethod
    def forward(ctx, x):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=_data_axis()[1])
        return y

    @staticmethod
    def backward(ctx, g):
        return _GlobalSum.apply(g)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the data axis, on every rank; differentiable.
    Without a process group (or on a data axis of one rank), `x` itself."""
    return _GlobalSum.apply(x) if _data_axis()[0] else x


def rank_block_rand(shape: Sequence[int], generator: torch.Generator, device) -> torch.Tensor:
    """U[0, 1) of `shape`: this data index's block of one draw at
    (data_size, *shape) (module doc). At world size 1, bitwise
    `torch.rand(shape)`."""
    draw = torch.rand((data_size(), *shape), generator=generator, device=device)
    return draw[data_rank()]


def all_reduce_grads(grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum of each gradient over the data axis: flattened into one
    buffer (one per dtype), one all-reduce, split back. Without a process
    group (or on a data axis of one rank) the list as it is."""
    grads = list(grads)
    active, group = _data_axis()
    if not active:
        return grads
    out: List[Optional[torch.Tensor]] = [None] * len(grads)
    for dtype in sorted({g.dtype for g in grads}, key=str):
        idx = [i for i, g in enumerate(grads) if g.dtype == dtype]
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        for i, part in zip(idx, torch.split(flat, [grads[i].numel() for i in idx])):
            out[i] = part.view(grads[i].shape)
    return out


@torch.no_grad()
def broadcast_module(module: nn.Module) -> None:
    """Overwrite every parameter and buffer of `module` with rank 0's."""
    if not is_distributed():
        return
    for t in module.state_dict().values():
        dist.broadcast(t, src=0)


def _collective_device() -> torch.device:
    """Where the gather's tensors live: NCCL reduces on the card; gloo
    gathers CPU tensors (it takes CUDA tensors only for broadcast and
    all_reduce)."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_from_leader(t: torch.Tensor) -> torch.Tensor:
    """Rank 0's `t` (the others give a tensor of its shape and dtype), on
    every rank, on the host."""
    x = t.to(_collective_device())
    dist.broadcast(x, src=0)
    return x.cpu()


def _all_gather(a: np.ndarray, group=None) -> np.ndarray:
    """[n, *a.shape]: every rank's `a` (same shape and dtype on all) over
    `group` (default: the world) of n ranks, in rank order."""
    (parts,) = all_gather_tensors([torch.from_numpy(np.ascontiguousarray(a))], group)
    return parts.numpy()


def all_gather_tensors(ts: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """For each tensor of `ts`, the ranks' tensors of `group` stacked on a
    new leading axis, in group-rank order, on the tensor's own device. Under
    gloo the tensors go through the host (gloo gathers CPU tensors only)."""
    dev = _collective_device()
    out = []
    for t in ts:
        x = t.detach().contiguous().to(dev)
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        out.append(torch.stack(parts).to(t.device))
    return out


# ------------------------------------------------------- the model axis


def _model_group():
    m = current_mesh()
    if m is None or m.n_model == 1:
        raise RuntimeError("a model-axis collective needs a live mesh with a model axis > 1")
    return m, m.model_group


class _CopyToModel(torch.autograd.Function):
    """Identity; the backward sums the gradient over the model group."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _ReduceFromModel.apply(g)


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce over the model group; the backward is the identity copy."""

    @staticmethod
    def forward(ctx, x):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=_model_group()[1])
        return y

    @staticmethod
    def backward(ctx, g):
        return _CopyToModel.apply(g)


class _GatherFromModel(torch.autograd.Function):
    """All-gather of the last dimension over the model group (model-index
    order); the backward keeps this rank's slice."""

    @staticmethod
    def forward(ctx, x):
        _, group = _model_group()
        (parts,) = all_gather_tensors([x], group)
        return torch.cat(list(parts.unbind(0)), dim=-1)

    @staticmethod
    def backward(ctx, g):
        return _SplitToModel.apply(g)


class _SplitToModel(torch.autograd.Function):
    """This rank's slice of the last dimension; the backward gathers."""

    @staticmethod
    def forward(ctx, x):
        m, _ = _model_group()
        n = x.shape[-1] // m.n_model
        return x[..., m.model_index * n:(m.model_index + 1) * n].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _GatherFromModel.apply(g)


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """The input of a column-split layer: `x` itself; its gradient (this
    rank's partial dx = dy_local @ W_local) is summed over the model group.
    Differentiable to any order."""
    return _CopyToModel.apply(x)


def gather_from_model(x: torch.Tensor) -> torch.Tensor:
    """The output of a column-split layer: the model group's [..., n] slices
    joined into [..., n_model * n]; the gradient keeps this rank's slice.
    Differentiable to any order."""
    return _GatherFromModel.apply(x)


def gather_eval(
    ids: np.ndarray, vids: np.ndarray, alphas: Optional[np.ndarray]
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """The eval fan-in (counterpart of `_gather_across_hosts` in
    `dlsg_tpu/evaluation/evaluate.py`): each rank gives its shard's token ids
    [n, T], video ids [n] and attention weights [n, T, 2P] (or None), and
    every rank gets the whole set, in data-index order (the gather runs over
    the data axis: model peers hold the same shard).

    A metadata round goes first, so that a rank whose shard is empty (an
    eval set smaller than the world) still joins with padding of the right
    shape; the payloads are padded to the largest shard, pad rows marked by
    video id -1. Without a process group (or on a data axis of one rank) the
    inputs come back as they are."""
    active, group = _data_axis()
    if not active:
        return ids, vids, alphas
    meta = np.zeros(8, np.int64)  # [n, T, has_alpha, *alpha trailing shape]
    meta[0] = ids.shape[0]
    meta[1] = ids.shape[1] if ids.ndim == 2 else 0
    if alphas is not None:
        trail = alphas.shape[1:]
        meta[2] = 1
        meta[3 : 3 + len(trail)] = trail
    metas = _all_gather(meta, group)
    n_max, t_max = int(metas[:, 0].max()), int(metas[:, 1].max())
    if n_max == 0:  # every shard empty
        return ids, vids, alphas

    def pad(a, fill, shape, dtype):
        out = np.full(shape, fill, dtype)
        if a.size:
            out[tuple(slice(0, s) for s in a.shape)] = a
        return out

    ids_g = _all_gather(pad(ids, 0, (n_max, t_max), np.int64), group)
    vids_g = _all_gather(pad(np.asarray(vids, np.int64), -1, (n_max,), np.int64), group)
    keep = vids_g.reshape(-1) >= 0
    ids_all = ids_g.reshape(-1, t_max)[keep]
    vids_all = vids_g.reshape(-1)[keep]
    alpha_all = None
    if metas[:, 2].max():  # some rank decoded attention weights
        row = metas[int(np.argmax(metas[:, 2]))]
        trail = tuple(int(v) for v in row[3:] if v > 0)
        local = alphas if alphas is not None else np.zeros((0,) + trail, np.float32)
        al_g = _all_gather(pad(np.asarray(local, np.float32), 0.0, (n_max,) + trail, np.float32),
                           group)
        alpha_all = al_g.reshape((-1,) + trail)[keep]
    return ids_all, vids_all, alpha_all
