"""Device mesh for BTF Gibbs state on ``torch.distributed``.

Counterpart of functionalmf_tpu/parallel/mesh.py. A mesh has two axes:

  * ``dp``: chains (each rank of a dp line holds a block of the chains);
  * ``mp``: rows of W and columns of V (and of Tau2), each rank of an mp
    line holds a block of them.

Each process is one rank of a ``torch.distributed`` group and one point
(i_dp, i_mp) of the mesh, rank = i_dp * n_mp + i_mp (the row-major order
of the JAX package's ``devices.reshape(n_dp, n_mp)``). A line of the mesh
(the ranks that differ only in one axis) has a process group of its own,
and the models' collectives run on those groups.

Partition specs are explicit per model (``state_partition_specs()``, a
tuple of axis names or None a dimension); this module turns them into
slices, dropping a mesh axis from a dimension it does not divide evenly
(``feasible_spec``, JAX's rule: GDELT's 19 rows over mp=4 are replicated).
``shard_state`` takes a global state to this rank's slices and
``gather_state`` puts the slices back together on every rank.

Backends, chosen by the caller and never switched on their own:
``"nccl"`` when each rank owns one card, ``"gloo"`` on the CPU or when
several ranks share one card (gloo runs ``all_gather`` and ``all_reduce``
on CUDA tensors itself). Every collective that a rank enters, every other
rank of its line enters in the same order: the models take every branch
from values that all ranks of a line hold alike.
"""
from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["DP_AXIS", "MP_AXIS", "Mesh", "init_distributed", "make_mesh",
           "feasible_spec", "state_specs", "shard_state", "gather_state"]

DP_AXIS = "dp"
MP_AXIS = "mp"
AXES = (DP_AXIS, MP_AXIS)

# seconds a rank waits in a collective or at the rendezvous before it
# raises, so that a rank whose peer died fails instead of hanging
DEFAULT_TIMEOUT_S = 300.0

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int, *, backend: str,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group: ``coordinator_address`` is an init URL
    (``tcp://host:port`` or ``file:///path``; a bare ``host:port`` means
    tcp), ``backend`` is ``"nccl"`` or ``"gloo"``. Call once per process,
    before ``make_mesh``."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(
        backend, init_method=url, world_size=int(num_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(seconds=float(timeout_s)))


class Mesh:
    """This rank's view of a (dp, mp) mesh: the axis sizes, its own
    coordinates, its ``torch.device`` and a process group for each of its
    two lines (None for an axis of size 1, whose collectives are the
    identity)."""

    axis_names = AXES

    def __init__(self, n_dp, n_mp, coords, device, groups):
        self.shape = {DP_AXIS: int(n_dp), MP_AXIS: int(n_mp)}
        self.coords = dict(coords)
        self.device = torch.device(device)
        self._groups = dict(groups)

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    @property
    def rank(self) -> int:
        """This rank's place in the process group, i_dp * n_mp + i_mp."""
        return (self.coords[DP_AXIS] * self.shape[MP_AXIS]
                + self.coords[MP_AXIS])

    def all_gather(self, x: torch.Tensor, axis: str, dim: int = 0):
        """The blocks of ``x`` of every rank of this rank's ``axis`` line,
        concatenated along ``dim`` in mesh order."""
        group = self._groups[axis]
        if group is None:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.shape[axis])]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    def all_reduce(self, x: torch.Tensor, axis: str, op: str = "sum"):
        """``x`` reduced elementwise (``"sum"``, ``"min"`` or ``"max"``)
        over this rank's ``axis`` line; a new tensor."""
        group = self._groups[axis]
        if group is None:
            return x
        out = x.contiguous().clone()
        dist.all_reduce(out, op=_OPS[op], group=group)
        return out

    def broadcast(self, x: torch.Tensor, axis: str):
        """``x`` of the first rank of this rank's ``axis`` line, on every
        rank of the line; a new tensor."""
        group = self._groups[axis]
        if group is None:
            return x
        out = x.contiguous().clone()
        dist.broadcast(out, src=dist.get_global_rank(group, 0), group=group)
        return out

    def barrier(self):
        """Wait until every rank of the mesh gets here (a mesh of one rank,
        which has no process group, does not wait)."""
        if self.shape[DP_AXIS] * self.shape[MP_AXIS] > 1:
            dist.barrier()


def make_mesh(n_dp: int = 1, n_mp: int | None = None,
              device_type: str = "cuda") -> Mesh:
    """A (dp, mp) mesh over every rank of the process group. Rank r works
    on ``cuda:(r % device_count)`` (so ranks of one host take a card each,
    or all share the one card there is), or on the CPU with
    ``device_type="cpu"``. Every rank calls this, with the same sizes."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "init_distributed first")
    world = dist.get_world_size()
    n_dp = int(n_dp)
    n_mp = world // n_dp if n_mp is None else int(n_mp)
    if n_dp < 1 or n_mp < 1 or n_dp * n_mp != world:
        raise ValueError(f"a ({n_dp}, {n_mp}) mesh needs {n_dp * n_mp} "
                         f"ranks; the group has {world}")
    rank = dist.get_rank()
    i_dp, i_mp = divmod(rank, n_mp)
    if device_type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    elif device_type == "cpu":
        device = torch.device("cpu")
    else:
        raise ValueError(f"unsupported device_type {device_type!r}")
    grid = np.arange(world).reshape(n_dp, n_mp)
    groups = {DP_AXIS: None, MP_AXIS: None}
    # every rank creates every group, in the same order
    if n_mp > 1:
        for i in range(n_dp):
            g = dist.new_group(ranks=grid[i].tolist())
            if i == i_dp:
                groups[MP_AXIS] = g
    if n_dp > 1:
        for j in range(n_mp):
            g = dist.new_group(ranks=grid[:, j].tolist())
            if j == i_mp:
                groups[DP_AXIS] = g
    return Mesh(n_dp, n_mp, {DP_AXIS: i_dp, MP_AXIS: i_mp}, device, groups)


def feasible_spec(sizes, spec, shape) -> tuple:
    """``spec`` with every mesh axis dropped from a dimension that it does
    not divide evenly (functionalmf_tpu/parallel/mesh.py:_feasible_spec).
    ``sizes``: a Mesh or {axis: size}; ``spec``: axis names or None, one a
    leading dimension; trimmed to ``len(shape)``."""
    sizes = sizes.shape if isinstance(sizes, Mesh) else dict(sizes)
    out = []
    for d, name in enumerate(tuple(spec)[:len(shape)]):
        if name is None or name not in sizes:
            out.append(None)
        elif shape[d] % sizes[name] == 0:
            out.append(name)
        else:
            out.append(None)
    return tuple(out)


def state_specs(mesh: Mesh, specs: dict | None, state: dict) -> dict:
    """{key: feasible spec} of a global state dict. Without ``specs`` only
    the chain axis (dimension 0) is sharded, over dp."""
    return {k: feasible_spec(mesh, (DP_AXIS,) if specs is None else specs[k],
                             tuple(np.shape(v)))
            for k, v in state.items()}


def _block(mesh, spec, shape):
    idx = []
    for d, name in enumerate(spec):
        if name is None or mesh.size(name) == 1:
            idx.append(slice(None))
        else:
            b = shape[d] // mesh.size(name)
            i = mesh.index(name)
            idx.append(slice(i * b, (i + 1) * b))
    return tuple(idx)


def shard_state(state: dict, mesh: Mesh, specs: dict | None = None) -> dict:
    """This rank's slices of a global state (tensors or numpy arrays, the
    same values on every rank), as tensors on ``mesh.device``."""
    out = {}
    for k, spec in state_specs(mesh, specs, state).items():
        v = state[k]
        v = (v if isinstance(v, torch.Tensor)
             else torch.as_tensor(np.asarray(v))).to(mesh.device)
        idx = _block(mesh, spec, tuple(v.shape))
        sliced = any(s != slice(None) for s in idx)
        out[k] = v[idx].clone() if sliced else v
    return out


def gather_state(local_state: dict, mesh: Mesh, specs: dict) -> dict:
    """The global state, on every rank, from each rank's slices
    (the counterpart of the JAX package's ``make_global_array``).
    ``specs`` are the feasible specs of the global state, as
    ``state_specs`` gives them. Every rank calls this together."""
    out = {}
    for k, v in local_state.items():
        for d, name in enumerate(specs[k]):
            if name is not None:
                v = mesh.all_gather(v, name, dim=d)
        out[k] = v
    return out
