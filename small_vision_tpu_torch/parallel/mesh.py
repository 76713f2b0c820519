"""The process mesh and distributed init.

Counterpart of small_vision_tpu/parallel/mesh.py. One process drives one
card (or one CPU), so a mesh is a grid of processes: a
`torch.distributed.device_mesh.DeviceMesh` over the ranks, with the JAX
axis names and sizes, whose sub-groups carry the collectives:

  make_mesh()                          # ("data",) over every process
  make_mesh(fsdp=0)                    # ("data", "fsdp") = (1, n)
  make_mesh(data=2, fsdp=2)            # ("data", "fsdp") = (2, 2)
  make_mesh(pipe=2)                    # ("data", "pipe") = (n/2, 2)

Axis roles as in JAX: `data` and `fsdp` shard the batch (`BATCH_AXES`);
`fsdp` also shards parameters and optimizer state; `tensor` is reserved for
tensor parallelism; `pipe` holds pipeline stages. Only axes over 1 and
`data` are kept. Rank r sits at `np.unravel_index(r, shape)`, as the JAX
mesh lays out devices in order.

Without a process group the mesh is one process with no groups: every
collective on it is the single-process fast path. `make_mesh(n)` with
n > 1 and no process group gives a layout-only mesh (shapes and
coordinates, no groups), which `infer_sharding` and the tests read.
"""

from typing import Optional

import numpy as np

AXES = ("data", "fsdp", "tensor", "pipe")
BATCH_AXES = ("data", "fsdp")


def _dist():
  import torch.distributed as dist
  return dist


def is_distributed() -> bool:
  dist = _dist()
  return dist.is_available() and dist.is_initialized()


def process_index() -> int:
  return _dist().get_rank() if is_distributed() else 0


def process_count() -> int:
  return _dist().get_world_size() if is_distributed() else 1


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device="cuda"):
  """Joins a process group; a no-op for one process or when one exists.

  Without arguments it reads the launcher's environment
  (`launch.env_rank_size`, `launch.coordinator_address`) and does nothing
  when there is none. NCCL on the cards, gloo on the CPU.
  """
  if is_distributed():
    return
  from small_vision_tpu_torch import launch
  if num_processes is None:
    env = launch.env_rank_size()
    if env is None or env[1] <= 1:
      return
    launch.mpi_initialize(device=device)
    return
  if num_processes <= 1:
    return
  _dist().init_process_group(
      launch.backend_for(device), init_method=f"tcp://{coordinator_address}",
      world_size=num_processes, rank=process_id)


class Mesh:
  """A named grid of processes: `axis_names`, `shape` ({axis: size}),
  `size`, this process's `rank`, and the groups of its axes (None for an
  axis of size 1, or without a process group)."""

  def __init__(self, sizes: dict, device_mesh=None, rank: int = 0):
    self.axis_names = tuple(sizes)
    self.shape = dict(sizes)
    self.size = int(np.prod(list(sizes.values())))
    self.device_mesh = device_mesh
    self.rank = rank
    self._groups = {}

  def __repr__(self):
    return f"Mesh({self.shape})"

  @property
  def layout_only(self) -> bool:
    """True for a mesh of several processes built without a process group."""
    return self.size > 1 and self.device_mesh is None

  def coords(self, rank: Optional[int] = None) -> dict:
    """{axis: index} of `rank` (default: this process) on the mesh."""
    rank = self.rank if rank is None else rank
    idx = np.unravel_index(rank, tuple(self.shape.values()))
    return {a: int(i) for a, i in zip(self.axis_names, idx)}

  def coord(self, axis: str, rank: Optional[int] = None) -> int:
    return self.coords(rank)[axis] if axis in self.shape else 0

  def axis_size(self, axis: str) -> int:
    return self.shape.get(axis, 1)

  def group(self, *axes):
    """The process group spanning `axes` through this process, or None when
    they hold one process. One axis is the DeviceMesh's own sub-group; the
    batch axes together are a group made with the mesh."""
    axes = tuple(a for a in axes if self.axis_size(a) > 1)
    if not axes:
      return None
    if self.layout_only:
      raise RuntimeError(f"{self} is a layout without a process group")
    if len(axes) == 1:
      return self.device_mesh.get_group(axes[0])
    if axes not in self._groups:
      raise ValueError(f"no group over {axes}: the mesh makes one over the "
                       f"batch axes {batch_axes(self)} and one per axis")
    return self._groups[axes]

  def batch_shard(self, rank: Optional[int] = None) -> tuple:
    """(index, count) of this process's part of the global batch: its
    position on the batch axes, major to minor (the rows JAX's P(("data",
    "fsdp")) gives it). Processes that differ only on `tensor` or `pipe`
    hold the same rows."""
    index, count = 0, 1
    for a in batch_axes(self):
      index = index * self.shape[a] + self.coord(a, rank)
      count *= self.shape[a]
    return index, count

  def batch_group(self):
    """The group over the batch axes (None with one batch shard)."""
    return self.group(*batch_axes(self))


def make_mesh(n: Optional[int] = None, *, data: int = -1, fsdp: int = 1,
              tensor: int = 1, pipe: int = 1,
              device_type: Optional[str] = None) -> Mesh:
  """A mesh over `n` processes (default: the process group's size, else 1).

  `data=-1` absorbs the processes the other axes leave; `fsdp` in (0, -1)
  puts every process (over `tensor * pipe`) on the fsdp axis, with data 1.
  Only axes over 1 and `data` are kept. With a process group of `n` ranks
  the mesh holds a DeviceMesh of `device_type` (default: "cuda" for NCCL,
  else "cpu") and its sub-groups.
  """
  world = process_count()
  n = world if n is None else int(n)
  if fsdp in (0, -1):
    assert n % max(tensor * pipe, 1) == 0
    fsdp, data = n // max(tensor * pipe, 1), 1
  sizes = {"fsdp": fsdp, "tensor": tensor, "pipe": pipe}
  rest = int(np.prod(list(sizes.values())))
  if data == -1:
    assert n % rest == 0, f"{n} processes not divisible by {rest}"
    data = n // rest
  shape = {"data": data, **sizes}
  used = {k: v for k, v in shape.items() if v > 1 or k == "data"}
  assert int(np.prod(list(used.values()))) == n, (
      f"Mesh shape {used} does not cover {n} processes")
  if not is_distributed() or (n == 1 and world == 1):
    return Mesh(used, None, process_index())
  if n != world:
    raise ValueError(f"a mesh of {n} over a process group of {world}")
  import torch
  from torch.distributed.device_mesh import DeviceMesh
  dist = _dist()
  if device_type is None:
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
  grid = torch.arange(n).reshape(tuple(used.values()))
  dm = DeviceMesh(device_type, grid, mesh_dim_names=tuple(used))
  mesh = Mesh(used, dm, dist.get_rank())
  axes = tuple(a for a in batch_axes(mesh) if used[a] > 1)
  if len(axes) > 1:
    # Every rank makes every group of the enumeration, in the same order.
    keep = [i for i, a in enumerate(used) if a not in axes]
    lanes = np.moveaxis(grid.numpy(), keep, list(range(len(keep))))
    lanes = lanes.reshape(-1, int(np.prod([used[a] for a in axes])))
    mine, _ = dist.new_subgroups_by_enumeration(
        [list(map(int, r)) for r in lanes])
    mesh._groups[axes] = mine
  return mesh


def batch_axes(mesh: Mesh) -> tuple:
  """The mesh axes the batch dimension is sharded over."""
  return tuple(a for a in BATCH_AXES if a in mesh.axis_names)


def local_mesh_info(mesh: Mesh) -> tuple:
  """(local devices, global devices, batch shards): one card per process."""
  return 1, mesh.size, mesh.batch_shard()[1]
