"""Multi-process launch: one process per card, under `srun` or `mpirun`.

Counterpart of small_vision_tpu/launch.py. The rank, the world size and the
local rank come from the launcher's environment (OpenMPI, SLURM or PMI; no
MPI Python bindings needed), the coordinator from `SV_COORDINATOR_ADDRESS`
(host or host:port) or the first host of the SLURM nodelist, and
`mpi_initialize` joins `torch.distributed.init_process_group` at
`tcp://<coordinator>` with that world size and rank: NCCL on the cards
(`LOCAL_RANK` picks `cuda:<local rank>`), gloo with `--device cpu`.

  srun python -m small_vision_tpu_torch.launch \\
      --config ae_i1k.py:fsdp=True --workdir /runs/umd
  SV_COORDINATOR_ADDRESS=node001 mpirun -np 8 \\
      python -m small_vision_tpu_torch.launch --config ae_i1k.py:fsdp=True

The remaining arguments are the CLI's (`cli.py`).
"""

import os
import re
import sys

DEFAULT_PORT = 29500


def env_rank_size():
  """(rank, size, local_rank) from the launcher's variables, or None.

  Checked in order: OpenMPI (OMPI_COMM_WORLD_*), SLURM (SLURM_PROCID,
  SLURM_NTASKS, SLURM_LOCALID), PMI (PMI_RANK, PMI_SIZE, MPI_LOCALRANKID).
  """
  schemes = [
      ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE",
       "OMPI_COMM_WORLD_LOCAL_RANK"),
      ("SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID"),
      ("PMI_RANK", "PMI_SIZE", "MPI_LOCALRANKID"),
  ]
  for rank_k, size_k, local_k in schemes:
    if rank_k in os.environ and size_k in os.environ:
      return (int(os.environ[rank_k]), int(os.environ[size_k]),
              int(os.environ.get(local_k, 0)))
  return None


def first_host(nodelist: str) -> str:
  """The first hostname of a SLURM nodelist ("a1,b2", "node[003-008,011]")."""
  m = re.match(r"([^\[]+)\[(\d+)", nodelist)
  if m:
    return f"{m.group(1)}{m.group(2)}"
  return nodelist.split(",")[0]


def coordinator_address(port: int) -> str:
  """The coordinator's "host:port": SV_COORDINATOR_ADDRESS (host or
  host:port), else the first host of SLURM_STEP_NODELIST, SLURM_NODELIST or
  SLURM_JOB_NODELIST."""
  explicit = os.environ.get("SV_COORDINATOR_ADDRESS")
  if explicit:
    return explicit if ":" in explicit else f"{explicit}:{port}"
  for key in ("SLURM_STEP_NODELIST", "SLURM_NODELIST", "SLURM_JOB_NODELIST"):
    nodes = os.environ.get(key)
    if nodes:
      return f"{first_host(nodes)}:{port}"
  raise RuntimeError(
      "cannot determine the coordinator: set SV_COORDINATOR_ADDRESS=host[:port]"
      " (rank 0's hostname), or run under SLURM (a nodelist in the "
      "environment)")


def backend_for(device: str) -> str:
  """NCCL for the cards, gloo for the CPU."""
  import torch
  return "nccl" if torch.device(device).type == "cuda" else "gloo"


def mpi_initialize(coordinator_port: int = DEFAULT_PORT, device="cuda"):
  """Joins the process group the launcher's environment describes; returns
  (rank, size). On the cards the process takes `cuda:<local rank>`."""
  env = env_rank_size()
  if env is None:
    raise RuntimeError(
        "no launcher environment (OMPI_COMM_WORLD_RANK, SLURM_PROCID or "
        "PMI_RANK): start one process per card with srun or mpirun")
  rank, size, local = env
  import torch
  import torch.distributed as dist
  os.environ.setdefault("LOCAL_RANK", str(local))
  if torch.device(device).type == "cuda":
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
  dist.init_process_group(
      backend_for(device),
      init_method=f"tcp://{coordinator_address(coordinator_port)}",
      world_size=size, rank=rank)
  return rank, size


def main(argv=None):
  argv = list(sys.argv[1:] if argv is None else argv)
  device = "cuda"
  for i, a in enumerate(argv):
    if a == "--device" and i + 1 < len(argv):
      device = argv[i + 1]
    elif a.startswith("--device="):
      device = a.split("=", 1)[1]
  mpi_initialize(device=device)
  from small_vision_tpu_torch import cli
  cli.main(argv)


if __name__ == "__main__":
  main()
