"""The active mesh, for the model code that needs it (the pipeline).

Counterpart of small_vision_tpu/parallel/ctx.py: `activate_mesh(mesh)`
makes `mesh` the one `current_mesh()` returns, for the duration of a block
(a step, an evaluation); the Encoder under `pipe_stages` reads its `pipe`
axis there, and every Encoder its `tensor` group (`tensor_group`).
"""

import contextlib
import threading

_state = threading.local()


def current_mesh():
  return getattr(_state, "mesh", None)


@contextlib.contextmanager
def activate_mesh(mesh):
  """Makes `mesh` the current mesh of this thread for the duration."""
  prev = current_mesh()
  _state.mesh = mesh
  try:
    yield mesh
  finally:
    _state.mesh = prev


def tensor_group():
  """The process group of the current mesh's `tensor` axis, which the
  Megatron block (`models.vit`) sums its partial products over; None
  without a mesh or a `tensor` axis of more than one process."""
  mesh = current_mesh()
  if mesh is None or mesh.axis_size("tensor") == 1:
    return None
  return mesh.group("tensor")


def constrain(x, *names):
  """JAX's activation sharding constraint by logical dim names, which this
  port keeps as an identity: a constraint tells GSPMD how to lay out a
  value it partitions itself, and here every process holds its own rows
  and the collectives are written out (`parallel.collectives`), so there is
  no layout left to choose. The check of the name count stays."""
  if current_mesh() is not None:
    assert len(names) == x.ndim, f"{names} vs shape {tuple(x.shape)}"
  return x
