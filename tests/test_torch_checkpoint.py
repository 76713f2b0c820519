"""The port's checkpoints: the flat-npz format both ways against the JAX
package's `save_params_npz` / `load_params_npz` (bf16 bit-exact), the
manager's atomicity, `keep_period` and rolling, the asynchronous save, and
`convert.train_state_from_jax` with its reverse."""

import os
import threading

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from small_vision_tpu.utils import checkpoint as jckpt
from small_vision_tpu_torch import convert
from small_vision_tpu_torch.utils import checkpoint as ckpt


def _tree(seed):
  rng = np.random.default_rng(seed)
  f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
  return {"Encoder": {"blocks_00": {"kernel": f32(4, 6), "bias": f32(6)}},
          "cls": f32(1, 2, 4), "head_bias": f32(3)}


def _torch_tree(tree, bf16=()):
  out = {}
  for k, v in tree.items():
    if isinstance(v, dict):
      out[k] = _torch_tree(v, bf16)
    else:
      t = torch.from_numpy(v.copy())
      out[k] = t.to(torch.bfloat16) if k in bf16 else t
  return out


def _bits(t):
  """The uint16 bit pattern of a bf16 tensor or ml_dtypes array."""
  if isinstance(t, torch.Tensor):
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)
  return np.asarray(t).view(np.uint16)


def test_npz_round_trip_is_bit_exact_with_bf16(tmp_path):
  tree = _torch_tree(_tree(0), bf16=("kernel", "cls"))
  path = str(tmp_path / "w.npz")
  ckpt.save_params_npz(path, tree)
  with np.load(path) as data:
    assert "Encoder/blocks_00/kernel::bf16" in data
    assert data["Encoder/blocks_00/kernel::bf16"].dtype == np.uint16
    assert data["Encoder/blocks_00/bias"].dtype == np.float32
  back = ckpt.load_params_npz(path)
  kernel = back["Encoder"]["blocks_00"]["kernel"]
  assert kernel.dtype == torch.bfloat16
  np.testing.assert_array_equal(
      _bits(kernel), _bits(tree["Encoder"]["blocks_00"]["kernel"]))
  assert torch.equal(back["head_bias"], tree["head_bias"])


def test_npz_written_by_the_port_is_read_by_jax(tmp_path):
  tree = _torch_tree(_tree(1), bf16=("kernel",))
  path = str(tmp_path / "w.npz")
  ckpt.save_params_npz(path, tree)
  back = jckpt.load_params_npz(path)
  kernel = back["Encoder"]["blocks_00"]["kernel"]
  assert kernel.dtype == ml_dtypes.bfloat16
  np.testing.assert_array_equal(
      _bits(kernel), _bits(tree["Encoder"]["blocks_00"]["kernel"]))
  np.testing.assert_array_equal(back["cls"], tree["cls"].numpy())


def test_npz_written_by_jax_is_read_by_the_port(tmp_path):
  tree = _tree(2)
  path = str(tmp_path / "w.npz")
  jckpt.save_params_npz(path, tree, cast_floating=jnp.bfloat16)
  back = ckpt.load_params_npz(path)
  for name, leaf in (("cls", back["cls"]),
                     ("kernel", back["Encoder"]["blocks_00"]["kernel"])):
    assert leaf.dtype == torch.bfloat16, name
  np.testing.assert_array_equal(
      _bits(back["cls"]), _bits(tree["cls"].astype(ml_dtypes.bfloat16)))
  # And the same cast on the port's side writes the same bits.
  path2 = str(tmp_path / "w2.npz")
  ckpt.save_params_npz(path2, _torch_tree(tree), cast_floating="bfloat16")
  with np.load(path) as a, np.load(path2) as b:
    assert sorted(a) == sorted(b)
    for k in a:
      np.testing.assert_array_equal(a[k], b[k])


def _state(seed):
  tree = _torch_tree(_tree(seed))
  flat = {"Encoder/blocks_00/kernel": tree["Encoder"]["blocks_00"]["kernel"],
          "cls": tree["cls"]}
  return {
      "params": flat,
      "opt": {"count": np.int64(seed),
              **{f"mu/{n}": t.to(torch.bfloat16) for n, t in flat.items()},
              **{f"nu/{n}": t * t for n, t in flat.items()}},
      "generator": {"state": torch.Generator().manual_seed(seed).get_state()},
      "chrono": {"accum_train_time": np.asarray([1.5 * seed])},
  }


def test_manager_save_restore_round_trip(tmp_path):
  mngr = ckpt.make_manager(str(tmp_path))
  assert ckpt.restore(mngr) is None and ckpt.latest_step(mngr) is None
  state = _state(3)
  ckpt.save(mngr, state, 3)
  ckpt.wait_until_finished(mngr)
  assert ckpt.latest_step(mngr) == 3
  assert sorted(os.listdir(tmp_path / "checkpoints" / "3")) == [
      "chrono.npz", "generator.npz", "opt.npz", "params.npz"]
  back = ckpt.restore(mngr)
  assert int(back["opt"]["count"]) == 3
  mu = back["opt"]["mu"]["Encoder"]["blocks_00"]["kernel"]
  assert mu.dtype == torch.bfloat16
  assert torch.equal(mu, state["opt"]["mu/Encoder/blocks_00/kernel"])
  assert torch.equal(back["params"]["cls"], state["params"]["cls"])
  assert torch.equal(back["generator"]["state"],
                     state["generator"]["state"])
  gen = torch.Generator()
  gen.set_state(back["generator"]["state"])
  assert torch.equal(torch.rand(4, generator=gen),
                     torch.rand(4, generator=torch.Generator().manual_seed(3)))
  assert float(back["chrono"]["accum_train_time"][0]) == 4.5
  only = ckpt.restore_subtree(mngr, "params")
  assert sorted(only) == ["Encoder", "cls"]
  with pytest.raises(KeyError, match="no entry"):
    ckpt.restore_subtree(mngr, "ema_params")


def test_an_unrenamed_directory_is_ignored_and_removed(tmp_path):
  mngr = ckpt.make_manager(str(tmp_path))
  ckpt.save(mngr, _state(1), 1)
  ckpt.wait_until_finished(mngr)
  # A save of step 2 that died half-way: never renamed.
  half = tmp_path / "checkpoints" / "2.tmp"
  half.mkdir()
  (half / "params.npz").write_bytes(b"half-written")
  assert ckpt.latest_step(mngr) == 1      # ignored by a running manager
  fresh = ckpt.make_manager(str(tmp_path))
  assert not half.exists()                # removed at the next start
  assert ckpt.latest_step(fresh) == 1
  assert int(ckpt.restore(fresh)["opt"]["count"]) == 1


def test_keep_period_stays_and_the_rest_rolls(tmp_path):
  mngr = ckpt.make_manager(str(tmp_path), keep_period=4)
  for step in (2, 4, 6, 8, 9, 10):
    ckpt.save(mngr, _state(step), step)
  ckpt.wait_until_finished(mngr)
  assert mngr.all_steps() == [4, 8, 10]
  assert int(ckpt.restore(mngr, step=4)["opt"]["count"]) == 4
  rolling = ckpt.make_manager(str(tmp_path / "b"), max_to_keep=2)
  for step in (1, 2, 3):
    ckpt.save(rolling, _state(step), step)
  ckpt.wait_until_finished(rolling)
  assert rolling.all_steps() == [2, 3]


@pytest.mark.parametrize("keep_period,max_to_keep,saves", [
    (4, 1, (3, 4)),
    (4, 2, (1, 2, 3, 4, 5)),
    (4, 1, (2, 4, 6, 8, 9, 10)),
    (None, 2, (1, 2, 3)),
])
def test_retention_matches_the_jax_manager(tmp_path, keep_period, max_to_keep,
                                           saves):
  """Orbax keeps the newest `max_to_keep` steps and, of the older ones, the
  multiples of `keep_period`: the port keeps the same steps."""
  port = ckpt.make_manager(str(tmp_path / "port"), keep_period=keep_period,
                           max_to_keep=max_to_keep)
  ref = jckpt.make_manager(str(tmp_path / "jax"), keep_period=keep_period,
                           max_to_keep=max_to_keep)
  for step in saves:
    ckpt.save(port, _state(step), step)
    jckpt.save(ref, {"count": np.asarray(step, np.int32)}, step)
    ref.wait_until_finished()
  ckpt.wait_until_finished(port)
  want = sorted(ref.all_steps())
  ref.close()
  assert port.all_steps() == want


def test_save_copies_before_it_returns_and_writes_in_a_thread(tmp_path,
                                                              monkeypatch):
  """What is saved is the state at the call: the loop may change its
  tensors in place right after. The write itself runs in another thread."""
  mngr = ckpt.make_manager(str(tmp_path))
  state = _state(5)
  want = state["params"]["cls"].clone()
  writers = []
  real_savez = np.savez

  def savez(*args, **kw):
    writers.append(threading.current_thread().name)
    return real_savez(*args, **kw)

  monkeypatch.setattr(np, "savez", savez)
  ckpt.save(mngr, state, 5)
  state["params"]["cls"].add_(1.0)        # the next training step
  ckpt.wait_until_finished(mngr)
  assert writers and set(writers) == {ckpt.WRITER_THREAD}
  assert torch.equal(ckpt.restore(mngr)["params"]["cls"], want)
  assert mngr.last_blocking_s >= 0 and mngr.last_write_s > 0


def test_a_failed_write_is_raised_by_the_next_wait(tmp_path, monkeypatch):
  mngr = ckpt.make_manager(str(tmp_path))

  def savez(*args, **kw):
    raise OSError("disk full")

  monkeypatch.setattr(np, "savez", savez)
  ckpt.save(mngr, _state(1), 1)
  with pytest.raises(RuntimeError, match="writing a checkpoint failed"):
    ckpt.wait_until_finished(mngr)
  assert ckpt.latest_step(mngr) is None   # nothing was renamed into place


NAMES = ["Encoder/blocks_00/bias", "Encoder/blocks_00/kernel", "cls",
         "head_bias"]


def test_train_state_from_jax_and_back():
  params, ema, nu = _tree(10), _tree(11), _tree(12)
  mu = {k: (v if isinstance(v, dict) else v.astype(ml_dtypes.bfloat16))
        for k, v in _tree(13).items()}
  mu["Encoder"] = {"blocks_00": {
      k: v.astype(ml_dtypes.bfloat16)
      for k, v in mu["Encoder"]["blocks_00"].items()}}
  nu = {k: (v if isinstance(v, dict) else np.square(v)) for k, v in nu.items()}
  jax_state = {"params": params, "ema_params": ema,
               "opt": {"count": np.asarray(7, np.int32), "mu": mu, "nu": nu},
               "rng": np.zeros(2, np.uint32)}  # ignored: not carried over
  got = convert.train_state_from_jax(jax_state, NAMES)
  assert got["opt"]["count"] == 7
  assert [t.dtype for t in got["opt"]["mu"]] == [torch.bfloat16] * 4
  assert torch.equal(got["params"][1],
                     torch.from_numpy(params["Encoder"]["blocks_00"]["kernel"]))
  assert torch.equal(got["ema_params"][2], torch.from_numpy(ema["cls"]))
  np.testing.assert_array_equal(_bits(got["opt"]["mu"][2]), _bits(mu["cls"]))

  back = convert.train_state_to_jax(got, NAMES)
  np.testing.assert_array_equal(back["params"]["head_bias"],
                                params["head_bias"])
  np.testing.assert_array_equal(back["ema_params"]["cls"], ema["cls"])
  np.testing.assert_array_equal(back["opt"]["nu"]["cls"], nu["cls"])
  # mu comes back as f32 holding the bf16 values exactly.
  assert back["opt"]["mu"]["cls"].dtype == np.float32
  np.testing.assert_array_equal(
      back["opt"]["mu"]["cls"].astype(ml_dtypes.bfloat16).view(np.uint16),
      _bits(mu["cls"]))
  assert int(back["opt"]["count"]) == 7

  with pytest.raises(KeyError, match="names differ"):
    convert.train_state_from_jax(jax_state, NAMES[:-1])
