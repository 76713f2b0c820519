"""The port's weights bridge, npz loader, sampler callable and server.

Server cases are those of tests/test_serving.py, with numpy fake samplers
in place of jax ones: the port's `SamplerServer` calls `sample_fn(seed)`.
"""

import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import small_config, torch_model

from small_vision_tpu.utils import checkpoint as jckpt
from small_vision_tpu_torch import convert
from small_vision_tpu_torch.configs import parse_config
from small_vision_tpu_torch.tools import export_sampler, serve
from small_vision_tpu_torch.utils import checkpoint as tckpt
from small_vision_tpu_torch.utils.trees import tree_flatten_with_names

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- weights bridge ---------------------------------------------------------


def test_params_round_trip():
  config = small_config(labels=True)
  params = convert.init_params(config, seed=0)
  model = torch_model(config, params)
  back = dict(tree_flatten_with_names(convert.params_to_jax(
      model.state_dict())))
  for name, want in tree_flatten_with_names(params):
    np.testing.assert_array_equal(back[name], want, err_msg=name)


def test_init_params_draws_every_leaf_nonzero():
  flat = dict(tree_flatten_with_names(
      convert.init_params(small_config(), seed=0)))
  for name in ("Encoder/blocks_00/Dense_0/kernel", "final_modulation/kernel",
               "cls", "head_bias"):  # zero-initialised by flax
    assert np.all(flat[name] != 0), name


def test_converter_raises_on_leftover_and_missing_names():
  config = small_config()
  model = torch_model(config, convert.init_params(config, seed=0))
  flat = dict(tree_flatten_with_names(convert.init_params(config, seed=0)))
  extra = dict(flat, **{"Encoder/blocks_00/Dense_9/kernel": np.zeros(1)})
  with pytest.raises(KeyError, match="left over.*Dense_9"):
    convert.params_from_jax(extra, model)
  missing = dict(flat)
  del missing["head/kernel"]
  with pytest.raises(KeyError, match="missing.*head.kernel"):
    convert.params_from_jax(missing, model)
  wrong = dict(flat, **{"head_bias": np.zeros(7, np.float32)})
  with pytest.raises(ValueError, match="head_bias: shape"):
    convert.params_from_jax(wrong, model)


@pytest.mark.parametrize("cast", [None, jnp.bfloat16])
def test_npz_loader_reads_jax_export(tmp_path, cast):
  config = small_config()
  params = convert.init_params(config, seed=1)
  path = str(tmp_path / "weights.npz")
  jckpt.save_params_npz(path, params, cast_floating=cast)
  loaded = dict(tree_flatten_with_names(tckpt.load_params_npz(path)))
  want_dtype = torch.bfloat16 if cast is not None else torch.float32
  for name, want in tree_flatten_with_names(params):
    got = loaded[name]
    assert got.dtype == want_dtype, name
    ref = np.asarray(jnp.asarray(want, cast or jnp.float32), np.float32)
    np.testing.assert_array_equal(got.float().numpy(), ref, err_msg=name)
  # The file loads into the model, whose parameters stay f32 (as the JAX
  # sampler restores its training dtypes from a bf16 file).
  model = torch_model(config, tckpt.load_params_npz(path))
  assert model.head.kernel.dtype == torch.float32
  np.testing.assert_array_equal(model.head.kernel.numpy(),
                                loaded["head/kernel"].float().numpy())


# -- sampler callable --------------------------------------------------------


def _tiny_sample(batch=2, steps=2, params=None):
  config = parse_config("ae_i1k.py:runlocal,size=16")
  config["diff_schedule"]["sampling_timesteps"] = steps
  config["num_samples"] = 2
  params = params or convert.init_params(config, seed=0)
  return export_sampler.build_sample_callable(
      config, params, fn="uncond_eps", batch_size=batch, device="cpu")


def test_sample_callable_is_seeded_uint8():
  sample = _tiny_sample()
  a, b, c = sample(3), sample(3), sample(4)
  assert a.shape == (2, 16, 16, 3) and a.dtype == np.uint8
  np.testing.assert_array_equal(a, b)
  assert not np.array_equal(a, c)


def test_sample_callable_rejects_unknown_fn():
  config = parse_config("ae_i1k.py:runlocal,size=16")
  with pytest.raises(KeyError, match="cfg_eps_2.0"):
    export_sampler.build_sample_callable(
        config, convert.init_params(config, seed=0), fn="cfg_eps_2.0",
        device="cpu")


def test_serve_cli_builds_from_npz(tmp_path):
  config = parse_config("ae_i1k.py:runlocal,size=16")
  path = str(tmp_path / "ema.npz")
  jckpt.save_params_npz(path, convert.init_params(config, seed=0))
  args = serve.argparse.Namespace(
      config="ae_i1k.py:runlocal,size=16", weights=path, fn="uncond_eps",
      batch_size=2, device="cpu")
  sample, batch = serve.build_sample_fn(args)
  assert batch == 2 and callable(sample)  # sample(): the tests above


# -- the server (cases of tests/test_serving.py) ------------------------------


def _fake_sampler(batch=8):
  calls = []

  def sample_fn(seed):
    calls.append(1)
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, (batch, 4, 4, 3)).astype(np.uint8)

  return sample_fn, calls


def _indexed_sampler(batch, block_first=None):
  """Output encodes (call index, row index); the first call may block."""
  calls = []

  def sample_fn(seed):
    del seed
    idx = len(calls)
    calls.append(1)
    if block_first is not None and idx == 0:
      assert block_first.wait(30)
    img = np.zeros((batch, 4, 4, 3), np.uint8)
    img[:, 0, 0, 0] = idx
    img[:, 0, 0, 1] = np.arange(batch)
    return img

  return sample_fn, calls


def _call_rows(images):
  return int(images[0, 0, 0, 0]), list(images[:, 0, 0, 1])


def _stage(srv, calls, ask, requests):
  """Starts requests in order while the worker is busy in call 0."""
  while not calls:
    time.sleep(0.005)
  staged = []
  for args, kw in requests:
    t = threading.Thread(target=ask, args=args, kwargs=kw)
    t.start()
    staged.append(t)
    while srv.queue.qsize() < len(staged):
      time.sleep(0.005)
  return staged


def test_server_coalesces_requests():
  sample_fn, calls = _fake_sampler(batch=8)
  srv = serve.SamplerServer(sample_fn, 8, max_wait_ms=5000.0)
  try:
    results = {}

    def ask(name, n):
      results[name] = srv.sample(n, timeout=60)

    threads = [threading.Thread(target=ask, args=(f"r{i}", n))
               for i, n in enumerate([3, 3, 2])]
    for t in threads:
      t.start()
    for t in threads:
      t.join(60)
    assert sorted(r.shape[0] for r in results.values()) == [2, 3, 3]
    assert sum(calls) == 1
    allrows = np.concatenate(list(results.values()), axis=0)
    assert len({r.tobytes() for r in allrows}) == 8
    assert srv.stats["batches"] == 1 and srv.stats["images"] == 8
  finally:
    srv.close()


def test_server_rejects_oversize_and_propagates_errors():
  def bad_fn(seed):
    raise RuntimeError("boom")

  srv = serve.SamplerServer(bad_fn, 4, max_wait_ms=10.0)
  try:
    with pytest.raises(ValueError):
      srv.sample(5)
    with pytest.raises(RuntimeError, match="boom"):
      srv.sample(2, timeout=30)
  finally:
    srv.close()


def test_server_stats_exact_under_concurrency():
  sample_fn, _ = _fake_sampler(batch=8)
  srv = serve.SamplerServer(sample_fn, 8, max_wait_ms=5.0)
  interval = sys.getswitchinterval()
  sys.setswitchinterval(1e-5)
  try:
    errs = []

    def ask():
      try:
        srv.sample(1, timeout=60)
      except Exception as e:  # noqa: BLE001 -- asserted empty below
        errs.append(e)

    threads = [threading.Thread(target=ask) for _ in range(48)]
    for t in threads:
      t.start()
    for t in threads:
      t.join(60)
    assert not errs and not any(t.is_alive() for t in threads)
    s = srv.stats_snapshot()
    assert (s["requests"], s["images"], s["rejected"]) == (48, 48, 0)
  finally:
    sys.setswitchinterval(interval)
    srv.close()


def test_server_fifo_preserved_on_oversize():
  release = threading.Event()
  sample_fn, calls = _indexed_sampler(batch=4, block_first=release)
  srv = serve.SamplerServer(sample_fn, 4, max_wait_ms=300.0,
                            split_requests=False)
  try:
    results = {}

    def ask(name, n):
      results[name] = srv.sample(n, timeout=60)

    t0 = threading.Thread(target=ask, args=("r0", 4))
    t0.start()
    staged = _stage(srv, calls, ask, [(("r1", 3), {}), (("r2", 2), {}),
                                      (("r3", 1), {})])
    release.set()
    for t in [t0] + staged:
      t.join(60)
    c1, rows1 = _call_rows(results["r1"])
    c2, rows2 = _call_rows(results["r2"])
    c3, rows3 = _call_rows(results["r3"])
    assert rows1 == [0, 1, 2]
    assert c2 == c3 == c1 + 1
    assert rows2 == [0, 1] and rows3 == [2]
  finally:
    srv.close()


@pytest.mark.parametrize("seeded", [False, True])
def test_server_splits_only_unseeded_overflow(seeded):
  release = threading.Event()
  sample_fn, calls = _indexed_sampler(batch=4, block_first=release)
  srv = serve.SamplerServer(sample_fn, 4, max_wait_ms=300.0)
  try:
    results = {}

    def ask(name, n, **kw):
      results[name] = srv.sample(n, **kw, timeout=60)

    t0 = threading.Thread(target=ask, args=("r0", 4))
    t0.start()
    staged = _stage(srv, calls, ask, [
        (("r1", 3), {}), (("r2", 3), {"seed": 7} if seeded else {}),
        (("r3", 2), {})])
    release.set()
    for t in [t0] + staged:
      t.join(60)
    c1, rows1 = _call_rows(results["r1"])
    r2 = results["r2"]
    assert rows1 == [0, 1, 2] and r2.shape[0] == 3
    if seeded:  # parks whole: one sampler call for a seeded request
      assert _call_rows(r2) == (c1 + 1, [0, 1, 2])
    else:  # one image in r1's batch, the rest leads the next one
      assert (int(r2[0, 0, 0, 0]), int(r2[0, 0, 0, 1])) == (c1, 3)
      assert [int(x) for x in r2[1:, 0, 0, 0]] == [c1 + 1, c1 + 1]
      assert _call_rows(results["r3"]) == (c1 + 1, [2, 3])
      assert srv.stats_snapshot()["batch_fill_sum"] == pytest.approx(3.0)
  finally:
    srv.close()


def test_server_backpressure_429():
  release = threading.Event()
  sample_fn, calls = _indexed_sampler(batch=2, block_first=release)
  srv = serve.SamplerServer(sample_fn, 2, max_wait_ms=50.0,
                            max_queue_batches=1)
  try:
    results = {}

    def ask(name, n):
      results[name] = srv.sample(n, timeout=60)

    t0 = threading.Thread(target=ask, args=("r0", 2))
    t0.start()
    staged = _stage(srv, calls, ask, [(("r1", 1), {}), (("r2", 1), {})])
    with pytest.raises(serve.ServerOverloaded) as ei:
      srv.sample(1)
    assert ei.value.retry_after_s >= 1.0
    assert srv.stats_snapshot()["rejected"] == 1
    release.set()
    for t in [t0] + staged:
      t.join(60)
    assert len(results) == 3
  finally:
    srv.close()


def test_server_graceful_drain_on_close():
  sample_fn, _ = _fake_sampler(batch=8)
  srv = serve.SamplerServer(sample_fn, 8, max_wait_ms=5.0)
  results, started = {}, []

  def ask(name):
    started.append(name)
    results[name] = srv.sample(2, timeout=60)

  threads = [threading.Thread(target=ask, args=(f"r{i}",)) for i in range(3)]
  for t in threads:
    t.start()
  while len(started) < 3:
    time.sleep(0.005)
  time.sleep(0.05)
  srv.close(drain=True)
  for t in threads:
    t.join(60)
  assert len(results) == 3
  with pytest.raises(serve.ServerClosing):
    srv.sample(1)


def test_http_endpoints():
  sample_fn, _ = _fake_sampler(batch=8)
  srv = serve.SamplerServer(sample_fn, 8, max_wait_ms=10.0)
  httpd = serve.make_http_server(srv, 0, host="127.0.0.1")
  port = httpd.server_address[1]
  t = threading.Thread(target=httpd.serve_forever, daemon=True)
  t.start()
  try:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                timeout=30) as r:
      assert json.load(r)["ok"] is True
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/sample",
        data=json.dumps({"n": 3, "seed": 5}).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
      images = np.load(io.BytesIO(r.read()))["images"]
    assert images.shape == (3, 4, 4, 3) and images.dtype == np.uint8
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                timeout=30) as r:
      stats = json.load(r)
    assert stats["requests"] == 1 and stats["images"] == 3
  finally:
    httpd.shutdown()
    httpd.server_close()
    srv.close()


# -- the port stands alone ----------------------------------------------------


def test_port_imports_no_jax():
  """Every module of the port, and chip_smoke, import without JAX."""
  code = """
import importlib, pkgutil, sys
import small_vision_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
  importlib.import_module(m.name)
import chip_smoke
banned = ("jax", "jaxlib", "flax", "optax", "orbax", "ml_collections",
          "ml_dtypes", "small_vision_tpu", "triton")
bad = sorted(m for m in sys.modules if m.split(".")[0] in banned)
for m in ("tools.ablate_attention_kernel", "evaluators.common",
          "evaluators.diffusion_loss", "evaluators.mae_reconstruction",
          "evaluators.diffusion_sampling", "evaluators.mean",
          "evaluators.save", "utils.chrono", "utils.metrics", "utils.misc",
          "utils.losses", "utils.checkpoint", "data.core", "data.pipeline"):
  assert pkg.__name__ + "." + m in sys.modules, m
print(len([m for m in sys.modules if m.startswith(pkg.__name__)]))
assert not bad, bad
"""
  out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
  assert out.returncode == 0, out.stderr
  assert int(out.stdout.strip()) >= 34  # every module was imported
