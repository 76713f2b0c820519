"""Port parity: `tools/export_sampler.py`'s weights and artifact, and
`tools/serve.py --workdir / --no_ema / --artifact`, against the JAX
package's contract (tests/test_serving.py).

  - `load_params` on port checkpoints: `ema_params` first, `params` with
    `use_ema=False` and where the run kept no EMA, a `scan=True` run's
    stacks unrolled to the flax names (what `build_sample_callable` and
    `save_params_npz` take), FileNotFoundError without a checkpoint. (A
    checkpoint written by a multi-process fully_sharded run:
    tests/test_torch_parallel_multiproc.py.)
  - `main --weights_out` writes the flat .npz that the server reads.
  - The artifact, a `torch.export` round trip on the CPU at runlocal size,
    3 DDIM steps, batch 4: `baked` (`uncond_eps`), `arg` with an f32
    sidecar (`cfg_eps_2.0` with 3 classes, so that the loader draws
    labels and the graph doubles the batch) and `arg` with a bfloat16
    sidecar, each bit-equal to the live callable at the same seed (the
    bf16 one to the live callable on the bf16-rounded weights: the program
    casts each leaf back to f32 as its first operation, so storage
    rounding is the only difference). The arg artifact holds no weight;
    the bf16 sidecar is about half the f32 one. The errors JAX raises: an
    arg artifact without weights, a baked one with them.
  - The graph calls the kernels' operators (`svt::ln_modulate_fwd`,
    `svt::attention_packed_fwd`; `svt::fused_*` under `pallas_fused`) and
    under `attn_impl=xla` no attention operator (the port's LayerNorm is
    K1 under every `attn_impl`, so `svt::ln_modulate_fwd` stays).
  - `serve.build_sample_fn` from `--workdir` (EMA, and `--no_ema`) and
    from `--artifact`, against the callables above.
"""

import argparse
import os

import numpy as np
import pytest
import torch

from small_vision_tpu_torch import convert
from small_vision_tpu_torch.configs import parse_config
from small_vision_tpu_torch.tools import export_sampler, serve
from small_vision_tpu_torch.utils import checkpoint as ckpt_lib
from small_vision_tpu_torch.utils.trees import tree_flatten_with_names

BATCH = 4


def _config(extra="", steps=3):
  config = parse_config(f"ae_i1k.py:runlocal,size=16,data=synthetic{extra}")
  config["diff_schedule"]["sampling_timesteps"] = steps
  return config


def _labelled():
  config = _config(",use_labels=True")
  config["num_classes"] = config["model"]["num_classes"] = 3
  return config


def _flat(tree):
  """{flax name: numpy array} of a tree of arrays or CPU tensors."""
  return {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
          for k, v in tree_flatten_with_names(tree)}


def _save(workdir, step, **entries):
  mngr = ckpt_lib.make_manager(workdir)
  mngr.save(entries, step)
  mngr.wait_until_finished()


def test_load_params_prefers_ema_and_unrolls_scan(tmp_path):
  config = _config()
  params = convert.init_params(config, 0)
  ema = {k: v + 1.0 for k, v in _flat(params).items()}
  with pytest.raises(FileNotFoundError):
    export_sampler.load_params(config, str(tmp_path / "none"))
  _save(str(tmp_path / "a"), 7, params=params, ema_params=ema)
  got, step, key = export_sampler.load_params(config, str(tmp_path / "a"))
  assert (step, key) == (7, "ema_params")
  assert _flat(got).keys() == ema.keys()
  for k, v in _flat(got).items():
    np.testing.assert_array_equal(v, ema[k])
  got, _, key = export_sampler.load_params(config, str(tmp_path / "a"),
                                           use_ema=False)
  assert key == "params"
  for k, v in _flat(got).items():
    np.testing.assert_array_equal(v, _flat(params)[k])
  # A run without EMA; and a scan=True run, whose stacks come back
  # unrolled.
  _save(str(tmp_path / "b"), 3, params=params)
  assert export_sampler.load_params(config, str(tmp_path / "b"))[2] == \
      "params"
  scan = _config(",scan=True")
  stacked = convert.stack_blocks(_flat(params))
  assert any("/blocks/" in k for k in stacked)
  _save(str(tmp_path / "c"), 5, params=stacked, ema_params=stacked)
  got, step, key = export_sampler.load_params(scan, str(tmp_path / "c"))
  assert (step, key) == (5, "ema_params")
  want = _flat(params)
  assert sorted(_flat(got)) == sorted(want)
  for k, v in _flat(got).items():
    np.testing.assert_array_equal(v, want[k])


def test_main_writes_the_servers_npz(tmp_path):
  config = _config()
  params = convert.init_params(config, 1)
  _save(str(tmp_path), 2, params=params)
  out = str(tmp_path / "w.npz")
  export_sampler.main(["--config", "ae_i1k.py:runlocal,size=16",
                       "--workdir", str(tmp_path), "--weights_out", out])
  got = _flat(ckpt_lib.load_params_npz(out))
  for k, v in _flat(params).items():
    np.testing.assert_array_equal(got[k], v)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
  tmp = tmp_path_factory.mktemp("export")
  config, labelled = _config(), _labelled()
  params = convert.init_params(config, 2)
  lparams = convert.init_params(labelled, 3)
  paths = {k: str(tmp / f"{k}.pt2") for k in ("baked", "arg", "bf16")}
  w32, w16 = str(tmp / "w32.npz"), str(tmp / "w16.npz")
  programs = {
      "baked": export_sampler.export_sampler(
          config, params, paths["baked"], batch_size=BATCH, device="cpu"),
      "arg": export_sampler.export_sampler(
          labelled, lparams, paths["arg"], fn="cfg_eps_2.0",
          batch_size=BATCH, weights_mode="arg", weights_out=w32,
          device="cpu"),
      "bf16": export_sampler.export_sampler(
          config, params, paths["bf16"], batch_size=BATCH,
          weights_mode="arg", weights_out=w16, weights_dtype="bfloat16",
          device="cpu")}
  return dict(config=config, labelled=labelled, params=params,
              lparams=lparams, paths=paths, w32=w32, w16=w16,
              programs=programs, tmp=tmp)


def _live(config, params, fn="uncond_eps"):
  return export_sampler.build_sample_callable(
      config, params, fn=fn, batch_size=BATCH, device="cpu")


def test_baked_artifact_is_bit_equal_to_the_live_sampler(artifacts):
  a = artifacts
  sample = export_sampler.load_exported(a["paths"]["baked"])
  assert sample.meta["batch_size"] == BATCH
  got = sample(5)
  assert got.shape == (BATCH, 16, 16, 3) and got.dtype == np.uint8
  np.testing.assert_array_equal(got, _live(a["config"], a["params"])(5))
  assert not np.array_equal(got, sample(6))
  with pytest.raises(ValueError, match="baked-weights"):
    export_sampler.load_exported(a["paths"]["baked"], weights=a["w32"])


def test_arg_artifact_with_labels_and_cfg(artifacts):
  a = artifacts
  with pytest.raises(ValueError, match="weights_mode='arg'"):
    export_sampler.load_exported(a["paths"]["arg"])
  # The program only: its parameters are empty, the baked one's whole.
  assert not any(t.numel() for t in a["programs"]["arg"].state_dict.values())
  assert all(t.numel() for t in a["programs"]["baked"].state_dict.values())
  live = _live(a["labelled"], a["lparams"], "cfg_eps_2.0")
  for weights in (a["w32"], a["lparams"]):
    sample = export_sampler.load_exported(a["paths"]["arg"],
                                          weights=weights)
    np.testing.assert_array_equal(sample(9), live(9))


def test_bf16_sidecar(artifacts):
  a = artifacts
  # The program alone: smaller than the baked artifact of the same model.
  assert os.path.getsize(a["paths"]["bf16"]) < os.path.getsize(
      a["paths"]["baked"])
  w32 = str(a["tmp"] / "same_f32.npz")
  ckpt_lib.save_params_npz(w32, a["params"])
  assert os.path.getsize(a["w16"]) < 0.6 * os.path.getsize(w32)
  tree16 = ckpt_lib.load_params_npz(a["w16"])
  assert {v.dtype for _, v in tree_flatten_with_names(tree16)
          if v.is_floating_point()} == {torch.bfloat16}
  sample = export_sampler.load_exported(a["paths"]["bf16"], weights=a["w16"])
  rounded = {k: v.float() if v.is_floating_point() else v
             for k, v in tree_flatten_with_names(tree16)}
  np.testing.assert_array_equal(sample(2), _live(a["config"], rounded)(2))


def _ops(program):
  return {str(n.target) for n in program.graph.nodes
          if str(n.target).startswith("svt.")}


def test_graph_calls_the_kernels_operators(artifacts):
  a = artifacts
  assert _ops(a["programs"]["baked"]) == {
      "svt.ln_modulate_fwd.default", "svt.attention_packed_fwd.default"}
  config = _config(",attn_impl=xla", steps=1)
  assert _ops(export_sampler.export_sampler(
      config, a["params"], None, batch_size=2, device="cpu")) == {
          "svt.ln_modulate_fwd.default"}
  fused = _config(",attn_impl=pallas_fused", steps=1)
  assert _ops(export_sampler.export_sampler(
      fused, a["params"], None, batch_size=2, device="cpu")) == {
          "svt.ln_modulate_fwd.default", "svt.fused_mha_fwd.default",
          "svt.fused_mlp_fwd.default"}


def test_serve_builds_from_workdir_and_artifact(artifacts):
  a = artifacts
  workdir = str(a["tmp"] / "run")
  ema = {k: v * 0.5 for k, v in _flat(a["params"]).items()}
  _save(workdir, 4, params=a["params"], ema_params=ema)
  spec = ("eval_ae_i1k.py:runlocal=True,size=16,use_labels=False,"
          "sampling_timesteps=3")
  base = dict(config=spec, fn="uncond_eps",
              batch_size=BATCH, device="cpu", weights="", artifact="",
              workdir=workdir, no_ema=False)
  for no_ema, want in ((False, ema), (True, a["params"])):
    sample, batch = serve.build_sample_fn(argparse.Namespace(
        **dict(base, no_ema=no_ema)))
    assert batch == BATCH
    np.testing.assert_array_equal(sample(1), export_sampler.
                                  build_sample_callable(
                                      parse_config(base["config"]), want,
                                      batch_size=BATCH, device="cpu")(1))
  sample, batch = serve.build_sample_fn(argparse.Namespace(
      **dict(base, workdir="", artifact=a["paths"]["bf16"],
             weights=a["w16"])))
  assert batch == BATCH
  np.testing.assert_array_equal(
      sample(3), export_sampler.load_exported(a["paths"]["bf16"],
                                              weights=a["w16"])(3))
  with pytest.raises(ValueError, match="--workdir"):
    serve.build_sample_fn(argparse.Namespace(
        **dict(base, weights="x.npz")))
