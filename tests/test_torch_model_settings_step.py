"""Port parity: the training step under the model settings, and a
`scan=True` run stopped and resumed.

The step is held against the JAX package's real `make_update_fn` over 3
f32 steps with the harness and bounds of tests/test_torch_train_step.py
(every element of the parameters within 5 % of lr, 99 % within 1 %):
  - under `scan=True` (the stacked layout) and the config's remat policy
    "nothing_saveable", against JAX's `scan=True` step under
    `pallas_interpret`: the parameters are carried from JAX in the stacked
    layout, and `convert.init_params` draws them so;
  - with dropout 0.1 under "pallas" and "pallas_fused": the JAX step's
    Bernoulli keep masks are captured in the test process (the harness
    wraps `jax.random.bernoulli`, which flax's Dropout calls, with an
    ordered `jax.debug.callback`) and handed to the port's step as its
    `dropout` draws, in the order the forward takes them. With dropout
    the fused MLP steps aside on both sides.
Then a `scan=True` run of the CPU trainer stopped after a checkpoint and
resumed computes the straight run's parameters and optimizer state, bit
for bit, under the stacked names; and the linear probe loads that run's
backbone into a stacked and into an unrolled model.
"""

import numpy as np
import pytest
import torch
from test_torch_train_loop import _stop_at, _Stopped, _with_substrate
from test_torch_train_step import (captured, check_three_steps_f32,  # noqa: F401
                                   port_draws, small_config)

from small_vision_tpu_torch import convert
from small_vision_tpu_torch.configs import ae_i1k_lp
from small_vision_tpu_torch.train import linear_ae, train_ae
from small_vision_tpu_torch.utils import checkpoint as ckpt_lib


def test_scan_three_steps_match_jax_f32(captured):
  config = small_config(scan=True)
  assert config["model"]["remat_policy"] == "nothing_saveable"
  params = convert.init_params(config, seed=3)
  assert params["Encoder"]["blocks"]["LayerNorm_0"]["scale"].shape == (2,
                                                                        128)
  check_three_steps_f32(captured, False, False, config=config)


def _dropout_draws(config, cap, base, n_no_noise):
  """The port's draws, with the JAX step's dropout keep masks (every
  captured Bernoulli draw but the (B,) label drops) in the order drawn."""
  masks = [d for d in cap.drops if d.ndim > 1]
  labels = [d for d in cap.drops if d.ndim == 1]
  cap.drops = labels
  try:
    draws = port_draws(config, cap, base, n_no_noise)
  finally:
    cap.drops = labels + masks
  draws["dropout"] = masks
  return draws


@pytest.mark.parametrize("attn_impl", ["pallas", "pallas_fused"])
def test_dropout_three_steps_match_jax_f32(captured, attn_impl):
  config = small_config(attn_impl=attn_impl)
  config["model"]["dropout"] = 0.1
  check_three_steps_f32(captured, False, False, config=config,
                        port_draws=_dropout_draws)
  masks = [d for d in captured.drops if d.ndim > 1]
  # Two branches of depth 2 + 1, three masks a block, each step.
  assert len(masks) == 2 * 3 * 3
  assert 0.05 < 1.0 - np.mean(np.concatenate([m.ravel() for m in masks])
                              ) < 0.15


def test_dropout_step_takes_its_masks_from_the_generator():
  """Without injected draws the step draws the keep masks from the train
  state's generator: two runs from one seed agree, and the loss differs
  from the dropout-free model's."""
  losses = []
  for rate in (0.1, 0.1, 0.0):
    config = small_config()
    config["model"]["dropout"] = rate
    model = train_ae.build_model(config, device="cpu", trainable=True)
    model.load_state_dict(convert.params_from_jax(
        convert.init_params(config, seed=3), model))
    names = [n for n, _ in train_ae.named_params(model)]
    opt = train_ae.make_optimizer(config, names, 10, 1)
    state = train_ae.init_train_state(model, opt, config, device="cpu")
    update = train_ae.make_update_fn(model, opt, config, None)
    image = np.random.default_rng(0).standard_normal((8, 16, 16, 3))
    losses.append(float(update(state, {"image": image.astype(np.float32)})[
        "training_loss"]))
  assert losses[0] == losses[1] != losses[2]


def test_scan_run_resumes_bit_equal_and_the_probe_loads_it(tmp_path):
  def config():
    c = _with_substrate()
    c["model"]["scan"] = True
    c["evals"] = {}
    return c
  dir_a, dir_b = str(tmp_path / "a"), str(tmp_path / "b")
  state_a, _ = train_ae.train_and_evaluate(config(), dir_a, device="cpu",
                                           log=lambda s: None)
  with pytest.raises(_Stopped):
    train_ae.train_and_evaluate(config(), dir_b, device="cpu",
                                log=_stop_at(5))
  state_b, hist_b = train_ae.train_and_evaluate(config(), dir_b,
                                                device="cpu",
                                                log=lambda s: None)
  assert [h["step"] for h in hist_b] == [5, 6, 7, 8]
  for a, b in zip(state_a["params"], state_b["params"]):
    assert torch.equal(a, b)
  for key in ("mu", "nu"):
    for a, b in zip(state_a["opt"][key], state_b["opt"][key]):
      assert torch.equal(a, b)

  # The checkpoint holds the stacked names.
  saved = ckpt_lib.restore_subtree(ckpt_lib.make_manager(dir_a), "params")
  flat = dict(convert._flat(saved))
  assert "Encoder/blocks/MultiHeadAttention_0/query/kernel" in flat
  assert not any("blocks_00" in n for n in flat)

  # The probe's backbone (the probe config's model replaced by the run's)
  # loads it stacked, and unrolled.
  for scan in (True, False):
    lp = ae_i1k_lp.get_config("runlocal,size=16,data=synthetic")
    lp["model"] = dict(config()["model"], scan=scan)
    model = linear_ae.load_frozen_backbone(lp, dir_a, device="cpu")
    got = convert.params_to_jax(model.state_dict(), stacked=True)
    for name, want in flat.items():
      np.testing.assert_array_equal(dict(convert._flat(got))[name],
                                    np.asarray(want))
