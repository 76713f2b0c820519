"""Port parity: the training step as a whole, against the JAX package's
real `make_update_fn`.

Both run 3 steps from the same `convert.init_params` weights on a small
UMD (width 128, 2 heads of 64, depth 2 + 1, 16 px, patch 4, batch 8) with
the same AdamW settings, in f32 in the two-apply form, and one step in
bf16. tests/test_torch_train_step_variants.py runs the same check with
`fused_branches` and with labels (label drop and EMA). The JAX step is built as
tests/test_reference_parity.py builds it (`_inject_draws=True`, no device
pp, a replicated mesh, here of one device) and runs its Pallas kernels in interpret mode; the
port runs its plain versions on the CPU.

The draws: t and the diffusion noise are made with numpy and given to both.
`_inject_draws` hands the JAX model PRNG keys for masking and label drop,
not the draws themselves, so the test recovers what the JAX step drew:
it wraps `random_masking` (as `small_vision_tpu.models.ae` imports it) and
`jax.random.bernoulli` so that they send their uniforms and drop masks to
the host with `jax.debug.callback`, and feeds those to the port. Nothing in
the JAX package changes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from small_vision_tpu import optim as joptim
from small_vision_tpu import parallel
from small_vision_tpu.models import ae as jae
from small_vision_tpu.ops import diffusion as jgd
from small_vision_tpu.train import train_ae as jtrain
from small_vision_tpu_torch import convert
from small_vision_tpu_torch.configs import ae_i1k
from small_vision_tpu_torch.train import train_ae
from small_vision_tpu_torch.utils.trees import tree_flatten_with_names

B, SIZE, T = 8, 16, 1000
N_STEPS = 3
# A peak learning rate large enough that three steps move the weights
# visibly: peak_lr * B / 256 = 1.6e-3, warmup 1 step (step 1 has lr 0).
OPT = dict(peak_lr=0.05, wd=0.05, betas=(0.9, 0.95), clip_norm=1.0,
           total_steps=10, warmup_steps=1)


def small_config(dtype="float32", labels=False, fused=False,
                 attn_impl="pallas", scan=False):
  config = ae_i1k.get_config(
      f"runlocal,size={SIZE},use_labels={labels},fused_branches={fused},"
      f"attn_impl={attn_impl}")
  config["model"].update(width=128, num_heads=2, dtype_mm=dtype, scan=scan)
  config["input"]["batch_size"] = B
  config["diffusion_space"] = (SIZE, SIZE, 3)
  config.update(peak_lr=OPT["peak_lr"], wd=OPT["wd"], betas=OPT["betas"],
                clip_norm=OPT["clip_norm"])
  if labels:
    config["ema_decay"] = 0.25  # large, so the EMA visibly moves
    # Drop half the labels, so that three steps of batch 8 drop some.
    config["model"]["cfg_dropout_rate"] = 0.5
  return config


class Captured:
  """The JAX step's mask uniforms (by mask ratio) and label-drop masks."""

  def __init__(self):
    self.uniforms, self.drops = {}, []

  def clear(self):
    self.uniforms, self.drops = {}, []


def install_capture(monkeypatch) -> Captured:
  """Wraps the JAX masking and Bernoulli draws to capture their values."""
  cap = Captured()
  orig_masking = jae.random_masking
  orig_bernoulli = jax.random.bernoulli

  def masking(x, mask_ratio, rng):
    b, l, _ = x.shape
    noise = jax.random.uniform(rng, (b, l))  # exactly as the original
    jax.debug.callback(
        lambda n: cap.uniforms.__setitem__(mask_ratio, np.asarray(n)),
        noise)
    return orig_masking(x, mask_ratio, rng)

  def bernoulli(key, p=0.5, shape=None, **kw):
    out = orig_bernoulli(key, p, shape, **kw)
    jax.debug.callback(lambda d: cap.drops.append(np.asarray(d)), out,
                       ordered=True)
    return out

  monkeypatch.setattr(jae, "random_masking", masking)
  monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
  return cap


@pytest.fixture
def captured(monkeypatch):
  return install_capture(monkeypatch)


def jax_side(config, params):
  kw = dict(config["model"])
  model = jae.Model(**{"scan": False, **kw,
                       "attn_impl": kw["attn_impl"] + "_interpret"})
  tx, _ = joptim.adamw_trainer_tx(
      peak_lr=OPT["peak_lr"], batch_size=B, total_steps=OPT["total_steps"],
      warmup_steps=OPT["warmup_steps"], wd=OPT["wd"], betas=OPT["betas"],
      clip_norm=OPT["clip_norm"])
  cfg = dict(no_noise_prob=config["no_noise_prob"],
             mask_ratio=config["mask_ratio"],
             mask_ratio_no_noise=config["mask_ratio_no_noise"],
             use_labels=config["use_labels"],
             ema_decay=config.get("ema_decay"),
             fused_branches=config["fused_branches"], l2_metrics=True,
             _inject_draws=True, diffusion_space=(SIZE, SIZE, 3))
  # One device: the ordered callback that recovers the label drops runs on
  # one device only. Replicated, as on the 8-device mesh.
  mesh = parallel.make_mesh(jax.devices()[:1])
  jparams = jax.tree.map(jnp.asarray, params)
  state = {"params": jparams, "opt": tx.init(jparams),
           "rng": jax.random.PRNGKey(7),
           "gd": jgd.GaussianDiffusion.create("cosine", T)}
  if config.get("ema_decay"):
    state["ema_params"] = jax.tree.map(jnp.copy, jparams)
  sharding = jax.tree.map(lambda _: parallel.replicated_sharding(mesh),
                          state)
  update = jtrain.make_update_fn(model, tx, cfg, None, mesh, sharding)
  return state, update


def torch_side(config, params):
  model = train_ae.build_model(config, device="cpu", trainable=True)
  model.load_state_dict(convert.params_from_jax(params, model))
  names = [n for n, _ in train_ae.named_params(model)]
  opt = train_ae.make_optimizer(config, names, OPT["total_steps"],
                                OPT["warmup_steps"])
  state = train_ae.init_train_state(model, opt, config, device="cpu")
  return names, state, train_ae.make_update_fn(model, opt, config, None)


def step_inputs(step, n_noise, labels):
  rng = np.random.default_rng(100 + step)
  images = (rng.standard_normal((B, SIZE, SIZE, 3)) * 0.5).astype(np.float32)
  t = rng.integers(0, T, (n_noise,)).astype(np.int32)
  noise = rng.standard_normal((n_noise, SIZE, SIZE, 3)).astype(np.float32)
  label = rng.integers(0, 1000, (B,)).astype(np.int32)
  keys = jax.random.split(jax.random.PRNGKey(1000 + step), 6)
  jbatch = {"image": images, "_t": t, "_noise": noise}
  for name, key in zip(("_rng_mae", "_cfg_mae", "_mae_mae", "_rng_dit",
                        "_mae_dit", "_cfg_dit"), keys):
    jbatch[name] = key
  tbatch = {"image": images}
  if labels:
    jbatch["label"] = label
    tbatch["label"] = label.astype(np.int64)
  return jbatch, tbatch, {"t": t.astype(np.int64), "noise": noise}


def port_draws(config, cap, base, n_no_noise):
  """The port's draws from the JAX step's captured ones."""
  draws = dict(base)
  draws["mae_noise"] = cap.uniforms[config["mask_ratio_no_noise"]]
  draws["dit_noise"] = cap.uniforms[config["mask_ratio"]]
  if config["use_labels"]:
    if config["fused_branches"]:
      (drop,) = cap.drops          # one draw over the joint batch
    else:
      _, drop = cap.drops          # the MAE branch's, then the diffusion's
      drop = np.concatenate([np.zeros(n_no_noise, bool), drop])
    draws["mae_drop"], draws["dit_drop"] = drop[:n_no_noise], drop[n_no_noise:]
  return draws


def flat(tree):
  return dict(tree_flatten_with_names(jax.device_get(tree)))


def run_both(config, cap, n_steps, seed=3, port_draws=port_draws):
  params = convert.init_params(config, seed=seed)
  jstate, jupdate = jax_side(config, params)
  names, tstate, tupdate = torch_side(config, params)
  n_no_noise = int(B * config["no_noise_prob"])
  history = []
  for step in range(n_steps):
    jbatch, tbatch, base = step_inputs(step, B - n_no_noise,
                                       config["use_labels"])
    cap.clear()
    jstate, jmeas = jupdate.with_l2(jstate, jbatch)
    jax.effects_barrier()
    tmeas = tupdate(tstate, tbatch, port_draws(config, cap, base, n_no_noise),
                    with_l2=True)
    jnu = joptim.find_states(jstate["opt"], optax.ScaleByAdamState)[0].nu
    history.append((jax.device_get(jmeas), tmeas, flat(jnu),
                    [n.clone() for n in tstate["opt"]["nu"]]))
  return names, jstate, tstate, history


def check_step1_grads(names, step1, rel):
  """Step 1's (clipped) gradients per leaf, read from Adam's second moment
  nu = (1 - b2) g² after the first step, within `rel` of each leaf's max.

  The key biases get a gradient that is 0 analytically (softmax does not
  see a shift of all of a query's scores by the same amount), so theirs is
  round-off, ~1e-11 on both sides: a leaf's scale is taken as at least
  1e-5 of the global gradient norm.
  """
  jmeas, _, jnu, tnu = step1
  floor = 1e-5 * float(jmeas["l2_grads"])
  for name, got in zip(names, tnu):
    g_got = np.sqrt(got.numpy() / 0.05)
    g_want = np.sqrt(np.asarray(jnu[name]) / 0.05)
    err = np.max(np.abs(g_got - g_want))
    assert err <= rel * max(np.max(np.abs(g_want)), floor), (name, err)


def check_three_steps_f32(cap, labels, fused, attn_impl="pallas",
                          config=None, port_draws=port_draws):
  """3 f32 steps of the port against the JAX step, with stated bounds (on
  `config`, by default `small_config`'s with the given settings)."""
  if config is None:
    config = small_config(labels=labels, fused=fused, attn_impl=attn_impl)
  names, jstate, tstate, history = run_both(config, cap, N_STEPS,
                                            port_draws=port_draws)
  lr = OPT["peak_lr"] * B / 256.0

  for step, (jmeas, tmeas, _, _) in enumerate(history):
    # The same f32 arithmetic in another summation order; from step 2 on,
    # through parameters that differ as bounded below.
    np.testing.assert_allclose(float(tmeas["training_loss"]),
                               float(jmeas["training_loss"]),
                               rtol=1e-5 if step == 0 else 5e-5)
    np.testing.assert_allclose(float(tmeas["l2_grads"]),
                               float(jmeas["l2_grads"]), rtol=1e-4)

  # Step 1's gradients per leaf: the same f32 sums in another order.
  check_step1_grads(names, history[0], 2e-5)

  # The parameters (and the EMA) after three steps: steps 2 and 3 move each
  # element by about lr (step 1 has lr 0). Adam divides each element by
  # its own RMS, so an element whose gradient is small against its leaf's
  # max carries the leaf-relative round-off above (up to ~1e-5) as a
  # relative error of its whole step: up to ~3 % of lr was seen. Every
  # element stays within 5 % of lr; none differs by a whole lr, and at
  # least 99 % are within 1 % of lr.
  keys = ["params"] + (["ema_params"] if labels else [])
  for key in keys:
    jtree = flat(jstate[key])
    within, total = 0, 0
    for name, p in zip(names, tstate[key]):
      diff = np.abs(p.detach().numpy() - np.asarray(jtree[name]))
      assert np.max(diff) <= 5e-2 * lr, (key, name, np.max(diff) / lr)
      within += int(np.sum(diff <= 1e-2 * lr))
      total += diff.size
    assert within >= 0.99 * total, (key, within, total)
  if labels:  # The label-drop draws were exercised.
    assert any(d.any() for d in cap.drops)


def test_three_steps_match_jax_f32(captured):
  check_three_steps_f32(captured, labels=False, fused=False)


def test_one_step_matches_jax_bf16(captured):
  config = small_config(dtype="bfloat16")
  names, _, _, history = run_both(config, captured, 1)
  jmeas, tmeas, jnu, tnu = history[0]
  # bf16 matmuls, residual stream and kernel outputs on both sides,
  # rounded at places that differ where values straddle a bf16 tie; the
  # loss is an f32 mean over them.
  np.testing.assert_allclose(float(tmeas["training_loss"]),
                             float(jmeas["training_loss"]), rtol=2e-3)
  # Gradients pass through bf16 activations and bf16 K2/K4 outputs:
  # a few bf16 roundings (2^-8 each) per leaf, relative to its max.
  check_step1_grads(names, history[0], 5e-2)
