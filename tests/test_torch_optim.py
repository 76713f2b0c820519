"""Port parity: the trainer's AdamW, its schedule, decay mask and EMA, the
bridge of a JAX run's optimizer state, and the training init.

The port's `optim.AdamW` is held against the JAX package's
`optim.adamw_trainer_tx` (clip_by_global_norm + optax.adamw with a bf16
first moment) for 5 steps on a small flax-named tree, and its EMA against
`optax.incremental_update`. `convert.opt_state_from_jax` carries the optax
state into the port, which then continues as optax does.
`convert.init_train_params` is held against the distributions of the JAX
module's `init`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from small_vision_tpu import optim as joptim
from small_vision_tpu.models import ae as jae
from small_vision_tpu_torch import convert, optim
from small_vision_tpu_torch.configs import ae_i1k
from small_vision_tpu_torch.utils.trees import (recover_tree,
                                                tree_flatten_with_names)

# Flax-style names: a kernel and its bias, a LayerNorm scale, the cls and
# mask tokens, the head bias.
SHAPES = {"Encoder/blocks_00/MlpBlock_0/Dense_0/kernel": (32, 48),
          "Encoder/blocks_00/MlpBlock_0/Dense_0/bias": (48,),
          "Encoder/blocks_00/LayerNorm_0/scale": (32,),
          "cls": (1, 4, 32), "mask_token": (1, 1, 32), "head_bias": (6,)}
NAMES = sorted(SHAPES)
KW = dict(peak_lr=0.05, batch_size=64, total_steps=8, warmup_steps=2,
          wd=0.05, betas=(0.9, 0.95), clip_norm=1.0)


def _tree(rng, scale=1.0):
  return {n: (scale * rng.standard_normal(SHAPES[n])).astype(np.float32)
          for n in NAMES}


def _jax(flat):
  return recover_tree(list(flat), [jnp.asarray(v) for v in flat.values()])


def _flat(tree):
  return dict(tree_flatten_with_names(jax.device_get(tree)))


def test_decay_mask_exempts_by_path_token():
  got = dict(zip(NAMES, optim.decay_mask(NAMES)))
  assert got == {n: not (n.endswith("/bias") or n in ("cls", "mask_token"))
                 for n in NAMES}
  # `head_bias` is one token, not `bias`: decayed, as in the JAX package.
  assert got["head_bias"] and got["Encoder/blocks_00/LayerNorm_0/scale"]


def test_schedule_matches_optax():
  want = optax.warmup_cosine_decay_schedule(
      0.0, KW["peak_lr"] * KW["batch_size"] / 256, KW["warmup_steps"],
      KW["total_steps"])
  opt = optim.AdamW(NAMES, **KW)
  for count in range(KW["total_steps"] + 3):
    # f32 on both sides; cos may differ by an ulp between the libraries.
    np.testing.assert_allclose(opt.lr(count), float(want(count)),
                               rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("grad_scale", [0.01, 1.0],
                         ids=["unclipped", "clipped"])
def test_adamw_matches_optax_for_5_steps(grad_scale):
  rng = np.random.default_rng(0)
  params = _tree(rng)
  tx, _ = joptim.adamw_trainer_tx(**KW)
  jparams = _jax(params)
  jstate = tx.init(jparams)
  opt = optim.AdamW(NAMES, **KW)
  tparams = [torch.from_numpy(params[n].copy()) for n in NAMES]
  tstate = opt.init(tparams)
  lr = KW["peak_lr"] * KW["batch_size"] / 256
  for _ in range(5):
    grads = _tree(rng, grad_scale)
    jgrads = _jax(grads)
    want_norm = float(optax.global_norm(jgrads))
    updates, jstate = tx.update(jgrads, jstate, jparams)
    jparams = optax.apply_updates(jparams, updates)
    metrics = opt.step(tparams, [torch.from_numpy(grads[n]) for n in NAMES],
                       tstate, with_l2=True)
    np.testing.assert_allclose(float(metrics["l2_grads"]), want_norm,
                               rtol=1e-6)
    want = _flat(jparams)
    adam = joptim.find_states(jstate, optax.ScaleByAdamState)[0]
    mu, nu = _flat(adam.mu), _flat(adam.nu)
    for i, n in enumerate(NAMES):
      # The same f32 arithmetic at the same rounding points; the global
      # norm (a sum over leaves) may differ by an ulp, and so may a bf16
      # rounding of mu that it tips: a few ulps of the step (lr).
      np.testing.assert_allclose(tparams[i].numpy(), want[n], rtol=0,
                                 atol=1e-3 * lr)
      assert tstate["mu"][i].dtype == torch.bfloat16
      np.testing.assert_allclose(tstate["mu"][i].float().numpy(),
                                 np.asarray(mu[n], np.float32), rtol=2**-7,
                                 atol=1e-9)
      np.testing.assert_allclose(tstate["nu"][i].numpy(), nu[n], rtol=1e-5,
                                 atol=1e-12)
    assert tstate["count"] == int(adam.count)


def test_ema_matches_optax():
  rng = np.random.default_rng(1)
  new, old = _tree(rng), _tree(rng)
  want = _flat(optax.incremental_update(_jax(new), _jax(old), 0.0625))
  ema = [torch.from_numpy(old[n].copy()) for n in NAMES]
  optim.ema_update(ema, [torch.from_numpy(new[n]) for n in NAMES], 0.0625)
  for n, e in zip(NAMES, ema):
    np.testing.assert_allclose(e.numpy(), want[n], rtol=1e-7, atol=1e-7)


def test_opt_state_bridge_continues_a_jax_run():
  """Three optax steps, the state carried across, two more steps on each
  side: the same parameters."""
  rng = np.random.default_rng(2)
  tx, _ = joptim.adamw_trainer_tx(**KW)
  jparams = _jax(_tree(rng))
  jstate = tx.init(jparams)
  ema = jax.tree.map(jnp.copy, jparams)
  for _ in range(3):
    updates, jstate = tx.update(_jax(_tree(rng)), jstate, jparams)
    jparams = optax.apply_updates(jparams, updates)
    ema = optax.incremental_update(jparams, ema, 0.25)
  adam = joptim.find_states(jstate, optax.ScaleByAdamState)[0]
  # As numpy trees: mu stays bf16 (ml_dtypes), nu f32, count an int.
  state, tema = convert.opt_state_from_jax(
      NAMES, count=np.asarray(adam.count), mu=jax.device_get(adam.mu),
      nu=jax.device_get(adam.nu), ema_params=jax.device_get(ema))
  assert state["count"] == 3
  assert all(m.dtype == torch.bfloat16 for m in state["mu"])
  for n, m, e in zip(NAMES, state["mu"], tema):
    np.testing.assert_array_equal(m.float().numpy(),
                                  np.asarray(_flat(adam.mu)[n], np.float32))
    np.testing.assert_array_equal(e.numpy(), _flat(ema)[n])

  opt = optim.AdamW(NAMES, **KW)
  tparams = [torch.from_numpy(np.array(_flat(jparams)[n])) for n in NAMES]
  lr = KW["peak_lr"] * KW["batch_size"] / 256
  for _ in range(2):
    grads = _tree(rng)
    updates, jstate = tx.update(_jax(grads), jstate, jparams)
    jparams = optax.apply_updates(jparams, updates)
    opt.step(tparams, [torch.from_numpy(grads[n]) for n in NAMES], state)
  for n, p in zip(NAMES, tparams):
    np.testing.assert_allclose(p.numpy(), _flat(jparams)[n], rtol=0,
                               atol=1e-3 * lr)

  with pytest.raises(KeyError, match="names differ"):
    convert.opt_state_from_jax(NAMES[:-1], count=3, mu=adam.mu, nu=adam.nu)


def test_train_init_matches_the_jax_distributions():
  """`init_train_params` draws each leaf from the distribution the JAX
  module declares: the same zeros and ones, and random leaves of the same
  mean and spread (statistics of the leaves, not their bits)."""
  config = ae_i1k.get_config("runlocal,size=16,use_labels=True")
  config["model"].update(width=128, num_heads=2)
  model = jae.Model(**{"scan": False, **config["model"],
                       "attn_impl": "pallas_interpret"})
  want = _flat(model.init(
      {"params": jax.random.PRNGKey(0), "mae_noise": jax.random.PRNGKey(1)},
      jnp.zeros((1, 16, 16, 3)), t=jnp.zeros((1,), jnp.int32),
      y=jnp.zeros((1,), jnp.int32))["params"])
  got = _flat(convert.init_train_params(config, seed=0))
  assert set(got) == set(want)
  for n in sorted(want):
    g, w = got[n], np.asarray(want[n])
    assert g.shape == w.shape and g.dtype == np.float32, n
    if np.all(w == w.flat[0]):  # zeros and ones
      np.testing.assert_array_equal(g, w, err_msg=n)
      continue
    # Random leaves: the two samples' spreads and means agree within 4
    # standard errors of their difference (1/sqrt(n) of the spread for the
    # spreads' ratio, sqrt(2/n) spreads for the means).
    se = 1.0 / np.sqrt(g.size)
    np.testing.assert_allclose(g.std(), w.std(), rtol=4 * se, err_msg=n)
    assert abs(g.mean() - w.mean()) <= 4 * np.sqrt(2) * se * w.std(), n
    assert np.max(np.abs(g)) <= 1.5 * np.max(np.abs(w)), n
