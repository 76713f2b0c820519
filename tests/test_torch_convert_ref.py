"""Port parity: `utils/convert_ref.py` against small_vision_tpu.utils.
convert_ref, both ways.

The reference checkpoint is not in the repository, so a reference-named
tree is made by the JAX `ours_to_ref` of a JAX `scan=True` init of a
small UMD (labels, AdaLN, patch 4) and of the port's `init_params` in the
stacked layout. Held exactly (bit for bit): the port's `ref_to_ours` and
`ours_to_ref` against JAX's on the same trees, names and arrays; the
round trips; `head_from_final_conv` / `final_conv_from_head` against
JAX's at patch 2 and 4. Composed with `convert.py`: `ref_state_dict`
loads the reference-named weights into port models of both block
layouts, and their forward equals the port model loaded from the flax
tree itself, bit for bit (f32, the same weights).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import small_config

from small_vision_tpu.models import ae as jae
from small_vision_tpu.utils import convert_ref as jref
from small_vision_tpu_torch import convert
from small_vision_tpu_torch.train import train_ae
from small_vision_tpu_torch.utils import convert_ref
from small_vision_tpu_torch.utils.trees import tree_flatten_with_names


def _flat(tree):
  return {k: np.asarray(v) for k, v in tree_flatten_with_names(tree)}


def _equal(got, want):
  got, want = _flat(got), _flat(want)
  assert sorted(got) == sorted(want)
  for k in want:
    assert got[k].dtype == want[k].dtype, k
    np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _config():
  config = small_config(adaln=True, labels=True)
  config["model"].update(scan=True, dtype_mm="float32")
  return config


@pytest.fixture(scope="module")
def jax_init():
  """A JAX init of the small UMD (unrolled: it traces faster), stacked as
  a `scan=True` model holds it."""
  kw = dict(_config()["model"], attn_impl="xla", scan=False)
  variables = jax.jit(jae.Model(**kw).init)(
      jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 3)),
      t=jnp.zeros((1,), jnp.int32), y=jnp.zeros((1,), jnp.int32))
  return convert.stack_blocks(
      jax.tree.map(np.asarray, jax.device_get(variables["params"])))


@pytest.mark.parametrize("source", ["jax_init", "port_init"])
def test_both_ways_match_jax(source, jax_init):
  if source == "jax_init":
    ours = jax_init
  else:
    ours = convert.stack_blocks(convert.init_params(_config(), 5))
  ref = jref.ours_to_ref(ours, 4)
  assert any("ScanCheckpointEncoder1DBlock_0" in k for k in _flat(ref))
  assert "final_conv/kernel" in _flat(ref)
  _equal(convert_ref.ours_to_ref(ours, 4), ref)
  back = convert_ref.ref_to_ours(ref, 4)
  _equal(back, jref.ref_to_ours(ref, 4))
  _equal(back, ours)


@pytest.mark.parametrize("patch", [2, 4])
def test_head_mapping_matches_jax(patch):
  rng = np.random.default_rng(patch)
  conv = rng.normal(size=(patch, patch, 8, 6)).astype(np.float32)
  head = convert_ref.head_from_final_conv(conv)
  np.testing.assert_array_equal(head, jref.head_from_final_conv(conv))
  np.testing.assert_array_equal(
      convert_ref.final_conv_from_head(head, patch),
      jref.final_conv_from_head(head, patch))
  np.testing.assert_array_equal(
      convert_ref.final_conv_from_head(head, patch), conv)


@pytest.mark.parametrize("scan", [False, True])
def test_ref_weights_load_into_the_port(scan, jax_init):
  config = _config()
  config["model"].update(scan=scan, attn_impl="xla")
  ours = jax_init
  ref = jref.ours_to_ref(ours, 4)
  via_ref = train_ae.build_model(config, device="cpu")
  via_ref.load_state_dict(convert_ref.ref_state_dict(ref, via_ref))
  direct = train_ae.build_model(config, device="cpu")
  direct.load_state_dict(convert.params_from_jax(ours, direct))
  rng = np.random.default_rng(0)
  x = torch.from_numpy(rng.normal(size=(2, 16, 16, 3)).astype(np.float32))
  t = torch.tensor([3, 40])
  y = torch.tensor([1, 7])
  with torch.no_grad():
    got, _ = via_ref(x, t=t, y=y)
    want, _ = direct(x, t=t, y=y)
  torch.testing.assert_close(got, want, rtol=0, atol=0)
