"""Port parity: the training step with `fused_branches` (the shared
decoder pass of `dual_forward`), with labels (label drop and EMA) and
under `attn_impl="pallas_fused"` (the fused MLP and MHA, against the JAX
package's `pallas_fused_interpret`), against the JAX package's real
`make_update_fn`.

The same 3-step f32 check as tests/test_torch_train_step.py, which holds
the set-up, the recovery of the JAX step's draws and the stated bounds; a
file of its own so that the two run on separate workers.
"""

import pytest
from test_torch_train_step import captured  # noqa: F401 (fixture)
from test_torch_train_step import check_three_steps_f32


@pytest.mark.parametrize(
    "labels,fused,attn_impl",
    [(False, True, "pallas"), (True, False, "pallas"),
     (False, False, "pallas_fused")],
    ids=["fused_branches", "labels_ema", "pallas_fused"])
def test_three_steps_match_jax_f32(captured, labels, fused,  # noqa: F811
                                   attn_impl):
  check_three_steps_f32(captured, labels=labels, fused=fused,
                        attn_impl=attn_impl)
