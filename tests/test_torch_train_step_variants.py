"""Port parity: the training step with `fused_branches` (the shared
decoder pass of `dual_forward`) and with labels (label drop and EMA),
against the JAX package's real `make_update_fn`.

The same 3-step f32 check as tests/test_torch_train_step.py, which holds
the set-up, the recovery of the JAX step's draws and the stated bounds; a
file of its own so that the two run on separate workers.
"""

import pytest
from test_torch_train_step import captured  # noqa: F401 (fixture)
from test_torch_train_step import check_three_steps_f32


@pytest.mark.parametrize("labels,fused", [(False, True), (True, False)],
                         ids=["fused_branches", "labels_ema"])
def test_three_steps_match_jax_f32(captured, labels, fused):  # noqa: F811
  check_three_steps_f32(captured, labels=labels, fused=fused)
