"""The few-shot linear-probe evaluator entry, as a plain dict.

Counterpart of small_vision_tpu/configs/common_fewshot.py: the closed-form
least-squares probe on `pre_logits`, 100 shots, l2_reg 1024.
"""


def get_fewshot_lsr(target_resolution=64, resize_resolution=67,
                    runlocal=False, datasets=None, pred="predict") -> dict:
  pp = (f"decode|resize_small({resize_resolution})"
        f"|central_crop({target_resolution})"
        f'|value_range(-1, 1)|keep("image", "label")')
  return dict(
      type="fewshot_lsr",
      pred=pred,
      representation_layer="pre_logits",
      log_steps=25_000,
      datasets=datasets or {},
      shots=(100,),
      l2_reg=2.0 ** 10,
      num_seeds=3 if not runlocal else 1,
      display_first=[("imagenet", 100)],
      pp_train=pp,
      pp_eval=pp,
  )
