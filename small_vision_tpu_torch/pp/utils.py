"""pp helper decorators.

Counterpart of small_vision_tpu/pp/utils.py.
"""

import functools


def maybe_repeat(arg, n_reps):
  """Scalars become n-tuples; sequences pass through."""
  if not isinstance(arg, (list, tuple)):
    return (arg,) * n_reps
  return tuple(arg)


def InKeyOutKey(indefault: str = "image", outdefault: str = "image"):  # noqa: N802
  """Adds `key`/`inkey`/`outkey` kwargs to a single-tensor op factory.

  Decorates a factory whose inner fn has the signature
  `fn(tensor, data) -> tensor`; the wrapped factory accepts the key kwargs
  (settable from the pp string, e.g. `resize(64, key="image2")`) and
  returns a dict -> dict transform. An inner fn's whole-batch path
  (`inner.batch(tensors, datas) -> tensors or None`) is surfaced as the
  transform's `batch(datas) -> datas or None`, with the same keys.
  """

  def decorator(get_fn):
    @functools.wraps(get_fn)
    def get_wrapped(*args, key=None, inkey=None, outkey=None, **kw):
      inner = get_fn(*args, **kw)
      ik = inkey or key or indefault
      ok = outkey or key or outdefault

      def dict_fn(data):
        data[ok] = inner(data[ik], data)
        return data
      dict_fn.__name__ = getattr(get_fn, "__name__", "pp_op")

      inner_batch = getattr(inner, "batch", None)
      if inner_batch is not None:
        def dict_batch(datas):
          outs = inner_batch([d[ik] for d in datas], datas)
          if outs is None:
            return None
          for d, o in zip(datas, outs):
            d[ok] = o
          return datas
        dict_fn.batch = dict_batch
      return dict_fn
    return get_wrapped
  return decorator
