"""Nested-dict parameter trees keyed by slash-paths (`a/b/c`).

Counterpart of small_vision_tpu/utils/trees.py for the plain nested dicts
the port handles (flax param trees arrive as nested dicts of arrays). Dict
keys flatten in sorted order, as JAX flattens dicts.
"""

from typing import Any, Mapping, Sequence


def tree_flatten_with_names(tree, prefix=""):
  """[(name, leaf)] of a nested mapping, names slash-joined, keys sorted."""
  out = []
  for k in sorted(tree):
    name = f"{prefix}/{k}" if prefix else str(k)
    v = tree[k]
    if isinstance(v, Mapping):
      out.extend(tree_flatten_with_names(v, name))
    else:
      out.append((name, v))
  return out


def recover_tree(keys: Sequence[str], values: Sequence[Any]) -> dict:
  """Rebuilds a nested dict from slash-path keys (inverse of flatten)."""
  tree = {}
  for k, v in zip(keys, values):
    parts = k.split("/")
    node = tree
    for p in parts[:-1]:
      node = node.setdefault(p, {})
    node[parts[-1]] = v
  return tree
