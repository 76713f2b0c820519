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


def tree_get(tree, name: str):
  """The subtree or leaf at slash-path `name`."""
  node = tree
  for part in name.split("/"):
    if isinstance(node, Mapping):
      node = node[part]
    elif isinstance(node, (list, tuple)):
      node = node[int(part)]
    else:
      node = getattr(node, part)
  return node


def tree_map(fn, *trees):
  """`fn` over the leaves of nested dicts, lists and tuples (the first
  tree's structure; the others alike)."""
  first = trees[0]
  if isinstance(first, Mapping):
    return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
  if isinstance(first, (list, tuple)):
    return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
  return fn(*trees)


def tree_leaves(tree) -> list:
  """The leaves of nested dicts, lists and tuples, in order."""
  if isinstance(tree, Mapping):
    return [x for v in tree.values() for x in tree_leaves(v)]
  if isinstance(tree, (list, tuple)):
    return [x for v in tree for x in tree_leaves(v)]
  return [tree]
