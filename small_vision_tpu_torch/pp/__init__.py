"""Preprocessing of the port: the `"fn1|fn2(…)"` pp strings, their host
stage on numpy examples and their device stage on batches of tensors."""
