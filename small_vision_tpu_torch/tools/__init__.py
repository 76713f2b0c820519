"""The sampler callable and the batching server."""
