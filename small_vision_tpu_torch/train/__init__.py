"""The trainer's model builder and sampler functions."""
