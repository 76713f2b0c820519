"""Data of the port: the sources (synthetic, arrays), the input pipeline
and the native JPEG decoder."""
