"""Preprocessing of the port: the device stage of the pp string."""
