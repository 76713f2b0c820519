"""Weights formats and parameter trees."""
