"""Evaluators: config-driven periodic evaluations of a train state."""
