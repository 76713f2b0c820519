"""Data sources of the port (the synthetic source; ImageNet comes later)."""
