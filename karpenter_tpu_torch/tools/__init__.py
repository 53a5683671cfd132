"""Operational tooling (reference tools/): allocatable-diff and kompat."""
