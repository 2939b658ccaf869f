"""Continuous dynamics and integrators."""
