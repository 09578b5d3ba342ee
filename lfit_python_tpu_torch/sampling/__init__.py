"""Ensemble sampler."""
