"""Roche geometry: potentials, L1, inclination solve, contacts, gas stream."""
