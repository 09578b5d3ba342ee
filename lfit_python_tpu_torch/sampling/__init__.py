"""Samplers: stretch-move ensemble, parallel tempering, HMC, NUTS."""
