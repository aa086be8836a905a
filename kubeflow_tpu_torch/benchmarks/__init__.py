"""Kernel probes; counterparts of the JAX package's ``benchmarks/*_probe.py``."""
