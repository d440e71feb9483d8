"""Synthetic assets (the port's own copy of openpbso_tpu/utils/synth.py)."""
