"""Synthetic model and asset generation: the reference module is jax-free,
so the port imports it rather than copying it."""
from openpbso_tpu.utils.synth import (CERAMIC, synth_cubemap_shell,
                                      synth_fatcube, synth_mode_data,
                                      synth_model_dir)

__all__ = ["CERAMIC", "synth_cubemap_shell", "synth_fatcube",
           "synth_mode_data", "synth_model_dir"]
