"""Global constants: the reference's own module, re-exported (it is jax-free)."""
from openpbso_tpu.config import (DEFAULT_AUDIBLE_FREQ, DEFAULT_BLOCK,  # noqa: F401
                                 FILE_NOT_EXIST, FRAMES_PER_BUFFER,
                                 MODAL_GAIN, OUTPUT_SCALE, REBASE_PERIOD,
                                 SAMPLE_RATE, SOUND_SPEED, UNIT_TRANSFER)
