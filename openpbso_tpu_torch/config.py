"""Global constants of the modal sound engine: the port's own copy of
openpbso_tpu/config.py (tests/test_torch_io.py holds them equal).

- ``SAMPLE_RATE`` / ``FRAMES_PER_BUFFER``: reference config.h:13-14.
- ``MODAL_GAIN``: the "arbitrary scaling" 1E9 applied to the c3 IIR input
  coefficient (reference modal_integrator.h:99).
- ``UNIT_TRANSFER``: the all-ones transfer level 1E7 used when FFAT maps are
  disabled or missing (reference modal_solver.h:89-92).
- ``OUTPUT_SCALE``: audio samples are divided by 1E10 before hitting the DAC
  (reference tools/real_time_modal_sound.cpp:207-210).
- ``DEFAULT_AUDIBLE_FREQ``: mode-culling threshold when no freq_threshold.txt
  exists (reference tools/real_time_modal_sound.cpp:327-329).
- ``DEFAULT_BLOCK``: the streaming block size; ``FRAMES_PER_BUFFER`` (513,
  the reference's PortAudio setup) is kept for parity renders.
- ``REBASE_PERIOD``: samples between re-zeroes of the session clock; the
  sustained noise index wraps modulo it (ops/ar_noise.py), so live stepping
  and timeline bakes stay bit-identical across the boundary.
- ``SOUND_SPEED``: air at ~20 C, the c of the FFAT wavenumbers k = omega/c.
"""

SAMPLE_RATE = 44100
FRAMES_PER_BUFFER = 513          # reference block size (kept for parity)
DEFAULT_BLOCK = 512              # streaming block size

MODAL_GAIN = 1e9                 # c3 gain        (modal_integrator.h:99)
UNIT_TRANSFER = 1e7              # unit transfer  (modal_solver.h:91)
OUTPUT_SCALE = 1e10              # output divisor (real_time_modal_sound.cpp:208)
DEFAULT_AUDIBLE_FREQ = 20000.0   # Hz             (real_time_modal_sound.cpp:328)

FILE_NOT_EXIST = "__NA_FILE"     # CLI sentinel   (config.h:11)

REBASE_PERIOD = 1 << 30          # samples between session-clock re-zeroes

SOUND_SPEED = 343.0              # m/s
