"""Device math of the port: modal bank, per-block integrator backends,
force-slot profiles, FFAT lookup (with its compressed texture), the chunked
span, the Doppler and HRTF post-mixes, and the CUDA kernels (the fused
block step, the chunk-state scan, the Toeplitz convolution, the AR noise
and AR block steps)."""
from .doppler import DopplerPostMix, delay_resample
from .ffat import build_ffat, build_ffat_hetero, compute_transfer
from .ffat_fit import compress_map
from .hrtf import HRTFPostMix, HRTFRenderer
