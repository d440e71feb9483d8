"""Device math of the port: modal bank, per-block integrator backends,
force-slot profiles, FFAT lookup, the chunked span, and the CUDA kernels
(the fused block step, the chunk-state scan, the Toeplitz convolution)."""
