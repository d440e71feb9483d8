"""Device math of the port: modal bank, per-block integrator backends,
force-slot profiles, FFAT lookup, and the fused CUDA block kernel."""
