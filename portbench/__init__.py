"""The benchmark of the PyTorch/CUDA port (openpbso_tpu_torch): see
README.md and BENCHMARK.json at the root of the repository."""
