"""Measurement tools of the port on an NVIDIA GPU: the least time each
kernel could take (``roofline``, arithmetic on shapes), an A/B timing of
Toeplitz-conv builds (``toeplitz_ab``), the card's mma.sync TF32 rate
(``mma_rate``) and instruction counts from a built library
(``sass_count``). The last three need the card and its CUDA toolkit."""
