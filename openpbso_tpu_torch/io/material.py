"""Modal material parameters (DyRT [James 2002] conventions).

The port's own copy of what it uses of openpbso_tpu/io/material.py.

Text format (reference ModalMaterial.h:35-55): lines starting with ``#`` are
comments; the first non-comment line holds five whitespace-separated numbers::

    density  youngs_modulus  poisson_ratio  alpha  beta

where alpha/beta are the Rayleigh damping coefficients.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ModalMaterial:
    density: float
    youngs_modulus: float
    poisson_ratio: float
    alpha: float
    beta: float
    name: str = ""


def read_material(path: str) -> ModalMaterial:
    """Parse a material file (reference ModalMaterial.h:35-55)."""
    line = None
    with open(path) as f:
        for raw in f:
            stripped = raw.strip()
            if not stripped or stripped.startswith("#"):
                continue  # blank lines and comments (istream-style skipping)
            line = raw
            break
    if line is None:
        raise ValueError(f"no data line in material file: {path}")
    vals = [float(tok) for tok in line.split()[:5]]
    if len(vals) != 5:
        raise ValueError(f"material file needs 5 values, got {len(vals)}: {path}")
    density, youngs, poisson, alpha, beta = vals
    return ModalMaterial(
        density=density,
        youngs_modulus=youngs,
        poisson_ratio=poisson,
        alpha=alpha,
        beta=beta,
        name=path,
    )


def write_material(path: str, m: ModalMaterial, comment: str = "") -> None:
    with open(path, "w") as f:
        if comment:
            f.write(f"# {comment}\n")
        f.write("# density youngs_modulus poisson_ratio alpha beta\n")
        f.write(
            f"{m.density} {m.youngs_modulus} {m.poisson_ratio} "
            f"{m.alpha} {m.beta}\n"
        )
