"""FFAT map compression: the port's own copy of ``compress_map`` from
openpbso_tpu/ops/ffat_fit.py (the rest of that module fits maps offline and
is not needed at run time).

``compress_map`` builds the reference's second Psi set, which
``ops/ffat.py::build_ffat(compressed_maps=...)`` carries beside the raw one
for the runtime compressed-vs-raw toggle (FFAT_Map<T,3>::Compress,
ffat_solver.h:1124-1178): per-face max-normalized uint8 images, optionally
round-tripped through a real JPEG encode and decode.
"""
from __future__ import annotations

import numpy as np

from ..io.fatcube import FatcubeMap


def compress_map(m: FatcubeMap, jpeg_quality: int | None = None
                 ) -> FatcubeMap:
    """FFAT_Map<T,3>::Compress (ffat_solver.h:1124-1178): per-face
    max-normalized uint8 images, optionally round-tripped through a real
    JPEG encode and decode.

    ``jpeg_quality``: None keeps the lossless-codec stand-in (uint8
    quantization only: the information floor of the reference's pipeline);
    an int routes each face image through a JPEG write and read-back at
    that quality via PIL, as the reference's OpenCV imwrite/imread at
    IMWRITE_JPEG_QUALITY=quality does (the tool uses 65). PIL is imported
    only in that branch, and a machine without it raises ImportError there.
    """
    psi_c = np.empty_like(m.psi)
    for face in range(6):
        nu, nv = (int(x) for x in m.shell.n_elements[face])
        start = int(m.shell.strides[face])
        seg = m.psi[start: start + nu * nv]
        peak = float(np.max(np.abs(seg))) or 1.0
        if jpeg_quality is not None:
            import io as _io

            from PIL import Image
            # the signed range is encoded symmetrically ([-peak, peak] ->
            # [0, 255]), so negative psi survives the uint8 image
            q = np.round(np.clip(seg / peak, -1.0, 1.0) * 127.5 + 127.5)
            img = Image.fromarray(
                q.astype(np.uint8).reshape(nu, nv), mode="L")
            buf = _io.BytesIO()
            img.save(buf, format="JPEG", quality=int(jpeg_quality))
            buf.seek(0)
            q = np.asarray(Image.open(buf), np.float64).reshape(-1)
            psi_c[start: start + nu * nv] = (q - 127.5) / 127.5 * peak
        else:
            q = np.round(np.clip(seg / peak, -1.0, 1.0) * 255.0)
            psi_c[start: start + nu * nv] = q * peak / 255.0
    return FatcubeMap(mode_id=m.mode_id, k=m.k, center=m.center.copy(),
                      shell=m.shell, psi=psi_c, is_compressed=True)
