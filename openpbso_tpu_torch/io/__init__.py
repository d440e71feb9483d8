"""Model file formats: the port's own numpy-only copies of what it uses of
openpbso_tpu/io/ (the JAX package stays the reference they are tested
against, tests/test_torch_io.py)."""
from .fatcube import (CubemapShell, FatcubeMap, decode_fatcube,
                      encode_fatcube, load_all_fatcubes, load_fatcube,
                      save_fatcube)
from .material import ModalMaterial, read_material, write_material
from .meta import ModelPaths, read_freq_threshold, resolve_model_dir
from .mode_data import ModeData, read_modes, write_modes
from .objmesh import icosphere, per_vertex_normals, read_obj, write_obj

__all__ = ["CubemapShell", "FatcubeMap", "ModalMaterial", "ModeData",
           "ModelPaths", "decode_fatcube", "encode_fatcube", "icosphere",
           "load_all_fatcubes", "load_fatcube", "per_vertex_normals",
           "read_freq_threshold", "read_material", "read_modes", "read_obj",
           "resolve_model_dir", "save_fatcube", "write_material",
           "write_modes", "write_obj"]
