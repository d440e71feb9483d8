"""Model file formats: the port's own numpy-only copies of
openpbso_tpu/io/ (the JAX package stays the reference they are tested
against, tests/test_torch_io.py)."""
from .fatcube import (CubemapShell, FatcubeMap, decode_fatcube,
                      encode_fatcube, load_all_fatcubes, load_fatcube,
                      maps_match_bits, save_fatcube)
from .material import ModalMaterial, read_material, write_material
from .meta import (ModelPaths, list_dir_files, prepare_meta_dir,
                   read_freq_threshold, read_meta, resolve_model_dir,
                   write_meta)
from .mode_data import ModeData, read_modes, write_modes
from .objmesh import icosphere, per_vertex_normals, read_obj, write_obj

__all__ = ["CubemapShell", "FatcubeMap", "ModalMaterial", "ModeData",
           "ModelPaths", "decode_fatcube", "encode_fatcube", "icosphere",
           "list_dir_files", "load_all_fatcubes", "load_fatcube",
           "maps_match_bits", "per_vertex_normals", "prepare_meta_dir",
           "read_freq_threshold", "read_material", "read_meta", "read_modes",
           "read_obj", "resolve_model_dir", "save_fatcube", "write_material",
           "write_meta", "write_modes", "write_obj"]
