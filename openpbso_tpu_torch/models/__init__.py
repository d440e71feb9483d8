"""Model assembly: the port's own copy of openpbso_tpu/models/modal_model.py
and the Scene that packs many instances into one session."""
from .modal_model import ModalSoundModel, load_model
from .scene import Scene, SceneInstance
