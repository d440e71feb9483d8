"""ModalSoundModel and its loader: the reference module is jax-free, so the
port imports it rather than copying it."""
from openpbso_tpu.models.modal_model import ModalSoundModel, load_model

__all__ = ["ModalSoundModel", "load_model"]
