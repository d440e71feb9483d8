"""Model assembly (the port's own copy of openpbso_tpu/models/modal_model.py)."""
