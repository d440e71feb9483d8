"""Command-line tools of the port: the counterparts of openpbso_tpu/apps/."""
