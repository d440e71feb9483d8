"""A configuration and its scene, each found by name.

``configs/<config>.json`` holds the configuration; its ``"scene"`` names
the module of ``scenes/`` that makes the scene from the seed: the raw
arrays (``make_inputs``), the program's objects built from them through
its public constructors (``port_scene``, ``new_session``) and what the
plain reference reads (``reference_scene``). A new kind of scene is a new
file there.
"""
from __future__ import annotations

import importlib
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def load_config(name: str) -> dict:
    with open(os.path.join(HERE, "configs", f"{name}.json")) as fh:
        return json.load(fh)


def kind(cfg: dict):
    """The module of ``scenes/`` that the configuration names."""
    return importlib.import_module(f"portbench.scenes.{cfg['scene']}")


def make_inputs(cfg: dict, seed: int) -> dict:
    return kind(cfg).make_inputs(cfg, seed)


def reference_scene(cfg: dict, inputs: dict) -> dict:
    return kind(cfg).reference_scene(cfg, inputs)


def port_scene(cfg: dict, inputs: dict, device) -> dict:
    return kind(cfg).port_scene(cfg, inputs, device)


def new_session(cfg: dict, port: dict, seed: int):
    return kind(cfg).new_session(cfg, port, seed)
