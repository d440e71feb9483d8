"""The scene of a binaural listener among instances of a few modal models,
made from the seed, for both sides (a configuration's ``"scene":
"spatial_scene"``).

``make_inputs`` draws ``models`` modal models, each its own eigenvalues
omega^2 (drawn as modal_bank draws an object's) and its own FFAT map set
(modal_bank.ffat_maps), with each map set's compressed copy; ``objects``
instances cycle through the models on modal_bank's floor grid, instance i
of gain base + step (i mod cycle); and the pool of contact rows. The
compressed copy is a frozen, vectorised copy of the uint8 quantisation of
openpbso_tpu_torch/ops/ffat_fit.py::compress_map (jpeg_quality None):
each face of a map divided by its largest magnitude, rounded to 255
levels and scaled back.

The program gets the arrays through its public constructors
(``port_scene``: the models, the instances and the compressed maps go to
``Scene``, which builds the session); the plain reference reads the same
arrays (``reference_scene``).
"""
from __future__ import annotations

import numpy as np

from .modal_bank import ffat_maps


def compress(psi: np.ndarray, grid: int) -> np.ndarray:
    """psi [M, 6 grid grid] through the uint8 quantisation, face by face."""
    faces = psi.reshape(psi.shape[0], 6, grid * grid)
    peak = np.abs(faces).max(axis=-1, keepdims=True)
    peak = np.where(peak > 0, peak, 1.0)
    q = np.round(np.clip(faces / peak, -1.0, 1.0) * 255.0)
    return (q * peak / 255.0).reshape(psi.shape)


def ear_offsets(cfg: dict) -> np.ndarray:
    """The ears' offsets [2, 3] from the head: -+ half the ear distance
    along x (left, right)."""
    ear = np.asarray((1.0, 0.0, 0.0)) * (cfg["ear_distance_m"] / 2)
    return np.stack([-ear, ear])


def make_inputs(cfg: dict, seed: int) -> dict:
    """The scene's arrays for ``seed``: the same seed gives the same
    arrays."""
    rng = np.random.default_rng([int(seed), 0x5BA71])
    n_mod, o, m = cfg["models"], cfg["objects"], cfg["modes"]
    mat = cfg["material"]
    lo = rng.uniform(*cfg["freq_low_hz"], size=n_mod)
    hi = rng.uniform(*cfg["freq_high_hz"], size=n_mod)
    freqs = np.stack([np.geomspace(a, b, m) for a, b in zip(lo, hi)])
    omega_sq = (2.0 * np.pi * freqs) ** 2 * mat["density"]
    f = cfg["ffat"]
    maps = []
    for _ in range(n_mod):
        mp = ffat_maps(rng, m, f["grid"], f["half_extent_m"],
                       f["freq_low_hz"], f["freq_high_hz"],
                       f["sound_speed_m_s"])
        mp["psi_c"] = compress(mp["psi"], f["grid"])
        maps.append(mp)
    side = int(np.ceil(np.sqrt(o)))
    gx, gy = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    centers = np.stack([gx.ravel(), gy.ravel(), np.zeros(side * side)],
                       axis=1)[:o] * cfg["layout"]["spacing_m"]
    centers[:, :2] -= centers[:, :2].mean(axis=0)
    g = cfg["instance_gain"]
    gains = g["base"] + g["step"] * (np.arange(o) % g["cycle"])
    contacts = rng.standard_normal((cfg["contact_rows"], m))
    return dict(omega_sq=omega_sq, maps=maps, centers=centers,
                model_of=np.arange(o) % n_mod, gains=gains,
                contacts=contacts)


def reference_scene(cfg: dict, inputs: dict) -> dict:
    """What the plain reference reads: the raw arrays, the texture the
    configuration reads (``maps``, each model's; ``raw_psi`` the raw
    texture, for checks that the comparison sees the difference) and the
    upstream's constants as the configuration states them."""
    mat = cfg["material"]
    key = "psi_c" if cfg["use_compressed"] else "psi"
    maps = [dict({k: v for k, v in mp.items() if k != "psi_c"}, psi=mp[key])
            for mp in inputs["maps"]]
    return dict(omega_sq=inputs["omega_sq"], density=mat["density"],
                alpha=mat["alpha"], beta=mat["beta"],
                rate=cfg["sample_rate"], block=cfg["block_size"],
                gain=cfg["modal_gain"], output_scale=cfg["output_scale"],
                unit_transfer=cfg["unit_transfer"], slots=cfg["slots"],
                objects=cfg["objects"], modes=cfg["modes"], maps=maps,
                raw_psi=[mp["psi"] for mp in inputs["maps"]],
                model_of=inputs["model_of"], centers=inputs["centers"],
                gains=inputs["gains"], ears=ear_offsets(cfg),
                itd=cfg["itd"], sound_speed=cfg["speed_of_sound_m_s"])


def _fatcube_maps(mp: dict, key: str) -> dict:
    """One model's maps, texture ``mp[key]``, as the program's FatcubeMaps
    (mode id -> map)."""
    from openpbso_tpu_torch.io.fatcube import CubemapShell, FatcubeMap
    psi, out = mp[key], {}
    for i in range(psi.shape[0]):
        shell = CubemapShell(
            cell_size=float(mp["cell"][i]), low_corners=mp["low_corners"][i],
            n_elements=mp["n_elements"][i].astype(np.int32),
            strides=mp["strides"][i].astype(np.int32),
            center=mp["center"][i], bbox_low=mp["bbox_low"][i],
            bbox_top=mp["bbox_top"][i])
        out[i] = FatcubeMap(mode_id=i, k=float(mp["k"][i]),
                            center=mp["center"][i], shell=shell, psi=psi[i],
                            is_compressed=key == "psi_c")
    return out


def port_scene(cfg: dict, inputs: dict, device) -> dict:
    """The program's models and instances, through its own constructors
    from the raw arrays, and each model's compressed maps."""
    from openpbso_tpu_torch.io.material import ModalMaterial
    from openpbso_tpu_torch.io.mode_data import ModeData
    from openpbso_tpu_torch.models import ModalSoundModel, SceneInstance
    mat = cfg["material"]
    material = ModalMaterial(density=mat["density"], youngs_modulus=0.0,
                             poisson_ratio=0.0, alpha=mat["alpha"],
                             beta=mat["beta"], name=mat["name"])
    m = cfg["modes"]
    models, compressed = [], []
    for k, mp in enumerate(inputs["maps"]):
        # no mesh: the traffic strikes with modal rows, never a vertex
        models.append(ModalSoundModel(
            name=f"model{k}", vertices=np.zeros((1, 3)),
            faces=np.zeros((0, 3), np.int64),
            normals=np.asarray([[0.0, 0.0, 1.0]]), material=material,
            modes=ModeData(omega_squared=inputs["omega_sq"][k],
                           modes=np.zeros((m, 3))),
            num_modes_audible=m, ffat_maps=_fatcube_maps(mp, "psi")))
        compressed.append(_fatcube_maps(mp, "psi_c"))
    instances = [SceneInstance(models[k], inputs["centers"][i],
                               gain=float(inputs["gains"][i]))
                 for i, k in enumerate(inputs["model_of"])]
    return dict(instances=instances, compressed=compressed, device=device)


def new_session(cfg: dict, port: dict, seed: int):
    """The session of a Scene built as the configuration states it, only
    through Scene's constructor (the Scene stays alive as the session's
    listener frame)."""
    import torch
    from openpbso_tpu_torch.models import Scene
    scene = Scene(
        port["instances"], block_size=cfg["block_size"], backend="auto",
        num_slots=cfg["slots"], binaural=cfg["binaural"],
        ear_distance=cfg["ear_distance_m"],
        smooth_transfer=cfg["smooth_transfer"], itd=cfg["itd"],
        compressed_maps=port["compressed"],
        use_compressed=cfg["use_compressed"], seed=seed,
        dtype=getattr(torch, cfg["dtype"]), device=port["device"])
    return scene.session
