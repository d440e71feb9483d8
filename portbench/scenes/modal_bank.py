"""The scene of a bank of modal objects on a floor, made from the seed,
for both sides (a configuration's ``"scene": "modal_bank"``).

``make_inputs`` draws everything a cell's scene is made of as plain numpy
arrays: each object's undivided eigenvalues omega^2 (ceramic, log-spaced
between the configuration's bands), the FFAT maps of every mode (one
cubemap shell around each object, a smooth positive lobe pattern of
directions), the objects' places on the floor and a pool of contact rows
(the modal amplitudes a strike at one surface point excites). The program
gets them through its public constructors (``port_scene``); the plain
reference reads the same arrays (``reference_scene``).

The map and mode makers are frozen, vectorised copies of
openpbso_tpu_torch/utils/synth.py (synth_mode_data, synth_cubemap_shell,
synth_fatcube) and of chip_smoke.py's hetero_modes, shared_modes and
session_scene: the same shapes and value ranges, drawn from the run's seed.
"""
from __future__ import annotations

import numpy as np


def cubemap_shell(n: int, half: float) -> dict:
    """One n x n cubemap shell centred at the origin (faces +x, -x, +y, -y,
    +z, -z; face f lies on the top plane of axis f // 2 for even f)."""
    low = -half * np.ones(3)
    top = half * np.ones(3)
    corners = np.zeros((6, 3))
    for face in range(6):
        k = face // 2
        i, j = (k + 1) % 3, (k + 2) % 3
        corners[face, i], corners[face, j] = low[i], low[j]
        corners[face, k] = top[k] if face % 2 == 0 else low[k]
    return dict(cell=2.0 * half / n, low_corners=corners,
                n_elements=np.full((6, 2), n, np.int64),
                strides=np.arange(6, dtype=np.int64) * n * n,
                center=np.zeros(3), bbox_low=low, bbox_top=top)


def ffat_maps(rng, modes: int, n: int, half: float, f_lo: float,
              f_hi: float, sound_speed: float) -> dict:
    """Every mode's map on one shared shell: psi [M, 6 n n] of
    max(1 + 0.4 sum_a tanh(dir . axis_a), 0.05) 1e6 over the cell
    centres' directions, with three random axes per mode; k = omega / c."""
    shell = cubemap_shell(n, half)
    cells = []
    for face in range(6):
        k = face // 2
        i, j = (k + 1) % 3, (k + 2) % 3
        u, v = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        pos = np.zeros((n, n, 3))
        pos[..., i] = shell["low_corners"][face, i] + (u + 0.5) * shell["cell"]
        pos[..., j] = shell["low_corners"][face, j] + (v + 0.5) * shell["cell"]
        pos[..., k] = shell["low_corners"][face, k]
        cells.append(pos.reshape(-1, 3))
    dirs = np.concatenate(cells)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)      # [6 n n, 3]
    axes = rng.standard_normal((modes, 3, 3))
    lobes = np.tanh(np.einsum("pc,mac->map", dirs, axes)).sum(axis=1)
    psi = np.maximum(1.0 + 0.4 * lobes, 0.05) * 1e6           # [M, 6 n n]
    freqs = np.geomspace(f_lo, f_hi, modes)
    tile = lambda x: np.broadcast_to(x, (modes,) + np.shape(x)).copy()
    return dict(psi=psi, k=2.0 * np.pi * freqs / sound_speed,
                center=tile(shell["center"]), bbox_low=tile(shell["bbox_low"]),
                bbox_top=tile(shell["bbox_top"]),
                low_corners=tile(shell["low_corners"]),
                n_elements=tile(shell["n_elements"]),
                strides=tile(shell["strides"]),
                cell=np.full(modes, shell["cell"]), mask=np.ones(modes))


def make_inputs(cfg: dict, seed: int) -> dict:
    """The scene's arrays for ``seed``: the same seed gives the same
    arrays."""
    rng = np.random.default_rng([int(seed), 0x5CE4E])
    o, m = cfg["objects"], cfg["modes"]
    mat = cfg["material"]
    groups = 1 if cfg["shared_bank"] else o
    lo = rng.uniform(*cfg["freq_low_hz"], size=groups)
    hi = rng.uniform(*cfg["freq_high_hz"], size=groups)
    freqs = np.stack([np.geomspace(a, b, m) for a, b in zip(lo, hi)])
    omega_sq = (2.0 * np.pi * freqs) ** 2 * mat["density"]
    f = cfg["ffat"]
    maps = ffat_maps(rng, m, f["grid"], f["half_extent_m"], f["freq_low_hz"],
                     f["freq_high_hz"], f["sound_speed_m_s"])
    side = int(np.ceil(np.sqrt(o)))
    lay = cfg["layout"]
    gx, gy = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    centers = np.stack([gx.ravel(), gy.ravel(), np.zeros(side * side)],
                       axis=1)[:o] * lay["spacing_m"]
    centers[:, :2] -= centers[:, :2].mean(axis=0)
    contacts = rng.standard_normal((cfg["contact_rows"], m))
    return dict(omega_sq=omega_sq, maps=maps, centers=centers,
                contacts=contacts)


def reference_scene(cfg: dict, inputs: dict) -> dict:
    """What the plain reference reads: the raw arrays and the upstream's
    constants as the configuration states them."""
    mat = cfg["material"]
    return dict(omega_sq=inputs["omega_sq"], density=mat["density"],
                alpha=mat["alpha"], beta=mat["beta"],
                rate=cfg["sample_rate"], block=cfg["block_size"],
                gain=cfg["modal_gain"], output_scale=cfg["output_scale"],
                unit_transfer=cfg["unit_transfer"], slots=cfg["slots"],
                objects=cfg["objects"], modes=cfg["modes"],
                maps=inputs["maps"])


def port_scene(cfg: dict, inputs: dict, device) -> dict:
    """The program's bank, maps and float64 eigenvalues, through its own
    constructors from the raw arrays."""
    from openpbso_tpu_torch.io.fatcube import CubemapShell, FatcubeMap
    from openpbso_tpu_torch.ops.coeffs import (bank_from_material,
                                               build_modal_bank,
                                               lambda_from_modes)
    from openpbso_tpu_torch.ops.ffat import build_ffat
    mat = cfg["material"]
    o, s = cfg["objects"], cfg["block_size"]
    if cfg["shared_bank"]:
        bank = bank_from_material(mat["density"], inputs["omega_sq"][0],
                                  mat["alpha"], mat["beta"], num_objects=o,
                                  block_size=s, device=device)
        lam64 = lambda_from_modes(mat["density"], inputs["omega_sq"][0],
                                  mat["alpha"], mat["beta"])[0]
    else:
        parts = [lambda_from_modes(mat["density"], w2, mat["alpha"],
                                   mat["beta"]) for w2 in inputs["omega_sq"]]
        lam, b, valid = (np.stack(x) for x in zip(*parts))
        bank = build_modal_bank(lam, b, valid, block_size=s, shared=False,
                                device=device)
        lam64 = lam
    mp = inputs["maps"]
    maps = {}
    for i in range(cfg["modes"]):
        shell = CubemapShell(
            cell_size=float(mp["cell"][i]), low_corners=mp["low_corners"][i],
            n_elements=mp["n_elements"][i].astype(np.int32),
            strides=mp["strides"][i].astype(np.int32),
            center=mp["center"][i], bbox_low=mp["bbox_low"][i],
            bbox_top=mp["bbox_top"][i])
        maps[i] = FatcubeMap(mode_id=i, k=float(mp["k"][i]),
                             center=mp["center"][i], shell=shell,
                             psi=mp["psi"][i])
    ffat = build_ffat(maps, cfg["modes"], device=device)
    return dict(bank=bank, ffat=ffat, lam64=lam64)


def new_session(cfg: dict, port: dict, seed: int):
    """A session over the program's bank and maps as the configuration
    states it."""
    import torch
    from openpbso_tpu_torch.runtime.session import ModalSession
    from openpbso_tpu_torch.runtime.solver import SolverConfig
    sess = ModalSession(
        port["bank"], port["ffat"],
        SolverConfig(block_size=cfg["block_size"], backend="auto",
                     smooth_transfer=cfg["smooth_transfer"]),
        num_slots=cfg["slots"], seed=seed,
        dtype=getattr(torch, cfg["dtype"]),
        lam64=port["lam64"] if cfg["span_path"] else None)
    return sess
