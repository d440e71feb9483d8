"""Scene: the batched assembly of many sounding objects.

Counterpart of openpbso_tpu/models/scene.py. The reference runs exactly one
object per process (real_time_modal_sound.cpp:518-525); here the unit of
execution is a scene: O object instances (possibly of different models,
materials and mode counts) packed into the [O, M] tensors the solver
consumes. Instances of one model share lam-power tables and FFAT textures;
heterogeneous scenes get per-object rows.

Each instance carries a world position and a stereo gain; listener updates
translate one world listener into per-object relative positions (the
reference's single object sits at the origin), with optional 1/r distance
attenuation on the gains.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import DEFAULT_BLOCK
from ..device import resolve_device
from .modal_model import ModalSoundModel


@dataclasses.dataclass
class SceneInstance:
    model: ModalSoundModel
    position: np.ndarray                 # [3] world position
    gain: float = 1.0
    pan: float = 0.0                     # -1 (left) .. +1 (right)


class Scene:
    """Builds and owns the device session for a set of instances."""

    def __init__(self, instances: list[SceneInstance], *,
                 block_size: int = DEFAULT_BLOCK,
                 backend: str = "auto",
                 num_slots: int = 16,
                 use_ffat: bool = True,
                 binaural: bool = False,
                 ear_distance: float = 0.18,
                 listener_offsets: np.ndarray | None = None,
                 shared_state: bool = True,
                 mesh=None,
                 smooth_transfer: bool = False,
                 itd: bool = False,
                 compressed_maps: list[dict] | None = None,
                 use_compressed: bool = False,
                 seed: int = 0,
                 dtype: torch.dtype | None = None,
                 device: torch.device | str | None = None):
        """``binaural`` renders each logical object to two output channels
        (left and right ear) with an FFAT lookup per ear: interaural level
        differences from the transfer maps (the reference duplicates one
        mono signal to both channels, real_time_modal_sound.cpp:207-210).

        ``listener_offsets`` [L, 3] generalizes this to L listeners:
        listener l's transfer is looked up from ``listener + offsets[l]``
        and the mix has one output channel per listener. ``binaural`` is
        the L = 2 case with offsets +-ear_distance/2 along the ear axis.

        ``shared_state`` (the default): the L listeners share one [O, M]
        oscillator state with [L, O, M] transfer rows (sound is linear in
        the transfer, so a listener costs one more mode-reduce).
        ``shared_state=False`` keeps the replicated layout, each logical
        object copied into L solver rows (state, forces and tables L-fold,
        the same output).

        ``itd``: derive per-mode interaural time differences from the
        listener geometry on every move (complex transfer rows; exact for
        each narrowband mode). Needs shared-state listener rows; composes
        with ``smooth_transfer`` (the ramp moves both channels).

        ``compressed_maps``: the second, compressed Psi texture of each
        model (the reference's useCompressed set, modal_solver.h:84-98),
        one map dict per model of ``models`` (the instances' distinct
        models in order of first use), carried beside the raw texture;
        ``use_compressed`` makes listener lookups read it from the start
        (session.set_use_compressed toggles it later).

        ``seed`` keys the session's sustained-contact noise.

        ``mesh`` (a parallel.sharding.Mesh) makes a multi-device scene:
        the same construction surface with a ShardedSession underneath,
        its object and mode axes split over the mesh's cells.

        ``dtype`` None is float32; ``device`` None is the CUDA device
        (device.resolve_device)."""
        from ..ops.coeffs import build_modal_bank, lambda_from_modes
        from ..ops.ffat import build_ffat, build_ffat_hetero
        from ..runtime.session import ModalSession
        from ..runtime.solver import SolverConfig

        if not instances:
            raise ValueError("scene needs at least one instance")
        dtype = dtype or torch.float32
        device = resolve_device(device)
        self.binaural = binaural
        self.ear_distance = ear_distance
        self.logical_instances = instances
        if binaural and listener_offsets is not None:
            raise ValueError("pass either binaural or listener_offsets")
        self._offsets = (np.asarray(listener_offsets, np.float64)
                         if listener_offsets is not None else None)
        self.num_listeners = (2 if binaural
                              else (len(self._offsets)
                                    if self._offsets is not None else 1))
        self.shared_state = shared_state and self.num_listeners > 1
        if self.num_listeners > 1 and not self.shared_state:
            # row i*L + l = listener l's copy of logical object i
            instances = [inst for inst in instances
                         for _ in range(self.num_listeners)]
        self.instances = instances
        # the distinct models in order of first use: compressed_maps[k]
        # belongs to models[k]
        self.models = list({id(inst.model): inst.model
                            for inst in instances}.values())
        if (compressed_maps is not None
                and len(compressed_maps) != len(self.models)):
            raise ValueError(f"compressed_maps holds {len(compressed_maps)} "
                             f"map dicts for {len(self.models)} models")
        o = len(instances)
        m_max = max(inst.model.num_modes_audible for inst in instances)

        lam = np.zeros((o, m_max), np.complex128)
        b = np.zeros((o, m_max), np.complex128)
        valid = np.zeros((o, m_max), bool)
        for i, inst in enumerate(instances):
            mdl = inst.model
            n = mdl.num_modes_audible
            li, bi, vi = lambda_from_modes(
                mdl.material.density, mdl.modes.omega_squared[:n],
                mdl.material.alpha, mdl.material.beta)
            lam[i, :n] = li
            b[i, :n] = bi
            valid[i, :n] = vi
        shared = all(inst.model is instances[0].model for inst in instances)
        # a mesh's bank is built on the CPU and reaches the cards only as
        # the ShardedSession's shards
        self.bank = build_modal_bank(lam, b, valid, block_size=block_size,
                                     shared=shared, dtype=dtype,
                                     device=device if mesh is None
                                     else "cpu")

        ffat = None
        if use_ffat and any(inst.model.ffat_maps for inst in instances):
            comp = None
            if compressed_maps is not None:
                of = {id(mdl): c for mdl, c in zip(self.models,
                                                   compressed_maps)}
                comp = [of[id(inst.model)] for inst in instances]
            if shared:
                ffat = build_ffat(instances[0].model.ffat_maps,
                                  self.bank.num_modes, dtype=dtype,
                                  device=device,
                                  compressed_maps=comp and comp[0])
            else:
                ffat = build_ffat_hetero(
                    [inst.model.ffat_maps for inst in instances],
                    self.bank.num_modes, dtype=dtype, device=device,
                    compressed_maps=comp)
        # the per-instance float64 eigenvalues enable the span dispatches
        # (shared banks are detected from identical rows)
        session_kw = dict(
            ffat=ffat,
            config=SolverConfig(block_size=block_size, backend=backend,
                                smooth_transfer=smooth_transfer),
            num_slots=num_slots, seed=seed, dtype=dtype,
            num_listeners=(self.num_listeners if self.shared_state else 1),
            lam64=lam)
        if mesh is not None:
            from ..parallel.session import ShardedSession
            self.session = ShardedSession(self.bank, mesh, **session_kw)
            self.bank = self.session.bank     # shape only: no data kept
        else:
            self.session = ModalSession(self.bank, **session_kw)

        self.positions = np.stack([np.asarray(i.position, np.float64)
                                   for i in instances])
        n_ch = self.num_listeners if self.num_listeners > 1 else 2
        gains = np.zeros((o, n_ch))
        for i, inst in enumerate(instances):
            if self.shared_state:
                # one row per logical object; every listener channel hears
                # it at the instance gain
                gains[i, :] = inst.gain
            elif self.num_listeners > 1:
                # each replicated row feeds only its listener's channel
                gains[i, i % self.num_listeners] = inst.gain
            else:
                left = inst.gain * (1.0 - max(inst.pan, 0.0))
                right = inst.gain * (1.0 + min(inst.pan, 0.0))
                gains[i] = (left, right)
        self._base_gains = gains
        self.session.gains = self._device_gains(gains)
        # the default binaural ear offsets (set_listener's ear_axis updates)
        ear = np.asarray((1.0, 0.0, 0.0)) * (self.ear_distance / 2)
        self._ear_offsets = np.stack([-ear, ear])
        if use_compressed:
            self.session.set_use_compressed(True)
        if itd:
            if not self.shared_state:
                raise ValueError("itd needs shared_state multi-listener "
                                 "rows (binaural or listener_offsets)")
            self.session.auto_itd = True
        # the engine's listener events go through the bare session; the
        # installed frame maps their world positions into the scene's
        # per-object relative coordinates (Scene.set_listener calls
        # set_listener_relative and bypasses it)
        self.session.listener_frame = self._listener_frame
        # the last world listener: move_object recomputes the relative rows
        # from it, so that live object motion is heard at once
        self._last_world_listener = None

    def _device_gains(self, gains: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(gains).to(dtype=self.session.gains.dtype,
                                         device=self.session.device)

    def _listener_frame(self, pos: np.ndarray) -> np.ndarray:
        """World listener(s) -> the session's relative frame.

        [3]: one world listener, expanded through the scene's offsets
        (binaural ears or listener_offsets). [L, 3] on a shared-state
        multi-listener scene: L independent world listeners (per-client
        serving), each row mapped to per-object relative positions
        directly, without the single head's offsets. Anything else passes
        through unchanged (rows that are already relative)."""
        pos = np.asarray(pos, np.float64)
        if pos.ndim == 1:
            # listener moves from the engine reach the scene only through
            # this frame, and object moves recompute rows from the value
            # kept here
            self._last_world_listener = pos.copy()
            return self._relative_rows(pos)
        if (pos.ndim == 2 and self.shared_state
                and pos.shape == (self.num_listeners, 3)):
            self._last_world_listener = pos.copy()
            return pos[:, None, :] - self.positions[None, :, :]
        return pos

    def _relative_rows(self, world_pos: np.ndarray) -> np.ndarray:
        """One world position -> per-object relative rows ([O, 3], or
        [L, O, 3] for shared-state multi-listener scenes)."""
        if self.num_listeners > 1:
            offsets = self._ear_offsets if self.binaural else self._offsets
            if self.shared_state:
                return ((world_pos[None, None, :] + offsets[:, None, :])
                        - self.positions[None, :, :])
            rows = np.arange(len(self.instances)) % self.num_listeners
            return (world_pos[None, :] + offsets[rows]) - self.positions
        return world_pos[None, :] - self.positions

    # ------------------------------------------------------------------ API

    @property
    def num_objects(self) -> int:
        return len(self.instances)

    def hit(self, index: int, vertex: int, **kw) -> None:
        """Strike logical instance ``index`` at mesh vertex ``vertex``."""
        ll = self.num_listeners
        if ll > 1 and not self.shared_state:
            space = self.logical_instances[index].model.modal_force_vertex(
                vertex)
            for l in range(ll):
                self.session.hit(ll * index + l, space, **kw)
        else:
            space = self.instances[index].model.modal_force_vertex(vertex)
            self.session.hit(index, space, **kw)

    def set_listener(self, world_pos: np.ndarray,
                     distance_attenuation: bool = False,
                     ear_axis=(1.0, 0.0, 0.0)) -> None:
        """One world listener -> per-object relative transfer lookups.

        In binaural mode each logical object's two rows look the maps up
        from the left and right ear (listener +- ear_distance/2 along
        ``ear_axis``). ``distance_attenuation`` scales the gains by 1/r
        (per object and channel with listener rows); without it the base
        gains come back, so no 1/r of an earlier position stays."""
        world_pos = np.asarray(world_pos, np.float64)
        self._last_world_listener = world_pos.copy()
        if self.binaural:
            ear = np.asarray(ear_axis, np.float64)
            ear = ear / np.linalg.norm(ear) * (self.ear_distance / 2)
            self._ear_offsets = np.stack([-ear, ear])
        rel = self._relative_rows(world_pos)
        self.session.set_listener_relative(rel)
        if distance_attenuation:
            r = np.maximum(np.linalg.norm(rel, axis=-1), 1e-3)
            # replicated or single: r [O] -> a per-row column; shared-state
            # listener rows: r [L, O] -> per-(object, channel) factors
            att = (1.0 / r.T) if r.ndim == 2 else (1.0 / r)[:, None]
            self.session.gains = self._device_gains(self._base_gains * att)
        else:
            self.session.gains = self._device_gains(self._base_gains)

    def set_object_position(self, index: int, world_pos: np.ndarray) -> None:
        """Host-only position update (no transfer recompute): safe from any
        thread; the next listener (re)apply, for example one queued to the
        engine (it runs on the synthesis thread), picks the new position
        up through the installed listener_frame."""
        ll = self.num_listeners
        pos = np.asarray(world_pos, np.float64)
        if ll > 1 and not self.shared_state:
            # replicated layout: logical object i owns rows i*L..i*L+L-1
            n_logical = len(self.instances) // ll
            if not 0 <= index < n_logical:
                raise IndexError(f"object {index} out of range "
                                 f"[0, {n_logical})")
            self.positions[ll * index: ll * (index + 1)] = pos
        else:
            if not 0 <= index < len(self.positions):
                raise IndexError(f"object {index} out of range "
                                 f"[0, {len(self.positions)})")
            self.positions[index] = pos

    def object_position(self, index: int) -> np.ndarray:
        """The world position of logical object ``index`` (a copy), with
        set_object_position's indexing."""
        ll = self.num_listeners
        if ll > 1 and not self.shared_state:
            n_logical = len(self.instances) // ll
            if not 0 <= index < n_logical:
                raise IndexError(f"object {index} out of range "
                                 f"[0, {n_logical})")
            return self.positions[ll * index].copy()
        if not 0 <= index < len(self.positions):
            raise IndexError(f"object {index} out of range "
                             f"[0, {len(self.positions)})")
        return self.positions[index].copy()

    def move_object(self, index: int, world_pos: np.ndarray) -> None:
        """Move logical object ``index`` live (the reference has no object
        motion): the transfer rows recompute from the last world listener,
        so the next block hears the object at its new place. Pair with
        DopplerPostMix.set_position for live object Doppler."""
        self.set_object_position(index, world_pos)
        lw = self._last_world_listener
        if lw is not None:
            if np.asarray(lw).ndim == 2:
                # per-client serving recorded [L, 3] world rows: reapply
                # through the frame (Scene.set_listener is single-head)
                self.session.set_listener(lw)
            else:
                self.set_listener(lw)

    def step(self):
        return self.session.step()

    def render(self, num_blocks: int) -> np.ndarray:
        return self.session.render(num_blocks)

    def render_multi(self, num_blocks: int, **kw) -> np.ndarray:
        return self.session.render_multi(num_blocks, **kw)

    def _relative_path(self, listener_path, object_paths):
        """World listener path [T, 3] (and optionally per-block object world
        positions [T, O, 3]) -> listener-relative [T, O, 3], or
        [T, L, O, 3] for shared-state multi-listener scenes (each
        listener's offset applied per row, as _relative_rows does)."""
        listener_path = np.asarray(listener_path, np.float64)
        if listener_path.ndim != 2 or listener_path.shape[1] != 3:
            raise ValueError("listener_path must be [T, 3] world positions")
        t = listener_path.shape[0]
        if object_paths is None:
            obj = np.broadcast_to(self.positions[None, :, :],
                                  (t, len(self.instances), 3))
        else:
            obj = np.asarray(object_paths, np.float64)
            if obj.shape != (t, len(self.instances), 3):
                raise ValueError(
                    f"object_paths must be [T={t}, O="
                    f"{len(self.instances)}, 3], got {obj.shape}")
        if self.num_listeners > 1:
            offsets = self._ear_offsets if self.binaural else self._offsets
            if self.shared_state:
                return (listener_path[:, None, None, :]
                        + offsets[None, :, None, :]) - obj[:, None, :, :]
            rows = np.arange(len(self.instances)) % self.num_listeners
            return (listener_path[:, None, :] + offsets[rows][None]) - obj
        return listener_path[:, None, :] - obj

    def render_moving(self, listener_path: np.ndarray,
                      object_paths: np.ndarray | None = None,
                      **kw) -> np.ndarray:
        """Moving-listener (and optionally moving-object) render: world
        positions per block -> per-object relative transfer schedules
        (session.render_moving). Row t of ``listener_path`` [T, 3] is the
        listener during block t; ``object_paths`` [T, O, 3] moves the
        objects too. Multi-listener scenes move every listener along the
        path with its offset held, one output channel each."""
        rel = self._relative_path(listener_path, object_paths)
        return self.session.render_moving(rel, **kw)

    def render_doppler(self, listener_path: np.ndarray,
                       object_paths: np.ndarray | None = None,
                       **kw) -> np.ndarray:
        """render_moving plus the physical propagation delay r(t)/c of each
        object (session.render_doppler): moving listeners and moving
        objects get the Doppler shift of their radial velocities.
        Multi-listener scenes return one Doppler-delayed channel per
        listener, each following its own distances."""
        rel = self._relative_path(listener_path, object_paths)
        return self.session.render_doppler(rel, **kw)
