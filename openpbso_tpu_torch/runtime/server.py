"""Network audio server — the serving deployment surface.

Counterpart of openpbso_tpu/runtime/server.py, with the same wire contract.
The reference couples synthesis to a local PortAudio device; a production
deployment serves synthesized audio to remote clients instead. This module
streams the engine's output over TCP:

- client -> server: newline-delimited JSON commands, the same event surface
  as the interactive CLI::

    {"cmd": "hit", "obj": 0, "vertex": 12, "kind": "gaussian",
     "width_us": 200.0}
    {"cmd": "hit_space", "obj": 0, "space": [..]}   (raw modal amplitudes)
    {"cmd": "listener", "pos": [x, y, z]}
    {"cmd": "sustain", "obj": 0, "vertex": 3} / {"cmd": "release", "obj": 0}
    {"cmd": "arparam", "obj": 0, "a": [a1, a2], "sigma": s, "mu": m}
    {"cmd": "clear"} / {"cmd": "stats"} / {"cmd": "quit"}
    {"cmd": "load_model", "meta": "path/to/model.meta"}   (hot swap)
    {"cmd": "object_pos", "obj": i, "pos": [x, y, z]}     (scene serving)
    {"cmd": "object_vel", "obj": i, "vel": [vx, vy, vz]}  (continuous
        object motion: the server integrates the position — the Doppler
        post-mix on the audio clock, the scene's transfer refresh on a
        slow wall-clock ticker — until a zero-velocity event stops it)

  load_model resolves a server-side .meta descriptor and hot-swaps the
  live stream to the new model (the reference's LoadNewModel over the
  wire); it is only honored when the server was constructed with a
  ``session_loader``, since it reads files named by the client.

- server -> client: a 16-byte header (``PBSO`` + uint32 sample_rate +
  uint32 channels + uint32 block_size), then length-prefixed raw
  little-endian float32 stereo blocks as they are synthesized. JSON
  replies (stats, errors) interleave in-band with the sentinel length
  0xFFFFFFFF followed by their own length + payload.

``AudioServer`` serves one client at a time (a fresh engine per
connection). ``BroadcastAudioServer`` fans ONE engine's stream out to many
concurrent clients — the many-listener deployment shape of a 256-object
scene; each client has a bounded PCM queue so a slow client drops
blocks instead of stalling the shared synthesis stream.

The device is touched in two places only, both off the synthesis thread
and both small: the transfer-ball HUD's per-vertex transfer matrix (one
``compute_transfer`` on the session's device, copied to the host once and
cached) and the transfer histogram (one [M] row indexed on the device,
then copied). Everything else is host work on numpy arrays and the
engine's event queues.
"""
from __future__ import annotations

import json
import queue
import socket
import struct
import threading
import time

import numpy as np

from ..config import SAMPLE_RATE

MAGIC = b"PBSO"
JSON_MARKER = 0xFFFFFFFF


class RealTimePacer:
    """Sleep writes onto the sample-rate clock plus a small lead.

    Shared by every broadcast/streaming sink that has no blocking audio
    device downstream (server._FanoutSink, wsbridge._WSSink): this plays
    the role the reference's blocking PortAudio callback played
    (PaModalCallback pulls one block per ~11.6 ms,
    real_time_modal_sound.cpp:192-212); the engine's capacity-2 sound
    queue then paces the synth thread like the reference's spin-enqueue
    (modal_solver.h:275). ``pace_lead=None`` disables pacing.
    """

    def __init__(self, pace_lead: float | None = 0.3):
        self._pace_lead = pace_lead
        self._t0: float | None = None
        self._samples = 0

    def pace(self, n_samples: int) -> None:
        if self._pace_lead is None:
            return
        import time as _time
        now = _time.monotonic()
        if self._t0 is None:
            self._t0 = now
        due = self._t0 + self._samples / SAMPLE_RATE - self._pace_lead
        if due > now:
            _time.sleep(due - now)
        self._samples += int(n_samples)


class _SocketSink:
    """Audio sink that writes framed PCM to a connected socket."""

    def __init__(self, conn: socket.socket, block_size: int,
                 send_timeout: float = 30.0, channels: int = 2):
        self._conn = conn
        # a client that stops reading must not wedge the consume thread
        # (and thereby engine.stop) forever: bound every send
        conn.settimeout(send_timeout)
        self._lock = threading.Lock()
        self.closed = False
        header = MAGIC + struct.pack("<III", SAMPLE_RATE, channels,
                                     block_size)
        conn.sendall(header)

    def write(self, block: np.ndarray) -> bool:
        data = np.ascontiguousarray(block, "<f4").tobytes()
        try:
            with self._lock:
                self._conn.sendall(struct.pack("<I", len(data)) + data)
            return True
        except (OSError, socket.timeout):
            self.closed = True
            return False

    def send_json(self, obj) -> None:
        payload = json.dumps(obj).encode()
        try:
            with self._lock:
                self._conn.sendall(struct.pack("<II", JSON_MARKER,
                                               len(payload)) + payload)
        except (OSError, socket.timeout):
            self.closed = True

    def close(self) -> None:
        try:
            self._conn.shutdown(socket.SHUT_WR)
        except OSError:
            pass


class _MotionTicker(threading.Thread):
    """Server-side kinematics for ``object_vel`` (continuous object motion).

    The perceptually dominant term of a moving object — the Doppler delay
    ramp — is integrated by DopplerPostMix itself on the AUDIO clock (one
    position step per dispatch, ops/doppler.py). This thread handles the
    slower term: the scene's transfer-amplitude refresh, by re-applying
    ``_apply_object_pos`` at a modest wall-clock rate (default 4 Hz — the
    same order as a human drag, and each tick costs one latest-wins
    listener event exactly like a mouse move). When a Doppler post-mix is
    present the tick reads the position IT integrated (audio clock is the
    source of truth — no double integration, no fighting); without one it
    integrates on the wall clock itself.

    Beyond-reference: the reference's single object never moves
    (real_time_modal_sound.cpp keeps one static mesh); object kinematics
    exist only here.
    """

    def __init__(self, server, get_engine, rate_hz: float = 4.0):
        super().__init__(daemon=True, name="pbso-motion")
        self._server = server
        self._get_engine = get_engine   # callable: survives engine restarts
        self._period = 1.0 / float(rate_hz)
        self._stop_evt = threading.Event()
        self._vel: dict[int, np.ndarray] = {}
        self._lock = threading.Lock()

    def set_velocity(self, obj: int, vel) -> None:
        vel = np.asarray(vel, np.float64).reshape(3)
        with self._lock:
            if vel.any():
                self._vel[int(obj)] = vel
            else:
                self._vel.pop(int(obj), None)

    @property
    def moving(self) -> list[int]:
        with self._lock:
            return sorted(self._vel)

    def stop(self) -> None:
        self._stop_evt.set()

    def run(self) -> None:
        last = time.monotonic()
        while not self._stop_evt.wait(self._period):
            now = time.monotonic()
            dt, last = now - last, now
            with self._lock:
                items = list(self._vel.items())
            if not items:
                continue
            engine = self._get_engine()
            srv = self._server
            if engine is None or srv._scene is None:
                continue
            pm = getattr(engine, "_post_mix", None)
            pm_integrates = pm is not None and hasattr(pm, "velocities")
            try:
                for obj, vel in items:
                    if pm_integrates:
                        if not np.array_equal(pm.velocities[obj], vel):
                            # re-push after an engine restart rebuilt the
                            # post-mix (elastic recovery / bucket grow)
                            pm.set_velocity(obj, vel)
                        pos = np.asarray(pm.positions[obj], np.float64)
                    else:
                        pos = srv._scene.object_position(obj) + vel * dt
                    srv._apply_object_pos(engine, obj, pos,
                                          retarget_pm=not pm_integrates)
            except Exception:  # noqa: BLE001 — engine mid-restart etc.
                continue       # next tick retries against the new engine


class AudioServer:
    """Serve one engine over TCP. Use serve_forever() or serve_one()."""

    # single-client servers run one _MotionTicker per connection (stopped
    # when the connection ends); broadcast servers keep ONE for the shared
    # engine's lifetime (see _stop_motion_ticker)
    _motion_persistent = False

    def __init__(self, make_session, model=None, host: str = "127.0.0.1",
                 port: int = 0, lookahead: int = 1, session_loader=None,
                 qnorm_every: int = 0, positions=None, scene=None,
                 post_mix_factory=None, motion_rate_hz: float = 4.0):
        """``make_session()`` -> a fresh ModalSession per connection;
        ``model`` (optional) enables vertex/face-addressed hits and the
        scene/mode-shape viewer commands — pass a LIST of per-object-row
        models for multi-model scenes (models/scene.py: commands carrying
        an ``obj`` index then address that row's mesh/modes);
        ``session_loader(meta_path)`` ->
        (model, session) enables the ``load_model`` hot-swap command (off
        by default: it opens server-side files named by the client);
        ``qnorm_every`` > 0 streams per-mode energy telemetry (the
        transfer-ball HUD feed) every that many blocks; ``scene`` (the
        models.scene.Scene behind the served session) enables the
        ``object_pos`` live object-motion command; ``motion_rate_hz`` is
        the wall-clock rate of the ``object_vel`` transfer-refresh ticker
        (the Doppler delay itself integrates per dispatch, not here)."""
        self._make_session = make_session
        self._model = model
        # per-object-row world positions (scene serving): lets the browser
        # draw each object where it stands
        self._positions = positions
        self._scene = scene
        self._post_mix_factory = post_mix_factory
        self._motion_rate = float(motion_rate_hz)
        self._motion: _MotionTicker | None = None
        # two rx threads sending object_vel concurrently must not each
        # start a ticker (both would integrate positions -> 2x velocity)
        self._motion_lock = threading.Lock()
        self._session_loader = session_loader
        self._lookahead = lookahead
        self._qnorm_every = qnorm_every
        self._ball_mesh = (None, None)
        self._ball_transfer = None
        self._sock = socket.create_server((host, port))
        self.address = self._sock.getsockname()

    def serve_one(self, timeout: float | None = None) -> None:
        """Accept a single client, stream until it quits/disconnects."""
        self._sock.settimeout(timeout)
        conn, _ = self._sock.accept()
        conn.settimeout(None)
        try:
            self._handle(conn)
        finally:
            conn.close()

    def serve_forever(self) -> None:
        while True:
            try:
                self.serve_one()
            except OSError:
                return  # listening socket closed (shutdown)
            except Exception:  # noqa: BLE001 — per-connection guard
                # no single client's error may take down the listener; the
                # failed connection was already closed by serve_one
                continue

    def close(self) -> None:
        self._stop_motion_ticker(force=True)
        try:
            # wakes an accept() blocked in serve_forever (close alone
            # does not), so the serving thread ends with the server
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()

    # ------------------------------------------------------------------

    def _handle(self, conn: socket.socket) -> None:
        from .engine import StreamingEngine
        session = self._make_session()
        block = session.config.block_size
        sink = _SocketSink(conn, block,
                           channels=int(session.gains.shape[-1]))
        engine = StreamingEngine(
            session, sink, lookahead=self._lookahead,
            qnorm_every=self._qnorm_every,
            post_mix=(self._post_mix_factory()
                      if self._post_mix_factory else None))
        engine.start()
        try:
            buf = b""
            # one shared socket timeout bounds BOTH recv (so engine/sink
            # health is re-checked periodically) and the sink's sends (so a
            # non-draining client cannot wedge the consume thread)
            conn.settimeout(5.0)
            while not sink.closed and engine.healthy:
                try:
                    chunk = conn.recv(4096)
                except socket.timeout:
                    continue
                except OSError:
                    # client reset/abort: end THIS connection only — if it
                    # propagated, serve_forever's OSError clause (meant for
                    # the closed LISTENING socket) would kill the server
                    break
                if not chunk:
                    break
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if not line.strip():
                        continue
                    if self._dispatch(engine, sink, line):
                        return
            if not engine.healthy and engine.error is not None:
                sink.send_json({"error": f"synthesis failed: "
                                         f"{engine.error!r}"})
        finally:
            self._stop_motion_ticker()   # per-connection kinematics
            engine.stop()

    def _ensure_motion_ticker(self, engine) -> _MotionTicker:
        """The object_vel kinematics thread (lazily started). Single-client
        servers bind it to THIS connection's engine; BroadcastAudioServer
        overrides the getter to track its persistent/restartable engine."""
        with self._motion_lock:
            if self._motion is None or not self._motion.is_alive():
                self._motion = _MotionTicker(self, lambda: engine,
                                             rate_hz=self._motion_rate)
                self._motion.start()
            return self._motion

    def _stop_motion_ticker(self, force: bool = False) -> None:
        """Connection teardown: stop a per-connection ticker. Persistent
        (broadcast) tickers survive client churn; only close() forces
        them down."""
        if self._motion is not None and (force or not
                                         self._motion_persistent):
            self._motion.stop()
            self._motion = None

    def _apply_object_pos(self, engine, i: int, pos, *,
                          retarget_pm: bool = True) -> list:
        """Move scene object ``i``: host position update + Doppler delay
        retarget + a queued listener re-apply so the transfer rows
        recompute ON THE SYNTH THREAD with the new position (no state race
        with the streaming loop). Shared by the object_pos command and the
        _MotionTicker. ``retarget_pm=False`` skips the post-mix when it is
        integrating the motion itself (audio-clock source of truth)."""
        pos = np.asarray(pos, np.float64).reshape(3)
        self._scene.set_object_position(i, pos)
        if self._positions is not None and i < len(self._positions):
            self._positions[i] = [float(v) for v in pos]
        if retarget_pm:
            pm = getattr(engine, "_post_mix", None)
            if pm is not None and hasattr(pm, "set_position"):
                pm.set_position(i, pos)   # object Doppler retarget
        lw = getattr(self._scene, "_last_world_listener", None)
        if lw is not None:
            engine.set_listener(np.asarray(lw, np.float64))
        return pos.tolist()

    def _model_for(self, obj: int):
        """The mesh/modes model behind session object row ``obj``."""
        if isinstance(self._model, (list, tuple)):
            if not 0 <= obj < len(self._model):
                raise IndexError(
                    f"object {obj} out of range [0, {len(self._model)})")
            return self._model[obj]
        return self._model

    def _space_for(self, msg) -> np.ndarray:
        if "space" in msg:
            return np.asarray(msg["space"], np.float64)
        model = self._model_for(int(msg.get("obj", 0)))
        if model is None:
            raise ValueError("vertex/face-addressed commands need a model")
        if "face" in msg:
            return self._face_space(msg)
        return model.modal_force_vertex(int(msg["vertex"]))

    def _face_space(self, msg) -> np.ndarray:
        """Barycentric face hit: the browser ray-pick flow
        (GetModalForceFace, real_time_modal_sound.cpp:236-266 — one shared
        face normal for all three corners)."""
        m = self._model_for(int(msg.get("obj", 0)))
        f = int(msg["face"])
        if not 0 <= f < m.faces.shape[0]:
            raise IndexError(f"face {f} out of range [0, {m.faces.shape[0]})")
        bary = np.asarray(msg.get("bary", (1 / 3.0,) * 3), np.float64)
        if bary.shape != (3,):
            raise ValueError("bary must be 3 barycentric weights")
        vids = m.faces[f]
        v = m.vertices
        n = np.cross(v[vids[1]] - v[vids[0]], v[vids[2]] - v[vids[0]])
        norm = np.linalg.norm(n)
        n = n / norm if norm > 0 else m.normals[vids[0]]
        return m.modal_force_face(vids, bary, n)

    def _scene_payload(self, msg=None) -> dict:
        """Mesh + metadata for the browser viewer (the reference renders
        the .tet.obj in its libigl viewport, real_time_modal_sound.cpp
        :508-509; a headless deployment streams it to the client
        instead)."""
        m = self._model_for(int(msg.get("obj", 0)) if msg else 0)
        if m is None:
            raise ValueError("scene command needs a model")
        obj = int(msg.get("obj", 0)) if msg else 0
        pos = (list(np.asarray(self._positions[obj], np.float64))
               if self._positions is not None and obj < len(self._positions)
               else [0.0, 0.0, 0.0])
        return {"scene": {
            "obj": obj,
            "position": pos,
            "vertices": np.asarray(m.vertices, np.float32).ravel().tolist(),
            "faces": np.asarray(m.faces, np.int32).ravel().tolist(),
            "normals": np.asarray(m.normals, np.float32).ravel().tolist(),
            "modes_audible": int(m.num_modes_audible),
        }}

    def _mode_shape_payload(self, msg) -> dict:
        """Per-vertex displacement of one mode for the client-side
        mode-shape animation viewer (ModalViewer::UpdateModeShape,
        real_time_modal_sound.cpp:133-148, 855-884: the client renders
        v + scale * U_mode * cos(omega t))."""
        m = self._model_for(int(msg.get("obj", 0)))
        if m is None:
            raise ValueError("mode_shape command needs a model")
        k = int(msg.get("mode", 0))
        if not 0 <= k < m.num_modes_audible:
            raise IndexError(
                f"mode {k} out of range [0, {m.num_modes_audible})")
        disp = np.asarray(m.modes.modes[k], np.float32)
        freq = float(np.sqrt(m.modes.omega_squared[k]
                             / m.material.density) / (2 * np.pi))
        return {"mode_shape": {"mode": k, "freq_hz": freq,
                               "obj": int(msg.get("obj", 0)),
                               "disp": disp.ravel().tolist()}}

    def _ball_payload(self, engine, subdivisions: int = 2) -> dict:
        """Icosphere mesh + cached per-vertex transfer matrix for the
        transfer-ball HUD (real_time_modal_sound.cpp:897, 917-927: ball
        vertex v colored by log10(qnorm . transfer(v)) each frame).
        Colors stream separately as qnorm telemetry arrives."""
        from ..io.objmesh import icosphere
        v, f = self._ball_mesh
        if v is None:
            v, f = icosphere(subdivisions, 1.0)
            self._ball_mesh = (v, f)
        if self._ball_transfer is None and engine.session.ffat is not None \
                and not isinstance(self._model, (list, tuple)):
            # multi-model scenes have per-object FFATs; the single-ball
            # HUD is a one-model visualization (colors stay absent)
            import torch

            from ..ops.ffat import compute_transfer
            sess = engine.session
            self._ball_transfer = compute_transfer(
                sess.ffat, torch.as_tensor(
                    np.asarray(v, np.float32),
                    device=sess.device)).cpu().numpy()
        return {"ball": {
            "vertices": np.asarray(v, np.float32).ravel().tolist(),
            "faces": np.asarray(f, np.int32).ravel().tolist(),
            "has_transfer": self._ball_transfer is not None,
        }}

    def _transfer_hist_payload(self, engine, msg=None) -> dict:
        """Per-mode transfer magnitudes for the HUD histogram panel.

        The reference plots |transfer| per mode next to the FFAT
        compressed toggle (ImGui PlotHistogram,
        real_time_modal_sound.cpp:832-853). Values come from the LIVE
        state row (so the toggle/listener moves show immediately); mode
        frequencies ride along for the axis labels.
        """
        sess = engine.session
        obj = int(msg.get("obj", 0)) if msg else 0
        if not 0 <= obj < sess.bank.num_objects:
            raise IndexError(f"object {obj} out of range "
                             f"[0, {sess.bank.num_objects})")
        # one reference to the live rows (the synthesis thread replaces
        # state, never writes these rows in place); the row is indexed on
        # the device and only its [M] values are copied
        state = sess.state
        t = state.transfer
        listener = int(msg.get("listener", 0)) if msg else 0
        if t.ndim == 3:                       # [L, O, M] multi-listener
            # explicit bounds check like obj: Python negative indexing
            # would silently wrap a wire-supplied negative listener to
            # another client's row
            if not 0 <= listener < t.shape[0]:
                raise IndexError(f"listener {listener} out of range "
                                 f"[0, {t.shape[0]})")
            t = t[listener]
        row = t[obj].cpu().numpy().astype(np.float64)
        if state.transfer_im is not None:
            ti = state.transfer_im
            if ti.ndim == 3:
                ti = ti[listener]
            row = np.hypot(row, ti[obj].cpu().numpy().astype(np.float64))
            #   complex rows: magnitude
        m = self._model_for(obj) if self._model is not None else None
        n = (int(m.num_modes_audible) if m is not None
             else int(sess.bank.num_modes))
        out = {"obj": obj, "values": row[:n].tolist(),
               "compressed": bool(getattr(sess, "use_compressed", False)),
               "transfer_on": bool(sess.use_transfer)}
        if m is not None:
            freqs = np.sqrt(m.modes.omega_squared[:n]
                            / m.material.density) / (2 * np.pi)
            out["freqs_hz"] = freqs.tolist()
        return {"transfer_hist": out}

    def ball_colors(self, qnorm: np.ndarray) -> np.ndarray | None:
        """log10(qnorm . transfer) per ball vertex (the reference's live
        HUD coloring, real_time_modal_sound.cpp:960-979)."""
        if self._ball_transfer is None:
            return None
        w = np.asarray(qnorm, np.float64)
        if w.ndim == 2:
            w = w.sum(axis=0)
        t = self._ball_transfer
        vals = t[:, : w.shape[0]] @ w[: t.shape[1]]
        return np.log10(np.maximum(vals, 1e-30))

    def _dispatch(self, engine, sink, line: bytes,
                  msg: dict | None = None) -> bool:
        """Apply one command; returns True on quit. ``msg`` is the
        already-parsed JSON when the caller pre-parsed it (the per-client
        route helper) — one parse per command, not two."""
        try:
            if msg is None:
                msg = json.loads(line)
            cmd = msg.get("cmd")
            if cmd == "quit":
                return True
            elif cmd in ("hit", "hit_space"):
                engine.hit(int(msg.get("obj", 0)), self._space_for(msg),
                           kind=msg.get("kind", "point"),
                           width_us=float(msg.get("width_us", 100.0)),
                           amp=float(msg.get("amp", 1.0)))
            elif cmd == "listener":
                engine.set_listener(np.asarray(msg["pos"], np.float64))
            elif cmd == "object_pos":
                # live object motion (scene serving): the position update
                # is host-only; the transfer refresh rides the engine's
                # latest-wins listener event, so the recompute happens on
                # the synthesis thread with the NEW position (no state
                # race with the streaming loop). Beyond-reference: the
                # reference's one object never moves.
                if self._scene is None:
                    sink.send_json({"error": "object_pos needs scene "
                                             "serving (pass scene=...)"})
                else:
                    i = int(msg.get("obj", 0))
                    pos = self._apply_object_pos(engine, i, msg["pos"])
                    sink.send_json({"object_pos": {"obj": i, "pos": pos}})
            elif cmd == "object_vel":
                # continuous object motion: one event sets a world
                # velocity; the server integrates from there (Doppler
                # delay on the audio clock in DopplerPostMix, transfer
                # refresh on the _MotionTicker). vel [0,0,0] stops.
                # Beyond-reference: the reference has no object
                # kinematics at all (its one mesh is static).
                if self._scene is None:
                    sink.send_json({"error": "object_vel needs scene "
                                             "serving (pass scene=...)"})
                else:
                    i = int(msg.get("obj", 0))
                    self._scene.object_position(i)   # bounds check NOW —
                    #   the ticker thread must never see a bad index
                    vel = np.asarray(msg.get("vel", (0.0, 0.0, 0.0)),
                                     np.float64).reshape(3)
                    if "pos" in msg:   # optional teleport-then-move
                        self._apply_object_pos(engine, i, msg["pos"])
                    pm = getattr(engine, "_post_mix", None)
                    if pm is not None and hasattr(pm, "set_velocity"):
                        pm.set_velocity(i, vel)
                    self._ensure_motion_ticker(engine).set_velocity(i, vel)
                    if not vel.any():
                        # final resync so the stopped position is exact
                        # (the ticker may have been mid-period). Use the
                        # post-mix's positions only when IT integrates the
                        # kinematics (hasattr velocities — the same
                        # predicate as pm_integrates); a static-position
                        # post-mix (e.g. HRTF FIR centers) must not
                        # teleport the scene object back to startup
                        src = (np.asarray(pm.positions[i], np.float64)
                               if pm is not None
                               and hasattr(pm, "velocities")
                               else self._scene.object_position(i))
                        self._apply_object_pos(engine, i, src,
                                               retarget_pm=False)
                    sink.send_json({"object_vel": {"obj": i,
                                                   "vel": vel.tolist()}})
            elif cmd == "sustain":
                engine.sustained_start(int(msg.get("obj", 0)),
                                       self._space_for(msg))
            elif cmd == "drag":
                # mouse-velocity sustained drag: each client frame live-
                # updates the single sustained force's spatial pattern,
                # scaled by the normalized mouse speed (the reference's
                # callback_post_draw flow, real_time_modal_sound.cpp
                # :1126-1160)
                vel = float(msg.get("vel", 1.0))
                engine.sustained_update(int(msg.get("obj", 0)),
                                        self._space_for(msg) * vel)
            elif cmd == "release":
                engine.sustained_end(int(msg.get("obj", 0)))
            elif cmd == "scene":
                sink.send_json(self._scene_payload(msg))
            elif cmd == "mode_shape":
                sink.send_json(self._mode_shape_payload(msg))
            elif cmd == "ball":
                sink.send_json(self._ball_payload(engine))
            elif cmd == "transfer_hist":
                sink.send_json(self._transfer_hist_payload(engine, msg))
            elif cmd == "arparam":
                engine.set_ar_params(int(msg.get("obj", 0)),
                                     tuple(msg.get("a", (0.783, 0.116))),
                                     float(msg.get("sigma", 0.00148)),
                                     float(msg.get("mu", 0.142)))
            elif cmd == "clear":
                engine.clear_forces()
            elif cmd == "transfer":
                # {"cmd": "transfer", "on": bool} toggles FFAT vs unit
                # transfer (modal_solver.h:249-255);
                # {"cmd": "transfer", "compressed": bool} selects the
                # compressed Psi texture per query — the reference's
                # useCompressed flag (modal_solver.h:84-98, ImGui toggle
                # real_time_modal_sound.cpp:835-853)
                sess = engine.session
                on = msg.get("on")
                comp = msg.get("compressed")

                def _toggle(s, on=on, comp=comp):
                    if on is not None:
                        s.set_use_transfer(bool(on))
                    if comp is not None:
                        s.set_use_compressed(bool(comp))

                # session.state is owned by the synthesis thread: run the
                # toggle there and wait (a direct call from this rx
                # thread could lose the new state to a concurrent block
                # assignment). Validation errors (e.g. no compressed Psi
                # set) re-raise here and become the error reply below.
                if engine.control(_toggle):
                    sink.send_json({"transfer": bool(sess.use_transfer),
                                    "compressed":
                                        bool(sess.use_compressed)})
                else:
                    sink.send_json({"error": "transfer toggle not "
                                             "applied (synthesis "
                                             "stalled)"})
            elif cmd == "load_model":
                # live hot-swap (the reference's LoadNewModel flow,
                # real_time_modal_sound.cpp:347-474, served over the wire)
                if self._session_loader is None:
                    sink.send_json({"error": "load_model is not enabled "
                                             "on this server"})
                else:
                    from .checkpoint import swap_model
                    model, new_sess = self._session_loader(str(msg["meta"]))
                    # the PCM framing (channels, block size) was fixed in
                    # the stream header at connect time; a swap must not
                    # change it mid-stream
                    if (int(new_sess.gains.shape[-1])
                            != int(engine.session.gains.shape[-1])
                            or new_sess.config.block_size
                            != engine.session.config.block_size):
                        sink.send_json({"error": "load_model: new model's "
                                        "channels/block differ from the "
                                        "active stream header"})
                        return False
                    new_sess.step()  # first use before parking the stream
                    self._begin_swap()
                    try:
                        swap_model(engine, new_sess)
                    finally:
                        self._end_swap()
                    self._model = model
                    self._ball_transfer = None  # new model, new FFAT
                    self._note_swap(str(msg["meta"]))
                    sink.send_json({
                        "loaded": str(msg["meta"]),
                        # bank width = the space-vector length hit_space
                        # expects (lane-padded); audible = the model's
                        # real mode count
                        "modes": int(new_sess.bank.num_modes),
                        "audible": (int(model.num_modes_audible)
                                    if model is not None else None),
                        "objects": int(new_sess.bank.num_objects),
                    })
            elif cmd == "stats":
                sink.send_json(self._stats_payload(engine))
            else:
                sink.send_json({"error": f"unknown cmd {cmd!r}"})
        except (KeyError, IndexError, ValueError, TypeError, OSError,
                json.JSONDecodeError) as e:
            # IndexError included: engine.hit / modal_force_vertex raise it
            # for out-of-range obj/vertex — a malformed client command must
            # never escape the per-connection handler
            sink.send_json({"error": str(e)})
        return False

    def _note_swap(self, meta_path: str) -> None:
        """Hook: a load_model hot-swap succeeded (see BroadcastAudioServer,
        whose engine-restart recipe must track the swapped model)."""

    def _begin_swap(self) -> None:
        """Hook: a hot-swap is about to park the engine (broadcast
        servers must not mistake the parked engine for a dead one)."""

    def _end_swap(self) -> None:
        """Hook: the hot-swap finished."""

    def _stats_payload(self, engine) -> dict:
        st = engine.profiler.stats()
        return {
            "health": engine.health.health,
            "blocks": engine._blocks_done,
            "p50_ms": st.p50_ms if st else None,
            "p99_ms": st.p99_ms if st else None,
        }


# ---------------------------------------------------------------------------
# broadcast (multi-client) serving
# ---------------------------------------------------------------------------


class _ClientStream:
    """One broadcast client: a bounded PCM queue drained by a writer thread.

    The fan-out hub enqueues every synthesized block; when a client cannot
    drain fast enough the OLDEST queued block is dropped (bounded latency,
    the shared stream never stalls — the per-client analog of the
    reference's stale-buffer replay, real_time_modal_sound.cpp:203-210).
    """

    def __init__(self, sink: _SocketSink, depth: int = 8,
                 channel: int | None = None):
        """``channel``: per-client listener routing — the engine mix is
        [S, L] (one column per listener row); this client receives its
        OWN column duplicated to stereo. None streams the full mix."""
        self.sink = sink
        self.dropped = 0
        self.channel = channel
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(target=self._drain,
                                        name="pbso-client-tx", daemon=True)
        self._thread.start()

    def offer(self, block: np.ndarray) -> None:
        while True:
            try:
                self._q.put_nowait(block)
                return
            except queue.Full:
                try:
                    self._q.get_nowait()
                    self.dropped += 1
                except queue.Empty:
                    pass

    def _drain(self) -> None:
        while not self.sink.closed:
            try:
                block = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            if self.channel is not None:
                # slice AFTER the queue: blocks enqueue by reference, so
                # the shared fan-out stores one array for all clients
                block = block[:, (self.channel, self.channel)]
            if not self.sink.write(block):
                return  # socket dead; sink.closed is now set

    def join(self, timeout: float = 5.0) -> None:
        self._thread.join(timeout=timeout)


class _FanoutSink:
    """Audio sink multiplexing one engine's stream to N client queues.

    Writes are paced to real time plus a small lead (``pace_lead``
    seconds): with no blocking audio device downstream, an unpaced engine
    would synthesize far ahead of real time and every client queue would
    drop almost everything. This is the role the reference's blocking
    PortAudio callback plays (real_time_modal_sound.cpp:192-212); the
    engine's capacity-2 sound queue then paces the synth thread like the
    reference's spin-enqueue (modal_solver.h:275).
    """

    def __init__(self, pace_lead: float | None = 0.3):
        self._lock = threading.Lock()
        self._clients: list[_ClientStream] = []
        self._pacer = RealTimePacer(pace_lead)

    def register(self, client: _ClientStream) -> None:
        with self._lock:
            self._clients.append(client)

    def unregister(self, client: _ClientStream) -> None:
        with self._lock:
            if client in self._clients:
                self._clients.remove(client)

    @property
    def n_clients(self) -> int:
        with self._lock:
            return len(self._clients)

    def write(self, block: np.ndarray) -> bool:
        self._pacer.pace(np.shape(block)[0])
        with self._lock:
            clients = list(self._clients)
        for c in clients:
            if c.sink.closed:
                self.unregister(c)
            else:
                c.offer(block)
        return True

    def broadcast_json(self, obj) -> None:
        """Best-effort JSON side-message to every connected client
        (telemetry: ball colors, health — not per-client replies)."""
        with self._lock:
            clients = list(self._clients)
        for c in clients:
            if not c.sink.closed:
                c.sink.send_json(obj)

    def close(self) -> None:
        """No-op: engines call sink.close() when they stop, but the hub
        OUTLIVES engines (BroadcastAudioServer._restart_engine swaps a
        dead engine without disconnecting clients). The server closes
        clients explicitly via shutdown()."""

    def shutdown(self) -> None:
        with self._lock:
            clients, self._clients = self._clients, []
        for c in clients:
            c.sink.close()


class BroadcastAudioServer(AudioServer):
    """One engine, many clients.

    The reference's deployment is one local listener per process; a GPU
    scene of hundreds of objects is naturally a shared world that many
    listeners observe, so the serving surface must fan out. One
    StreamingEngine synthesizes continuously for the server's lifetime;
    every connected client receives the same PCM stream and shares the
    command surface (hits, sustains, clears are world state). ``quit``
    disconnects only that client. ``listener`` moves the SHARED listener
    by default; with ``per_client_listeners`` = L, each client gets its
    OWN listener row (shared-state multi-listener solver) and hears its
    own mix column.

    ``load_model`` hot-swaps the stream for everyone (same channel/block
    guard as AudioServer).
    """

    # object_vel kinematics are WORLD state like hits: one ticker for the
    # shared engine's lifetime, surviving client churn and engine restarts
    _motion_persistent = True

    def __init__(self, make_session, model=None, host: str = "127.0.0.1",
                 port: int = 0, lookahead: int = 1, session_loader=None,
                 qnorm_every: int = 0, client_queue_depth: int = 8,
                 pace_lead: float | None = 0.3, max_restarts: int = 3,
                 positions=None, per_client_listeners: int = 0,
                 scene=None, post_mix_factory=None,
                 motion_rate_hz: float = 4.0, listener_init=None):
        """``max_restarts``: consecutive engine-rebuild attempts after a
        synthesis failure before the server gives up (a successful rebuild
        resets the count) — elastic recovery the reference lacks entirely
        (its sim thread dies invisibly, SURVEY section 5).

        ``per_client_listeners`` = L > 0 gives each connected client its
        OWN listener: the session must be built with num_listeners == L
        (shared-state multi-listener rows — one [O, M] oscillator state,
        [L, O, M] transfer rows, mix channel l = listener l's ears).
        Client c is assigned a free listener slot at connect; its
        ``listener`` commands move only that row (merged host-side into
        one [L, 3] latest-wins event), and its PCM stream is its own mix
        column duplicated to stereo. Beyond L concurrent clients, extra
        connections share slot 0's view (announced in-band). L is a
        static shape: pick a small power of two, like slot_buckets.

        A TUPLE of buckets, e.g. ``per_client_listeners=(2, 4, 8)``,
        makes L DYNAMIC: the server starts at the smallest bucket and,
        when a connect finds no free slot, hot-swaps the engine to the
        next bucket (``make_session`` must accept a ``num_listeners``
        keyword). The swap drops the in-flight ring-down like the
        reference's LoadNewModel; existing clients keep their slots,
        channels, and listener positions. Grow-only (no shrink).

        ``listener_init``: [3] or [L, 3] startup position(s) for
        per-client listener rows. Default: the position the built
        session's own set_listener configured (its host mirror), so a
        client that never sends a listener command hears from the
        scene's configured point, not an arbitrary one."""
        super().__init__(make_session, model=model, host=host, port=port,
                         lookahead=lookahead, session_loader=session_loader,
                         qnorm_every=qnorm_every, positions=positions,
                         scene=scene, post_mix_factory=post_mix_factory,
                         motion_rate_hz=motion_rate_hz)
        self._client_depth = client_queue_depth
        self._fanout = _FanoutSink(pace_lead=pace_lead)
        if isinstance(per_client_listeners, (tuple, list)):
            self._pcl_buckets = sorted(int(b) for b in per_client_listeners)
            self._pcl = self._pcl_buckets[0] if self._pcl_buckets else 0
        else:
            self._pcl_buckets = []
            self._pcl = int(per_client_listeners)
        self._slot_lock = threading.Lock()
        self._slots_free = list(range(self._pcl))
        # placeholder rows until the first session reveals the configured
        # startup listener (_seed_listener_rows); [1.0, 0.5, 0.5] is only
        # the last-resort default for sessions that never set a listener
        self._listener_init = listener_init
        self._listener_seeded = False
        self._listener_default_row = np.asarray([1.0, 0.5, 0.5])
        self._listener_pos = (np.tile(self._listener_default_row[None],
                                      (self._pcl, 1))
                              if self._pcl else None)
        self._engine = None
        self._engine_lock = threading.Lock()
        self._max_restarts = max_restarts
        self.restarts = 0
        self._dead = False   # set when recovery is exhausted
        self._swapping = False  # load_model parks the engine for seconds
        #   (warmup); the health poll must not race it with a restart —
        #   two engines would interleave blocks into the same fan-out
        self._closed = False  # set by close(); serve_forever must not
        #   rebuild an engine nobody will ever stop
        self.grows: list[dict] = []   # one record per listener-bucket grow
        # the clients' threads, which close() waits for: one that ran a
        # grow holds the library's per-thread state, and a process that
        # exits while such a thread still runs can abort at exit
        self._rx_threads: list[threading.Thread] = []

    def _after_engine_start(self, engine) -> None:
        """Hook for subclasses (e.g. the WS telemetry pusher)."""

    def _ensure_motion_ticker(self, engine) -> _MotionTicker:
        # track the CURRENT engine through restarts/grows, not the one
        # that happened to receive the first object_vel command
        with self._motion_lock:
            if self._motion is None or not self._motion.is_alive():
                self._motion = _MotionTicker(self, lambda: self._engine,
                                             rate_hz=self._motion_rate)
                self._motion.start()
            return self._motion

    def _begin_swap(self) -> None:
        self._swapping = True

    def _end_swap(self) -> None:
        self._swapping = False

    def _note_swap(self, meta_path: str) -> None:
        # after a hot-swap, an engine RESTART must rebuild the swapped-in
        # model, not the original make_session one — otherwise clients
        # would hear model A while self._model (hit addressing, viewer
        # payloads) still describes model B
        if self._session_loader is None:
            return
        loader = self._session_loader

        def make():
            model, sess = loader(meta_path)
            self._model = model
            return sess

        self._make_session = make

    def _build_session(self):
        """make_session, passing the CURRENT listener bucket when L is
        dynamic (the factory must accept a num_listeners keyword then)."""
        if self._pcl_buckets:
            return self._make_session(num_listeners=self._pcl)
        return self._make_session()

    def _ensure_engine(self):
        from .engine import StreamingEngine
        with self._engine_lock:
            if self._engine is None:
                session = self._build_session()
                if self._pcl and session.num_listeners != self._pcl:
                    raise ValueError(
                        f"per_client_listeners={self._pcl} needs a "
                        f"session built with num_listeners={self._pcl} "
                        f"(got {session.num_listeners})")
                self._engine = StreamingEngine(
                    session, self._fanout, lookahead=self._lookahead,
                    qnorm_every=self._qnorm_every,
                    post_mix=(self._post_mix_factory()
                              if self._post_mix_factory else None))
                self._engine.start()
                if self._pcl:
                    self._seed_listener_rows(session)
                    # (re)apply every slot's listener — an engine rebuild
                    # must restore the clients' views, not reset them
                    with self._slot_lock:
                        pos = self._listener_pos.copy()
                    self._engine.set_listener(pos)
                self._after_engine_start(self._engine)
            return self._engine

    def _seed_listener_rows(self, session) -> None:
        """One-time seeding of the per-client listener rows from the
        configured startup listener: explicit ``listener_init`` if given,
        else the position the session's own set_listener configured (its
        host mirror). A client that never sends a listener command then
        hears from the scene's configured point, not a hard-coded one.
        Runs before the first engine's row push, so no client can have
        moved yet; later rebuilds keep the clients' rows untouched."""
        if self._listener_seeded:
            return
        self._listener_seeded = True
        init = self._listener_init
        if init is None and self._scene is not None:
            # scene serving: the session's _last_listener is in the scene's
            # per-object RELATIVE frame ([O, 3] / [L, O, 3]) and
            # engine.set_listener applies listener_frame again — seed from
            # the scene's remembered WORLD listener instead
            init = getattr(self._scene, "_last_world_listener", None)
        if init is None:
            ll = getattr(session, "_last_listener", None)
            if ll is not None and getattr(session, "listener_frame",
                                          None) is None:
                ll = np.asarray(ll, np.float64)
                if ll.ndim == 2 and ll.shape == (1, 3):
                    # a single point in row form — unambiguous (either
                    # one listener's world point or an O==1 per-object
                    # row, which is the same point)
                    ll = ll[0]
                # only shapes that are unambiguously world positions: one
                # point, or one point per listener (per-object relative
                # rows share neither shape unless O == L, which we skip)
                if ll.ndim == 1 or (
                        ll.ndim == 2
                        and ll.shape == (session.num_listeners, 3)
                        and session.num_listeners != 1):
                    init = ll
        if init is None:
            return
        init = np.asarray(init, np.float64).reshape(-1, 3)
        if init.shape[0] == 1:
            init = np.tile(init, (self._pcl, 1))
        if init.shape[0] < self._pcl:
            pad = np.tile(init[-1:], (self._pcl - init.shape[0], 1))
            init = np.concatenate([init, pad])
        with self._slot_lock:
            self._listener_default_row = init[-1].copy()
            self._listener_pos = init[:self._pcl].copy()

    def _restart_engine(self) -> bool:
        """Replace a dead engine in place; clients keep their streams.

        The fan-out sink (and every registered client queue) survives the
        swap — the new engine simply resumes writing blocks into it. The
        failure and recovery are announced to all clients in-band."""
        if self._closed:
            return False
        with self._engine_lock:
            dead, self._engine = self._engine, None
        err = repr(dead.error) if dead is not None else "unknown"
        if dead is not None:
            try:
                dead.stop()
            except Exception:  # noqa: BLE001 — a dead engine must not
                pass           # block recovery
        self._fanout.broadcast_json({"engine_failed": err,
                                     "restarting": True})
        try:
            engine = self._ensure_engine()
        except Exception as e:  # noqa: BLE001 — rebuild itself failed
            self._fanout.broadcast_json(
                {"error": f"engine rebuild failed: {e!r}"})
            return False
        self.restarts += 1
        self._fanout.broadcast_json({"restarted": True})
        return engine.healthy

    def serve_forever(self) -> None:
        self._ensure_engine()
        self._sock.settimeout(1.0)
        failures = 0
        while not self._closed:
            engine = self._engine
            if self._swapping:
                # the engine is parked by a load_model hot-swap, not dead
                time.sleep(0.1)
                continue
            if engine is None or not engine.healthy:
                failures += 1
                if failures > self._max_restarts or \
                        not self._restart_engine():
                    self._fanout.broadcast_json(
                        {"error": "synthesis failed permanently"})
                    self._dead = True
                    return
                continue
            failures = 0
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listening socket closed (shutdown)
            rx = threading.Thread(target=self._serve_client, args=(conn,),
                                  name="pbso-client-rx", daemon=True)
            self._rx_threads = [t for t in self._rx_threads
                                if t.is_alive()] + [rx]
            rx.start()

    # serve_one is not meaningful for a broadcast server; route it to the
    # same per-client path so existing callers still work
    def serve_one(self, timeout: float | None = None) -> None:
        engine = self._ensure_engine()
        self._sock.settimeout(timeout)
        conn, _ = self._sock.accept()
        self._serve_client(conn)
        del engine

    def _alloc_listener_slot(self) -> int | None:
        if not self._pcl:
            return None
        with self._slot_lock:
            if self._slots_free:
                return self._slots_free.pop(0)
        if self._pcl_buckets:
            return self._grow_listener_slots()
        return None

    def _grow_listener_slots(self) -> int | None:
        """Dynamic L: hot-swap the engine to the next listener bucket and
        return a freshly freed slot (None when already at the top bucket
        or the rebuild fails). Existing clients keep their slots/rows, and
        the oscillator/force state carries across the swap (see
        _carry_state_across_grow): the ring-down continues. Each grow
        appends its record to ``grows`` (buckets, seconds, whether the
        state carried)."""
        from .checkpoint import swap_model
        with self._engine_lock:
            # re-check under the lock: a concurrent connect may have just
            # grown the bucket (freeing slots) while we waited — without
            # this, the loser of the race would either double-grow
            # (a second hot-swap) or deny a now-free slot
            with self._slot_lock:
                if self._slots_free:
                    return self._slots_free.pop(0)
            nxt = [b for b in self._pcl_buckets if b > self._pcl]
            engine = self._engine
            if not nxt or engine is None:
                return None
            new_l = nxt[0]
            t = time.perf_counter()
            record = {"from": self._pcl, "to": new_l, "carried": False,
                      "at_block": engine._blocks_done}
            self._begin_swap()
            try:
                sess = self._make_session(num_listeners=new_l)
                if sess.num_listeners != new_l:
                    raise ValueError(
                        f"make_session ignored num_listeners={new_l}")
                sess.step()   # first use before parking the live stream

                def carry(old, new):
                    # the stream is parked here: the old state is final
                    record["carried"] = self._carry_state_across_grow(old,
                                                                      new)
                    if self._post_mix_factory is not None:
                        # a post-mix per listener column (live Doppler)
                        # is rebuilt at the new L and continues the old
                        # one's delay lines (DopplerPostMix.carry_from);
                        # the added columns start settled at the rows
                        # their slots will get
                        pm, old_pm = self._post_mix_factory(), engine._post_mix
                        if old_pm is not None and hasattr(pm, "carry_from"):
                            with self._slot_lock:
                                rows = np.concatenate([
                                    self._listener_pos, np.tile(
                                        self._listener_default_row[None],
                                        (new_l - self._pcl, 1))])
                            pm.carry_from(old_pm, rows)
                        engine._post_mix = pm
                swap_model(engine, sess, prepare=carry)
                with self._slot_lock:
                    old = self._pcl
                    self._pcl = new_l
                    pad = np.tile(self._listener_default_row[None],
                                  (new_l - old, 1))
                    self._listener_pos = np.concatenate(
                        [self._listener_pos, pad])
                    self._slots_free.extend(range(old, new_l))
                    # restore every existing client's view on the new rows
                    engine.set_listener(self._listener_pos.copy())
            except Exception as e:  # noqa: BLE001 — a failed grow must
                self._fanout.broadcast_json(   # not kill the server
                    {"error": f"listener-bucket grow failed: {e!r}"})
                return None
            finally:
                self._end_swap()
                record["seconds"] = time.perf_counter() - t
                self.grows.append(record)
        with self._slot_lock:
            return self._slots_free.pop(0) if self._slots_free else None

    def _free_listener_slot(self, slot: int | None) -> None:
        if slot is None:
            return
        with self._slot_lock:
            self._slots_free.append(slot)

    def _move_client_listener(self, engine, slot: int, pos) -> None:
        """Merge one client's move into the [L, 3] latest-wins event.

        The enqueue happens UNDER the merge lock: the engine's transfer
        slot keeps only the newest array, so enqueue order must match
        merge order — otherwise two concurrent movers could finish with
        a latest event that misses one of the row updates."""
        pos = np.asarray(pos, np.float64).reshape(3)
        with self._slot_lock:
            self._listener_pos[slot] = pos
            engine.set_listener(self._listener_pos.copy())

    @staticmethod
    def _carry_state_across_grow(old, new) -> bool:
        """Carry the oscillator/force state from the old session into the
        grown one so the listener-bucket swap is CLICK-FREE (the ring-down
        continues; only the transfer rows — recomputed right after from
        the merged listener positions — depend on L). Runs while the
        stream is parked, so the old state is the one its last block left.
        Returns False, carrying nothing, when the shapes differ (a
        different model/slot config), which is the reference's
        LoadNewModel behavior anyway. Unlike the JAX package, a failure of
        the carry itself is not swallowed: it fails the grow, which is
        announced to the clients."""
        import dataclasses as _dc
        if (old.state.z_re.shape != new.state.z_re.shape
                or old.state.slots.ftype.shape
                != new.state.slots.ftype.shape):
            return False
        # the old session is dropped after the swap: its tensors (the
        # slots and the sustained channel are written in place) pass to
        # the new session as they are
        new.state = _dc.replace(
            new.state,
            z_re=old.state.z_re, z_im=old.state.z_im,
            slots=old.state.slots, sustained=old.state.sustained,
            block_start=old.state.block_start)
        new._clock = old._clock
        new._clock_base = old._clock_base
        new._expiry[...] = old._expiry
        new._t0[...] = old._t0
        new._sus_active[...] = old._sus_active
        new._ar_host[...] = old._ar_host
        new._ar_g = {}   # invalidate the cached span AR tables
        return True

    def _route_client_command(self, sink, slot, payload) -> bool:
        """One inbound command from a per-client-capable transport:
        engine-health check, per-client listener intercept, then the
        shared command dispatch. Shared by the raw-TCP and WebSocket
        serve loops (they differ only in framing); the JSON is parsed
        exactly once. Returns True when the client asked to quit."""
        engine = self._engine
        if engine is None or not engine.healthy:
            sink.send_json({"error": "engine restarting"})
            return False
        try:
            msg = json.loads(payload)
        except json.JSONDecodeError:
            msg = None
        if self._pcl and msg and msg.get("cmd") == "listener":
            # per-client listener routing: a 'listener' command moves
            # only THIS client's row
            try:
                if slot is None:
                    raise ValueError("no per-client listener slot")
                self._move_client_listener(engine, slot, msg["pos"])
            except (KeyError, ValueError, TypeError) as e:
                sink.send_json({"error": str(e)})
            return False
        return self._dispatch(engine, sink, payload, msg=msg)

    def _serve_client(self, conn: socket.socket) -> None:
        engine = self._ensure_engine()
        block = engine.session.config.block_size
        try:
            sink = _SocketSink(
                conn, block,
                channels=(2 if self._pcl
                          else int(engine.session.gains.shape[-1])))
        except OSError:
            conn.close()
            return
        slot = self._alloc_listener_slot()
        client = _ClientStream(sink, depth=self._client_depth,
                               channel=(slot if slot is not None else
                                        (0 if self._pcl else None)))
        self._fanout.register(client)
        if self._pcl:
            sink.send_json({"listener_slot": slot} if slot is not None
                           else {"listener_slot": None,
                                 "error": "no free listener slot; "
                                          "sharing slot 0's view"})
        try:
            buf = b""
            conn.settimeout(5.0)
            # the loop tracks the server's CURRENT engine: a mid-stream
            # engine restart (see _restart_engine) must not disconnect
            # clients — their queues survive the swap
            while not sink.closed and not self._dead and not self._closed:
                try:
                    chunk = conn.recv(4096)
                except socket.timeout:
                    continue
                except OSError:
                    break
                if not chunk:
                    break
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if not line.strip():
                        continue
                    if self._route_client_command(sink, slot, line):
                        return
        finally:
            self._free_listener_slot(slot)
            self._fanout.unregister(client)
            sink.closed = True
            client.join()
            conn.close()

    def _stats_payload(self, engine) -> dict:
        payload = super()._stats_payload(engine)
        payload["clients"] = self._fanout.n_clients
        return payload

    def close(self) -> None:
        # flag FIRST: serve_forever/_restart_engine check it before
        # building an engine that nobody would ever stop (close racing
        # the accept loop)
        self._closed = True
        super().close()   # also force-stops the persistent motion ticker
        with self._engine_lock:
            engine, self._engine = self._engine, None
        if engine is not None:
            engine.stop()
        self._fanout.shutdown()
        # each client's thread sees the flag within its 5 s receive timeout
        deadline = time.monotonic() + 10.0
        for rx in self._rx_threads:
            if rx is not threading.current_thread():
                rx.join(timeout=max(0.0, deadline - time.monotonic()))


# ---------------------------------------------------------------------------
# client helper (used by tests and demo scripts)
# ---------------------------------------------------------------------------


class AudioClient:
    """Minimal blocking client for AudioServer streams."""

    def __init__(self, host: str, port: int, timeout: float = 300.0):
        # generous default: the server may be warming up its first block
        self._conn = socket.create_connection((host, port), timeout=timeout)
        header = self._recv_exact(16)
        if header[:4] != MAGIC:
            raise ValueError("bad stream magic")
        self.sample_rate, self.channels, self.block_size = struct.unpack(
            "<III", header[4:])
        self.messages: list[dict] = []

    def _recv_exact(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = self._conn.recv(n - len(out))
            if not chunk:
                raise ConnectionError("stream closed")
            out += chunk
        return out

    def send(self, **msg) -> None:
        self._conn.sendall(json.dumps(msg).encode() + b"\n")

    def read_block(self) -> np.ndarray:
        """Next PCM block (JSON side-messages are collected in .messages)."""
        while True:
            (n,) = struct.unpack("<I", self._recv_exact(4))
            if n == JSON_MARKER:
                (ln,) = struct.unpack("<I", self._recv_exact(4))
                self.messages.append(json.loads(self._recv_exact(ln)))
                continue
            data = self._recv_exact(n)
            return np.frombuffer(data, "<f4").reshape(-1, self.channels)

    def close(self) -> None:
        self._conn.close()
