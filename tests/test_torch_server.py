"""The port's TCP audio server (openpbso_tpu_torch.runtime.server) against
openpbso_tpu/runtime/server.py: the wire bytes bitwise, one command script
through both servers at <= -100 dB per client, and the server's behaviour
(hot swap, elastic restart, the listener-bucket grow and its state carry,
slow clients, bad input).

Nothing here asserts a wall-clock rate. The comparisons run the engines in
lockstep (``Lockstep``): each synthesis dispatch waits for a token, the
commands sent before a token apply at that block in either server, and the
consumer writes only produced blocks (no stale padding), so what a client
reads is the engine's tap. Waits are bounded at 120 s.
"""
import queue
import socket
import struct
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpbso_tpu.ops.coeffs import bank_from_material as j_bank
from openpbso_tpu.ops.coeffs import lambda_from_modes
from openpbso_tpu.ops.ffat import build_ffat as j_build_ffat
from openpbso_tpu.runtime import engine as j_engine_mod
from openpbso_tpu.runtime import server as jserver
from openpbso_tpu.runtime.session import ModalSession as JSession
from openpbso_tpu.runtime.solver import SolverConfig as JConfig
from openpbso_tpu.utils.synth import CERAMIC, synth_fatcube, synth_mode_data
from openpbso_tpu_torch.ops.coeffs import bank_from_material
from openpbso_tpu_torch.ops.ffat import build_ffat
from openpbso_tpu_torch.runtime import engine as t_engine_mod
from openpbso_tpu_torch.runtime import server as tserver
from openpbso_tpu_torch.runtime.session import ModalSession
from openpbso_tpu_torch.runtime.solver import SolverConfig

BLOCK = 256
MODES = 16
WAIT_S = 120.0


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: intra-op threads only slow them down, and
    under the suite's parallel workers they oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def wait_for(cond, seconds=WAIT_S):
    deadline = time.time() + seconds
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.005)
    return bool(cond())


# ---------------------------------------------------------------- sessions


def modes(seed=2):
    return synth_mode_data(MODES, 8, seed=seed)


def maps_for(md, seed=5):
    freqs = md.frequencies_hz(CERAMIC.density)
    return {i: synth_fatcube(i, float(freqs[i]), n=8, seed=seed)
            for i in range(md.num_modes)}


LISTENER = np.array([0.9, 0.2, 0.1])


def session_pair(md, maps=None, o=2, nl=1, lam=False):
    """(jax_factory, port_factory): each builds the same session on its
    package (port on the CPU), the listener set, when called."""
    lam64 = (lambda_from_modes(CERAMIC.density, md.omega_squared,
                               CERAMIC.alpha, CERAMIC.beta)[0]
             if lam else None)
    start = LISTENER if nl == 1 else np.tile(LISTENER, (nl, 1))

    def jax_session(num_listeners=nl):
        bank = j_bank(CERAMIC.density, md.omega_squared, CERAMIC.alpha,
                      CERAMIC.beta, num_objects=o, block_size=BLOCK,
                      dtype=jnp.float32)
        ffat = j_build_ffat(maps, bank.num_modes) if maps else None
        sess = JSession(bank, ffat=ffat, lam64=lam64,
                        num_listeners=num_listeners,
                        config=JConfig(block_size=BLOCK, backend="blocked"))
        sess.set_listener(start if num_listeners == nl
                          else np.tile(LISTENER, (num_listeners, 1)))
        return sess

    def port_session(num_listeners=nl):
        bank = bank_from_material(CERAMIC.density, md.omega_squared,
                                  CERAMIC.alpha, CERAMIC.beta,
                                  num_objects=o, block_size=BLOCK,
                                  device="cpu")
        ffat = build_ffat(maps, bank.num_modes, device="cpu") if maps \
            else None
        sess = ModalSession(bank, ffat=ffat, lam64=lam64,
                            num_listeners=num_listeners,
                            config=SolverConfig(block_size=BLOCK,
                                                backend="blocked"))
        sess.set_listener(start if num_listeners == nl
                          else np.tile(LISTENER, (num_listeners, 1)))
        return sess

    return jax_session, port_session


# ---------------------------------------------------------------- lockstep


class Lockstep:
    """Gate an engine module's StreamingEngine (see the module docstring):
    ``step()`` lets exactly one synthesis dispatch run. Engines built while
    the gate is installed are kept in ``engines``."""

    def __init__(self, engine_module, monkeypatch):
        self.engines = []
        self.tokens = threading.Semaphore(0)
        gate = self
        base = engine_module.StreamingEngine

        class Gated(base):
            def __init__(eng, *a, **kw):
                super().__init__(*a, **kw)
                gate.engines.append(eng)

            def _apply_events(eng):
                while not gate.tokens.acquire(timeout=0.02):
                    if eng._stop.is_set():
                        break
                super()._apply_events()

            def _consume_loop(eng):
                while not eng._stop.is_set():
                    try:
                        mix = eng._sound.get(timeout=0.02)
                    except queue.Empty:
                        continue
                    eng.sink.write(mix)

        monkeypatch.setattr(engine_module, "StreamingEngine", Gated)

    def step(self):
        self.tokens.release()


def count_commands(srv):
    """Count the commands the server has finished handling (events are in
    the engine's queues by then)."""
    name = ("_route_client_command"
            if hasattr(srv, "_route_client_command") else "_dispatch")
    inner = getattr(srv, name)
    done = [0]

    def counted(*a, **kw):
        try:
            return inner(*a, **kw)
        finally:
            done[0] += 1
    setattr(srv, name, counted)
    return done


def run_script(srv, gate, clients, script, n_blocks):
    """Send ``script`` ({block: [(client index, command)]}) in lockstep and
    read n_blocks from every client; returns each client's PCM."""
    done = count_commands(srv)
    sent = 0
    out = [[] for _ in clients]
    for b in range(n_blocks):
        for ci, cmd in script.get(b, ()):
            clients[ci].send(**cmd)
            sent += 1
        assert wait_for(lambda: done[0] >= sent), f"block {b}: commands"
        gate.step()
        for ci, c in enumerate(clients):
            out[ci].append(c.read_block())
    return [np.concatenate(o) for o in out]


def start(srv, forever=True):
    t = threading.Thread(
        target=srv.serve_forever if forever else srv.serve_one,
        daemon=True)
    t.start()
    return t


def stop(srv, t, clients):
    for c in clients:
        c.close()
    srv.close()
    t.join(timeout=30)


# ---------------------------------------------------------------- wire


def test_wire_header_blocks_and_json_framing_bitwise():
    """The 16-byte header, a length-prefixed float32 block and an in-band
    JSON reply: the same bytes from both servers' sinks, parsed back by the
    port's client."""
    rng = np.random.default_rng(0)
    block = rng.standard_normal((BLOCK, 2)).astype(np.float32)
    wires = []
    for mod in (jserver, tserver):
        a, b = socket.socketpair()
        sink = mod._SocketSink(a, BLOCK, channels=2)
        assert sink.write(block)
        sink.send_json({"stats": [1, 2.5], "ok": True})
        sink.close()
        data = b""
        while True:
            chunk = b.recv(65536)
            if not chunk:
                break
            data += chunk
        a.close()
        b.close()
        wires.append(data)
    assert wires[0] == wires[1]
    wire = wires[1]
    assert wire[:4] == b"PBSO" and struct.unpack("<III", wire[4:16]) == (
        44100, 2, BLOCK)
    n = BLOCK * 2 * 4
    assert struct.unpack("<I", wire[16:20]) == (n,)
    assert struct.unpack("<I", wire[20 + n:24 + n]) == (0xFFFFFFFF,)
    # the port's client reads the same bytes back
    a, b = socket.socketpair()
    a.sendall(wire)
    a.close()
    c = tserver.AudioClient.__new__(tserver.AudioClient)
    c._conn = b
    header = c._recv_exact(16)
    c.sample_rate, c.channels, c.block_size = struct.unpack("<III",
                                                            header[4:])
    c.messages = []
    np.testing.assert_array_equal(c.read_block(), block)
    with pytest.raises(ConnectionError):
        c.read_block()
    assert c.messages == [{"stats": [1, 2.5], "ok": True}]
    b.close()


def test_pacer_and_constants_match():
    assert tserver.MAGIC == jserver.MAGIC == b"PBSO"
    assert tserver.JSON_MARKER == jserver.JSON_MARKER
    p = tserver.RealTimePacer(None)
    p.pace(1 << 20)                 # disabled: returns at once
    assert p._samples == 0


# ---------------------------------------------------------------- vs JAX


SCRIPT_SINGLE = {
    0: [(0, {"cmd": "hit_space", "obj": 0, "space": [1.0] * MODES,
             "kind": "gaussian", "width_us": 600.0})],
    2: [(0, {"cmd": "listener", "pos": [0.5, 0.4, 0.3]})],
    3: [(0, {"cmd": "hit_space", "obj": 1, "space": [0.5] * MODES,
             "kind": "point"})],
    5: [(0, {"cmd": "sustain", "obj": 1,
             "space": list(np.linspace(0.2, 1.0, MODES))})],
    8: [(0, {"cmd": "arparam", "obj": 1, "a": [0.6, 0.2], "sigma": 0.003,
             "mu": 0.1})],
    10: [(0, {"cmd": "listener", "pos": [1.2, 0.1, 0.6]})],
    13: [(0, {"cmd": "release", "obj": 1})],
    14: [(0, {"cmd": "hit_space", "obj": 0, "space": [0.8] * MODES,
              "kind": "hertz", "width_us": 300.0, "amp": 0.7})],
}

SCRIPT_CLIENTS = {
    0: [(0, {"cmd": "listener", "pos": [0.45, 0.0, 0.0]}),
        (1, {"cmd": "listener", "pos": [1.8, 0.0, 0.0]})],
    1: [(0, {"cmd": "hit_space", "obj": 0, "space": [1.0] * MODES,
             "kind": "gaussian", "width_us": 900.0})],
    4: [(1, {"cmd": "sustain", "obj": 1, "space": [0.7] * MODES})],
    7: [(1, {"cmd": "listener", "pos": [0.3, 0.5, 0.2]}),
        (0, {"cmd": "arparam", "obj": 1, "sigma": 0.002, "mu": 0.2})],
    11: [(0, {"cmd": "release", "obj": 1}),
         (1, {"cmd": "hit_space", "obj": 1, "space": [1.0] * MODES})],
}


def served_pcm(mod, engine_mod, monkeypatch, kind, factory, script,
               n_blocks):
    gate = Lockstep(engine_mod, monkeypatch)
    if kind == "single":
        srv = mod.AudioServer(factory)
        t = start(srv, forever=False)
        clients = [mod.AudioClient(*srv.address)]
    else:
        srv = mod.BroadcastAudioServer(factory, pace_lead=None,
                                       per_client_listeners=2)
        t = start(srv)
        clients = []
        for k in range(2):
            # one at a time: each client's handler thread takes its
            # listener slot, so two racing connects may swap the slots
            clients.append(mod.AudioClient(*srv.address))
            assert wait_for(lambda: srv._fanout.n_clients == k + 1)
    try:
        pcm = run_script(srv, gate, clients, script, n_blocks)
        engine = gate.engines[-1]
        assert engine.error is None
        slots = [next((m["listener_slot"] for m in c.messages
                       if "listener_slot" in m), None) for c in clients]
        assert not [m for c in clients for m in c.messages if "error" in m]
    finally:
        stop(srv, t, clients)
    return pcm, slots


@pytest.mark.parametrize("kind,lam", [("single", False), ("single", True),
                                      ("broadcast", False)])
def test_served_pcm_matches_jax(kind, lam, monkeypatch, dberr):
    """The same script (hits, listener moves, a drag with a retune and its
    release) through the JAX package's server and the port's: every
    client's PCM agrees to <= -100 dB. ``lam``: sessions with span tables
    (one-block spans); ``broadcast``: two clients, each with its own
    listener row (per_client_listeners=2) and its own mix column."""
    md = modes()
    nl = 2 if kind == "broadcast" else 1
    jf, tf = session_pair(md, maps_for(md), nl=nl, lam=lam)
    script = SCRIPT_SINGLE if kind == "single" else SCRIPT_CLIENTS
    n = 18
    jpcm, jslots = served_pcm(jserver, j_engine_mod, monkeypatch, kind, jf,
                              script, n)
    tpcm, tslots = served_pcm(tserver, t_engine_mod, monkeypatch, kind, tf,
                              script, n)
    assert jslots == tslots
    for j, t in zip(jpcm, tpcm):
        assert t.shape == (n * BLOCK, 2) and t.dtype == np.float32
        assert float(np.abs(t).max()) > 0
        assert dberr(t, j) <= -100.0
    if kind == "broadcast":
        # each client hears its own listener: the near one dominates
        assert float((tpcm[0] ** 2).sum()) > 2.0 * float((tpcm[1] ** 2).sum())


# ---------------------------------------------------------------- behaviour


@pytest.fixture
def broadcast():
    md = modes()
    _, factory = session_pair(md)
    srv = tserver.BroadcastAudioServer(factory, pace_lead=0.05)
    t = start(srv)
    yield srv, md
    srv.close()
    t.join(timeout=30)


def read_until(c, cond, blocks=5000):
    for _ in range(blocks):
        if cond():
            return True
        c.read_block()
    return bool(cond())


def test_stream_hit_stats_and_errors():
    """Single-client server: a hit is audible, stats round-trips, and a
    malformed command gets an error reply while the stream lives."""
    md = modes()
    _, factory = session_pair(md)
    srv = tserver.AudioServer(factory)
    t = start(srv, forever=False)
    c = tserver.AudioClient(*srv.address)
    try:
        assert (c.sample_rate, c.channels, c.block_size) == (44100, 2, BLOCK)
        c.send(cmd="hit_space", obj=0, space=[1.0] * MODES,
               kind="gaussian", width_us=2000.0)
        peak = [0.0]

        def heard():
            return peak[0] > 0
        for _ in range(200):
            peak[0] = max(peak[0], float(np.abs(c.read_block()).max()))
            if heard():
                break
        assert heard()
        c.send(cmd="stats")
        assert read_until(c, lambda: any("health" in m for m in c.messages))
        c._conn.sendall(b"this is not json\n")
        assert read_until(c, lambda: "error" in c.messages[-1])
        c.send(cmd="quit")
    finally:
        stop(srv, t, [c])


@pytest.mark.parametrize("bad", [
    b"\x00\xff\xfe garbage \n",
    b'{"cmd": "hit", "obj": 0, "vertex": 3}\n',          # no model
    b'{"cmd": "hit_space", "obj": 99, "space": [1.0]}\n',
    b'{"cmd": "sustain", "obj": 99, "space": [1.0]}\n',
    b'{"cmd": "release", "obj": 99}\n',
    b'{"cmd": "arparam", "obj": 0, "a": [1, 2, 3]}\n',
    b'{"cmd": "object_pos", "obj": 0, "pos": [1, 2, 3]}\n',  # no scene
    b'{"cmd": "load_model", "meta": "x.meta"}\n',          # no loader
    b'{"cmd": "nope"}\n',
])
def test_bad_command_errors_only_its_sender(broadcast, bad):
    """A bad command gets an error reply; the shared stream and engine
    stay up, and real commands still work afterwards."""
    srv, md = broadcast
    c = tserver.AudioClient(*srv.address)
    try:
        c._conn.sendall(bad)
        assert read_until(c, lambda: any("error" in m for m in c.messages))
        c.messages.clear()
        c.send(cmd="stats")
        assert read_until(c, lambda: any("health" in m for m in c.messages))
        assert srv._engine.healthy and srv.restarts == 0
    finally:
        c.close()


def test_broadcast_clients_share_stream_and_late_joiner(broadcast):
    """Both clients hear a hit sent by one; one quitting leaves the other
    streaming, and the client count follows."""
    srv, md = broadcast
    a = tserver.AudioClient(*srv.address)
    b = tserver.AudioClient(*srv.address)
    try:
        assert wait_for(lambda: srv._fanout.n_clients == 2)
        a.send(cmd="hit_space", obj=0, space=[1.0] * MODES,
               kind="gaussian", width_us=2000.0)
        for c in (a, b):
            peak = [0.0]

            def loud(c=c, peak=peak):
                peak[0] = max(peak[0], float(np.abs(c.read_block()).max()))
                return peak[0] > 0
            assert wait_for(loud), "hit inaudible on one client"
        b.send(cmd="quit")
        assert wait_for(lambda: srv._fanout.n_clients == 1)
        a.send(cmd="stats")
        assert read_until(a, lambda: any(m.get("clients") == 1
                                         for m in a.messages))
    finally:
        a.close()
        b.close()


def test_engine_restart_keeps_clients(broadcast):
    """Elastic recovery: a dead engine is rebuilt in place, the client
    sees the failure and the recovery in-band on the same connection, and
    its next hit reaches the new engine."""
    srv, md = broadcast
    c = tserver.AudioClient(*srv.address)
    try:
        c.read_block()
        engine = srv._engine
        engine.error = RuntimeError("injected failure")
        engine._stop.set()
        assert read_until(c, lambda: any("restarted" in m
                                         for m in c.messages))
        assert any("engine_failed" in m for m in c.messages)
        assert srv.restarts == 1 and srv._engine is not engine
        c.send(cmd="hit_space", obj=0, space=[1.0] * MODES,
               kind="gaussian", width_us=2000.0)
        assert read_until(c, lambda: srv._engine.session._clock > 0
                          and bool(srv._engine.session._expiry.any()))
    finally:
        c.close()


def test_close_waits_for_client_threads():
    """close() ends every client's thread, a connected one too (within its
    receive timeout), so a process can exit right after it: a thread that
    ran a listener-bucket grow holds the library's per-thread state."""
    md = modes()
    _, factory = session_pair(md, maps_for(md), nl=1)
    srv = tserver.BroadcastAudioServer(factory, pace_lead=0.05,
                                       per_client_listeners=(1, 2))
    t = start(srv)
    a = tserver.AudioClient(*srv.address)
    b = tserver.AudioClient(*srv.address)         # grows the bucket
    try:
        assert wait_for(lambda: srv.grows and srv._fanout.n_clients == 2)
        rx = [th for th in srv._rx_threads if th.is_alive()]
        assert len(rx) == 2
        srv.close()
        assert not any(th.is_alive() for th in rx)
        t.join(timeout=30)
        assert not t.is_alive()
    finally:
        a.close()
        b.close()


def test_client_reset_does_not_kill_listener():
    md = modes()
    _, factory = session_pair(md)
    srv = tserver.AudioServer(factory)
    t = start(srv)
    try:
        a = tserver.AudioClient(*srv.address)
        a.read_block()
        a._conn.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                           struct.pack("ii", 1, 0))
        a.close()
        b = tserver.AudioClient(*srv.address)
        assert b.read_block().shape == (BLOCK, 2)
        b.send(cmd="quit")
        b.close()
    finally:
        srv.close()
        t.join(timeout=30)


class _Sink:
    """A fan-out client sink: ``gate`` (an Event) holds each write until
    set, as a client that stopped reading holds its socket send."""

    def __init__(self, gate=None):
        self.closed = False
        self.blocks = []
        self._gate = gate

    def write(self, block):
        if self._gate is not None:
            self._gate.wait()
        self.blocks.append(block)
        return True

    def close(self):
        self.closed = True


def test_slow_client_drops_blocks_without_stalling_others():
    """A client that stops draining drops its oldest blocks; the fan-out
    never waits for it and the other client receives every block."""
    hub = tserver._FanoutSink(pace_lead=None)
    held = threading.Event()
    slow = tserver._ClientStream(_Sink(held), depth=4)
    fast = tserver._ClientStream(_Sink(), depth=4)
    hub.register(slow)
    hub.register(fast)
    n = 40
    for i in range(n):
        block = np.full((8, 2), float(i), np.float32)
        t = time.perf_counter()
        assert hub.write(block)
        assert time.perf_counter() - t < 5.0   # the hub never blocks
        assert wait_for(lambda: len(fast.sink.blocks) == i + 1)
    assert [int(b[0, 0]) for b in fast.sink.blocks] == list(range(n))
    assert fast.dropped == 0 and slow.dropped >= n - 4 - 1
    held.set()
    assert wait_for(lambda: len(slow.sink.blocks) + slow.dropped == n)
    # what the slow client did get is the newest blocks, in order
    got = [int(b[0, 0]) for b in slow.sink.blocks]
    assert got == sorted(got) and got[-1] == n - 1
    hub.shutdown()
    for c in (slow, fast):
        c.join()


def test_load_model_hot_swap(tmp_path):
    """load_model over the wire swaps the stream to a model read from a
    .meta file (session_loader), the new model sounds, and a bad path is
    an error reply on a stream that lives on."""
    import os

    from openpbso_tpu_torch.io.meta import (read_meta, resolve_model_dir,
                                            write_meta)
    from openpbso_tpu_torch.models.modal_model import load_model
    from openpbso_tpu_torch.utils.synth import synth_model_dir
    root = str(tmp_path / "m")
    synth_model_dir(root, "synth", num_modes=24, subdivisions=1, ffat_n=8,
                    seed=7)
    meta = os.path.join(str(tmp_path), "synth.meta")
    write_meta(meta, resolve_model_dir(root, "synth"))

    def loader(path):
        model = load_model(read_meta(path))
        bank = bank_from_material(
            model.material.density,
            model.modes.omega_squared[: model.num_modes_audible],
            model.material.alpha, model.material.beta, block_size=BLOCK,
            device="cpu")
        return model, ModalSession(bank, config=SolverConfig(
            block_size=BLOCK, backend="blocked"))

    md = modes()
    _, factory = session_pair(md)
    srv = tserver.BroadcastAudioServer(factory, pace_lead=0.05,
                                       session_loader=loader)
    t = start(srv)
    c = tserver.AudioClient(*srv.address)
    try:
        first = srv._engine.session
        c.send(cmd="load_model", meta=meta)
        assert read_until(c, lambda: any("loaded" in m for m in c.messages))
        loaded = next(m for m in c.messages if "loaded" in m)
        assert loaded["loaded"] == meta and loaded["objects"] == 1
        assert loaded["modes"] == srv._engine.session.bank.num_modes
        assert srv._engine.session is not first
        assert srv._model.num_modes_audible == loaded["audible"]
        c.send(cmd="hit", obj=0, vertex=3, kind="gaussian", width_us=900.0)
        assert read_until(c, lambda: bool(
            srv._engine.session._expiry.any()))
        c.messages.clear()
        c.send(cmd="load_model", meta="/nonexistent/nope.meta")
        assert read_until(c, lambda: any("error" in m for m in c.messages))
        assert c.read_block().shape == (BLOCK, 2) and srv._engine.healthy
        # a restart after the swap rebuilds the SWAPPED model
        srv._engine.error = RuntimeError("injected")
        srv._engine._stop.set()
        assert read_until(c, lambda: any("restarted" in m
                                         for m in c.messages))
        assert srv._engine.session.bank.num_modes == loaded["modes"]
    finally:
        stop(srv, t, [c])


def carry_probe(srv):
    """Wrap the server's state carry: record the old session's final
    state (the stream is parked) and the grown session's state as its
    stream starts (after start()'s warmup, which restores it)."""
    seen = {}
    carry = srv._carry_state_across_grow

    def probe(old, new):
        seen["old"] = [x.clone() for x in (old.state.z_re, old.state.z_im,
                                           old.state.slots.t0)]
        seen["old_clock"] = old._clock
        ok = carry(old, new)
        warmup = new.warmup

        def after(**kw):
            warmup(**kw)
            seen["new"] = [x.clone() for x in (
                new.state.z_re, new.state.z_im, new.state.slots.t0)]
            seen["new_clock"] = new._clock
        new.warmup = after
        return ok
    srv._carry_state_across_grow = probe
    return seen


def test_bucket_grow_carries_state_bitwise(monkeypatch):
    """Dynamic listener buckets (1, 2): the second client grows the engine
    to two listener rows; the ring-down carries across the swap bitwise
    (oscillator state and force slots), the first client keeps its slot
    and both stream afterwards with their own rows."""
    md = modes()
    _, factory = session_pair(md, maps_for(md), nl=1)
    gate = Lockstep(t_engine_mod, monkeypatch)
    srv = tserver.BroadcastAudioServer(factory, pace_lead=None,
                                       per_client_listeners=(1, 2))
    seen = carry_probe(srv)
    t = start(srv)
    a = tserver.AudioClient(*srv.address)
    clients = [a]
    try:
        assert wait_for(lambda: srv._fanout.n_clients == 1)
        a.send(cmd="hit_space", obj=0, space=[1.0] * MODES,
               kind="gaussian", width_us=20000.0)
        a.send(cmd="listener", pos=[0.5, 0.1, 0.1])
        for _ in range(6):
            gate.step()
            a.read_block()
        assert srv._pcl == 1
        b = tserver.AudioClient(*srv.address)
        clients.append(b)
        # the old engine stops at its gate; its last dispatch needs none
        assert wait_for(lambda: srv.grows)
        grow, = srv.grows
        assert grow["from"] == 1 and grow["to"] == 2 and grow["carried"]
        assert srv._pcl == 2
        assert float(seen["old"][0].abs().max()) > 0   # it was ringing
        for x, y in zip(seen["old"], seen["new"]):
            assert torch.equal(x, y)
        assert seen["old_clock"] == seen["new_clock"]
        assert wait_for(lambda: srv._fanout.n_clients == 2)
        for _ in range(4):
            gate.step()
            for c in clients:
                assert c.read_block().shape == (BLOCK, 2)
        slots = [next(m["listener_slot"] for m in c.messages
                      if "listener_slot" in m) for c in clients]
        assert slots == [0, 1]
        sess = srv._engine.session
        assert sess.num_listeners == 2
        # the first client's row survived the grow
        rows = sess._last_listener
        np.testing.assert_allclose(np.asarray(rows)[0], [0.5, 0.1, 0.1])
    finally:
        stop(srv, t, clients)


def test_grow_rechecks_free_list_and_tops_out():
    """A connect that lost the race to a concurrent grow takes the freed
    slot instead of growing again; at the top bucket no slot is left."""
    srv = tserver.BroadcastAudioServer.__new__(tserver.BroadcastAudioServer)
    srv._engine_lock = threading.Lock()
    srv._slot_lock = threading.Lock()
    srv._slots_free = [3]
    srv._pcl_buckets = [2, 4]
    srv._pcl = 4
    srv._engine = object()
    assert srv._grow_listener_slots() == 3
    assert srv._grow_listener_slots() is None   # top bucket, none free


def test_carry_skips_mismatched_shapes():
    md = modes()
    _, factory = session_pair(md, o=2)
    old = factory()
    other = session_pair(md, o=3)[1]()
    assert tserver.BroadcastAudioServer._carry_state_across_grow(
        old, other) is False
    same = factory()
    old.hit(0, np.ones(MODES))
    old.render(2)
    assert tserver.BroadcastAudioServer._carry_state_across_grow(old, same)
    assert same._clock == old._clock
    assert torch.equal(same.state.z_re, old.state.z_re)


def test_transfer_hist_and_ball_payloads_match_jax():
    """The HUD's payloads from the same live state: the per-mode transfer
    row (one listener of two), the icosphere and its per-vertex transfer,
    and the qnorm-weighted ball colours."""
    md = modes()
    maps = maps_for(md)
    jf, tf = session_pair(md, maps, nl=2)

    class _Engine:
        def __init__(self, session):
            self.session = session
    out = []
    for mod, f in ((jserver, jf), (tserver, tf)):
        sess = f()
        sess.set_listener(np.asarray([[0.4, 0.3, 0.2], [1.5, 0.2, 0.1]]))
        srv = mod.AudioServer.__new__(mod.AudioServer)
        srv._model = None
        srv._ball_mesh = (None, None)
        srv._ball_transfer = None
        eng = _Engine(sess)
        hist = srv._transfer_hist_payload(eng, {"obj": 1, "listener": 1})
        with pytest.raises(IndexError):
            srv._transfer_hist_payload(eng, {"obj": 0, "listener": -1})
        ball = srv._ball_payload(eng)
        q = np.abs(np.random.default_rng(0).standard_normal((2, MODES)))
        out.append((hist, ball, srv.ball_colors(q)))
    (jh, jb, jc), (th, tb, tc) = out
    assert th["transfer_hist"].keys() == jh["transfer_hist"].keys()
    np.testing.assert_allclose(th["transfer_hist"]["values"],
                               jh["transfer_hist"]["values"], rtol=1e-5)
    assert tb == jb
    np.testing.assert_allclose(tc, jc, rtol=1e-5, atol=1e-6)
