"""The port's WebSocket bridge (openpbso_tpu_torch.runtime.wsbridge) against
openpbso_tpu/runtime/wsbridge.py: the handshake key, server frames, the
client-frame reader (masking, fragments with control frames between them,
the length cap) and the demo page bitwise; one command script through both
WebSocket servers in lockstep at <= -100 dB per browser; and the bridge's
own behaviour (protocol violations, ping, engine restart, the transfer-ball
colour feed). Nothing here asserts a wall-clock rate.
"""
import base64
import contextlib
import json
import os
import socket
import struct

import numpy as np
import pytest
import torch

from openpbso_tpu.runtime import engine as j_engine_mod
from openpbso_tpu.runtime import wsbridge as jws
from openpbso_tpu_torch.runtime import engine as t_engine_mod
from openpbso_tpu_torch.runtime import wsbridge as tws
from test_torch_server import (BLOCK, MODES, SCRIPT_CLIENTS, SCRIPT_SINGLE,
                               Lockstep, maps_for, modes, run_script,
                               session_pair, start, wait_for)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def mask_frame(opcode, payload, fin=True, mask=b"\x11\x22\x33\x44"):
    """A client->server frame (masked, RFC 6455)."""
    masked = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
    head = bytes([(0x80 if fin else 0) | opcode])
    n = len(payload)
    if n < 126:
        head += bytes([0x80 | n])
    elif n < (1 << 16):
        head += bytes([0x80 | 126]) + struct.pack(">H", n)
    else:
        head += bytes([0x80 | 127]) + struct.pack(">Q", n)
    return head + mask + masked


class WSClient:
    """A minimal browser stand-in: handshake, masked JSON commands, and
    frame reads (PCM blocks and JSON side messages)."""

    def __init__(self, host, port, channels=2):
        self.sock = socket.create_connection((host, port), timeout=120)
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall(
            f"GET /ws HTTP/1.1\r\nHost: {host}\r\nUpgrade: websocket\r\n"
            f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
            f"Sec-WebSocket-Version: 13\r\n\r\n".encode())
        resp = b""
        while b"\r\n\r\n" not in resp:
            resp += self.sock.recv(4096)
        head, self._buf = resp.split(b"\r\n\r\n", 1)
        assert b"101" in head.split(b"\r\n")[0]
        accept = [ln for ln in head.split(b"\r\n")
                  if ln.lower().startswith(b"sec-websocket-accept")][0]
        assert accept.split(b":")[1].strip().decode() == \
            tws.ws_accept_key(key)
        self.channels = channels
        self.messages = []

    def _need(self, n):
        while len(self._buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def read_frame(self):
        b0, b1 = self._need(2)
        n = b1 & 0x7F
        if n == 126:
            (n,) = struct.unpack(">H", self._need(2))
        elif n == 127:
            (n,) = struct.unpack(">Q", self._need(8))
        return b0 & 0x0F, self._need(n)

    def read_block(self):
        while True:
            op, payload = self.read_frame()
            if op == tws.OP_TEXT:
                self.messages.append(json.loads(payload))
                continue
            assert op == tws.OP_BINARY, op
            return np.frombuffer(payload, "<f4").reshape(-1, self.channels)

    def send(self, **obj):
        self.sock.sendall(mask_frame(tws.OP_TEXT, json.dumps(obj).encode()))

    def close(self):
        with contextlib.suppress(OSError):
            self.sock.sendall(mask_frame(tws.OP_CLOSE, b""))
        self.sock.close()


# ---------------------------------------------------------------- codec


@pytest.mark.parametrize("key", ["dGhlIHNhbXBsZSBub25jZQ==", "", "x" * 40])
def test_accept_key_bitwise(key):
    assert tws.ws_accept_key(key) == jws.ws_accept_key(key)
    if key == "dGhlIHNhbXBsZSBub25jZQ==":        # RFC 6455's example
        assert tws.ws_accept_key(key) == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="


@pytest.mark.parametrize("n", [0, 1, 125, 126, 65535, 65536, 70000])
def test_encode_frame_bitwise(n):
    payload = bytes(np.random.default_rng(n).integers(0, 256, n,
                                                      dtype=np.uint8))
    for op in (tws.OP_TEXT, tws.OP_BINARY, tws.OP_PONG, tws.OP_CLOSE):
        assert tws.encode_frame(op, payload) == jws.encode_frame(op, payload)
    assert (tws.OP_TEXT, tws.OP_BINARY, tws.OP_CLOSE, tws.OP_PING,
            tws.OP_PONG) == (jws.OP_TEXT, jws.OP_BINARY, jws.OP_CLOSE,
                             jws.OP_PING, jws.OP_PONG)


def read_all(mod, wire, max_len=1 << 20):
    """Every message mod._FrameReader parses from ``wire`` over a
    socketpair, and the error that ended the stream."""
    a, b = socket.socketpair()
    a.sendall(wire)
    a.close()
    reader = mod._FrameReader(b, max_len=max_len)
    got = []
    try:
        while True:
            got.append(reader.read_frame())
    except ConnectionError as e:
        err = str(e)
    b.close()
    return got, err


FRAG = (mask_frame(0x1, b'{"cmd": "hit_sp', fin=False)
        + mask_frame(0x9, b"ping!")                        # control between
        + mask_frame(0x0, b'ace", "obj": 0,', fin=False)
        + mask_frame(0xA, b"")
        + mask_frame(0x0, b' "space": [1.0]}'))
WIRES = {
    "masked": mask_frame(0x1, b'{"cmd": "stats"}')
    + mask_frame(0x2, bytes(range(200))) + mask_frame(0x8, b""),
    "long": mask_frame(0x1, b"x" * 70000) + mask_frame(0x1, b"y" * 300),
    "unmasked": bytes([0x81, 5]) + b"hello",
    "fragmented": FRAG + mask_frame(0x1, b"next"),
    "new data mid-fragment": mask_frame(0x1, b"a", fin=False)
    + mask_frame(0x1, b"b"),
}


@pytest.mark.parametrize("name", list(WIRES))
def test_frame_reader_bitwise(name):
    """Both readers parse the same messages from the same bytes and stop
    with the same error (fragments reassemble across interleaved control
    frames; a new data frame inside a fragmented message is a protocol
    violation)."""
    jgot, jerr = read_all(jws, WIRES[name])
    tgot, terr = read_all(tws, WIRES[name])
    assert tgot == jgot and terr == jerr
    if name == "fragmented":
        assert tgot == [(0x9, b"ping!"), (0xA, b""),
                        (0x1, b'{"cmd": "hit_space", "obj": 0, '
                              b'"space": [1.0]}'), (0x1, b"next")]
    if name == "new data mid-fragment":
        assert tgot == [] and "protocol violation" in terr


@pytest.mark.parametrize("wire", [
    mask_frame(0x1, b"z" * 100),                              # one frame
    mask_frame(0x1, b"z" * 40, fin=False) + mask_frame(0x0, b"z" * 40,
                                                       fin=False)
    + mask_frame(0x0, b"z" * 40),                             # fragments
    bytes([0x81, 0x80 | 127]) + struct.pack(">Q", 1 << 40),   # declared
])
def test_frame_reader_caps_length(wire):
    jgot, jerr = read_all(jws, wire, max_len=64)
    tgot, terr = read_all(tws, wire, max_len=64)
    assert tgot == jgot == [] and terr == jerr and "too large" in terr


def test_demo_page_bitwise():
    assert tws.DEMO_PAGE == jws.DEMO_PAGE
    assert "AudioContext" in tws.DEMO_PAGE and "WebSocket" in tws.DEMO_PAGE


def http_get(address, path):
    s = socket.create_connection(address, timeout=60)
    s.sendall(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    resp = b""
    while True:
        chunk = s.recv(65536)
        if not chunk:
            break
        resp += chunk
    s.close()
    return resp


def test_served_page_and_404_bitwise():
    """GET / and GET /other answer the same bytes from both servers; no
    engine is built for a page request."""
    md = modes()
    out = []
    for mod, f in zip((jws, tws), session_pair(md)):
        built = []
        srv = mod.WebSocketAudioServer(lambda f=f: built.append(1) or f())
        t = start(srv)
        try:
            out.append((http_get(srv.address, "/"),
                        http_get(srv.address, "/nope")))
        finally:
            # the JAX server's close() leaves its accept() blocked
            with contextlib.suppress(OSError):
                srv._sock.shutdown(socket.SHUT_RDWR)
            srv.close()
            t.join(timeout=30)
        assert not built
    assert out[0] == out[1]
    page, missing = out[1]
    assert page.startswith(b"HTTP/1.1 200") and page.endswith(
        tws.DEMO_PAGE.encode())
    assert missing.startswith(b"HTTP/1.1 404")


# ---------------------------------------------------------------- vs JAX


def ws_served(mod, engine_mod, monkeypatch, kind, factory, script, n):
    gate = Lockstep(engine_mod, monkeypatch)
    if kind == "single":
        srv = mod.WebSocketAudioServer(factory)
        n_clients = 1
    else:
        srv = mod.BroadcastWebSocketAudioServer(factory, pace_lead=None,
                                                per_client_listeners=2)
        n_clients = 2
    t = start(srv)
    clients = []
    try:
        for _ in range(n_clients):
            clients.append(WSClient(*srv.address))
            op, hello = clients[-1].read_frame()
            assert op == tws.OP_TEXT
            clients[-1].messages.append(json.loads(hello))
        if kind != "single":
            assert wait_for(lambda: srv._fanout.n_clients == n_clients)
        else:
            assert wait_for(lambda: gate.engines)
        pcm = run_script(srv, gate, clients, script, n)
        assert gate.engines[-1].error is None
        hellos = [c.messages[0] for c in clients]
        assert not [m for c in clients for m in c.messages if "error" in m]
    finally:
        for c in clients:
            c.close()
        srv.close()
        t.join(timeout=30)
    return pcm, hellos


@pytest.mark.parametrize("kind", ["single", "broadcast"])
def test_ws_served_pcm_matches_jax(kind, monkeypatch, dberr):
    """The same script through both WebSocket servers: the hello frames
    are equal and every browser's PCM agrees to <= -100 dB; with per-client
    listeners each hears its own row."""
    md = modes()
    nl = 2 if kind == "broadcast" else 1
    jf, tf = session_pair(md, maps_for(md), nl=nl)
    script = SCRIPT_SINGLE if kind == "single" else SCRIPT_CLIENTS
    n = 16
    jpcm, jhello = ws_served(jws, j_engine_mod, monkeypatch, kind, jf,
                             script, n)
    tpcm, thello = ws_served(tws, t_engine_mod, monkeypatch, kind, tf,
                             script, n)
    assert thello == jhello
    for j, t in zip(jpcm, tpcm):
        assert t.shape == (n * BLOCK, 2) and float(np.abs(t).max()) > 0
        assert dberr(t, j) <= -100.0
    if kind == "broadcast":
        assert {h["listener_slot"] for h in thello} == {0, 1}
        assert float((tpcm[0] ** 2).sum()) > 2.0 * float((tpcm[1] ** 2).sum())


# ---------------------------------------------------------------- behaviour


@pytest.fixture
def ws_server():
    md = modes()
    srv = tws.WebSocketAudioServer(session_pair(md)[1])
    t = start(srv)
    yield srv
    srv.close()
    t.join(timeout=30)


def test_ws_stream_commands_and_ping(ws_server):
    c = WSClient(*ws_server.address)
    try:
        op, hello = c.read_frame()
        hello = json.loads(hello)
        assert hello["hello"] == "openpbso-tpu" and hello["block_size"] == \
            BLOCK and hello["channels"] == 2 and hello["objects"] == 2
        c.send(cmd="hit_space", obj=0, space=[1.0] * MODES,
               kind="gaussian", width_us=2000.0)
        assert wait_for(lambda: float(np.abs(c.read_block()).max()) > 0)
        c.sock.sendall(mask_frame(tws.OP_PING, b"are you there"))
        while True:
            op, payload = c.read_frame()
            if op == tws.OP_PONG:
                assert payload == b"are you there"
                break
        c.send(cmd="stats")
        assert wait_for(lambda: c.read_block() is not None and any(
            "health" in m for m in c.messages))
    finally:
        c.close()


def test_oversized_frame_drops_only_that_client(ws_server):
    c = WSClient(*ws_server.address)
    c.read_frame()
    c.sock.sendall(bytes([0x81, 0x80 | 127]) + struct.pack(">Q", 1 << 40)
                   + b"\x00" * 4)
    with contextlib.suppress(ConnectionError, OSError):
        for _ in range(100000):
            c.read_frame()
    c.sock.close()
    c2 = WSClient(*ws_server.address)
    try:
        op, hello = c2.read_frame()
        assert op == tws.OP_TEXT and b"sample_rate" in hello
    finally:
        c2.close()


def test_ws_broadcast_restart_and_colour_feed(tmp_path):
    """The broadcast bridge with a model and FFAT maps: the transfer-ball
    colour feed (qnorm telemetry) reaches the browser as one value per
    icosphere vertex, and an elastic engine restart keeps the browser
    connected."""
    from openpbso_tpu_torch.io.meta import resolve_model_dir
    from openpbso_tpu_torch.models.modal_model import load_model
    from openpbso_tpu_torch.ops.coeffs import bank_from_material
    from openpbso_tpu_torch.ops.ffat import build_ffat
    from openpbso_tpu_torch.runtime.session import ModalSession
    from openpbso_tpu_torch.runtime.solver import SolverConfig
    from openpbso_tpu_torch.utils.synth import synth_model_dir
    root = str(tmp_path / "m")
    synth_model_dir(root, "m", num_modes=12, subdivisions=1, ffat_n=8,
                    seed=3)
    model = load_model(resolve_model_dir(root, "m"))

    def factory():
        bank = bank_from_material(
            model.material.density,
            model.modes.omega_squared[: model.num_modes_audible],
            model.material.alpha, model.material.beta, block_size=BLOCK,
            device="cpu")
        ffat = build_ffat(model.ffat_maps, bank.num_modes, device="cpu")
        sess = ModalSession(bank, ffat=ffat, config=SolverConfig(
            block_size=BLOCK, backend="blocked"))
        sess.set_listener(np.array([0.8, 0.3, 0.2]))
        return sess

    srv = tws.BroadcastWebSocketAudioServer(factory, model=model,
                                            pace_lead=0.05, qnorm_every=2)
    t = start(srv)
    c = WSClient(*srv.address)
    try:
        c.send(cmd="hit", obj=0, vertex=2, kind="gaussian", width_us=900.0)

        def colours():
            c.read_block()
            return any("ball_colors" in m for m in c.messages)
        assert wait_for(colours)
        col = next(m["ball_colors"] for m in c.messages
                   if "ball_colors" in m)
        v = srv._ball_mesh[0]
        assert len(col) == v.shape[0] and np.isfinite(col).all()
        c.send(cmd="ball")
        assert wait_for(lambda: c.read_block() is not None and any(
            "ball" in m for m in c.messages))
        ball = next(m["ball"] for m in c.messages if "ball" in m)
        assert ball["has_transfer"]
        engine = srv._engine
        engine.error = RuntimeError("injected failure")
        engine._stop.set()
        assert wait_for(lambda: c.read_block() is not None and any(
            "restarted" in m for m in c.messages))
        assert srv.restarts == 1
        c.messages.clear()
        c.send(cmd="stats")
        assert wait_for(lambda: c.read_block() is not None and any(
            "health" in m for m in c.messages))
    finally:
        c.close()
        srv.close()
        t.join(timeout=30)


def test_ws_pcm_wire_roundtrip_bit_exact():
    """A block through _WSSink's frame decodes to the same float32 bits."""
    a, b = socket.socketpair()
    sink = tws._WSSink(a, pace_lead=None)
    block = np.random.default_rng(1).standard_normal((BLOCK, 2)).astype(
        np.float32)
    assert sink.write(block)
    sink.send_json({"x": 1})
    a.close()
    c = WSClient.__new__(WSClient)
    c.sock, c._buf, c.channels, c.messages = b, b"", 2, []
    np.testing.assert_array_equal(c.read_block(), block)
    with pytest.raises(ConnectionError):
        c.read_block()
    assert c.messages == [{"x": 1}]
    b.close()
