"""WebSocket bridge + browser demo client for the audio server.

Counterpart of openpbso_tpu/runtime/wsbridge.py: the same frames, handshake
and demo page (``DEMO_PAGE`` is the reference's byte for byte, since the
browser client is part of the wire contract). The reference's interaction
surface is a native GUI window (real_time_modal_sound.cpp / ModalViewer); a
server deployment is headless, so this module serves the same engine to any
browser:

- ``GET /``            -> a self-contained demo page (WebAudio playback,
                          hit buttons, listener sliders)
- ``GET /ws`` (Upgrade) -> a WebSocket: binary frames carry float32 PCM
  blocks device->browser; text frames carry the same JSON command surface
  as runtime/server.py (hit / listener / sustain / stats / ...), dispatched
  through the exact same AudioServer._dispatch.

The WebSocket framing is implemented directly on the socket (RFC 6455:
handshake = SHA-1 accept key; server frames unmasked, client frames masked)
— no third-party dependency, matching the zero-install constraint.
"""
from __future__ import annotations

import base64
import hashlib
import json
import socket
import struct
import threading

import numpy as np

from ..config import SAMPLE_RATE
from .server import AudioServer, BroadcastAudioServer, RealTimePacer

_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = 0x1, 0x2, 0x8, 0x9, 0xA


def ws_accept_key(client_key: str) -> str:
    digest = hashlib.sha1((client_key + _WS_GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def encode_frame(opcode: int, payload: bytes) -> bytes:
    """Server->client frame (FIN set, never masked)."""
    head = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        head += bytes([n])
    elif n < (1 << 16):
        head += bytes([126]) + struct.pack(">H", n)
    else:
        head += bytes([127]) + struct.pack(">Q", n)
    return head + payload


class _FrameReader:
    """Incremental client->server frame parser (handles masking).

    Client frames carry only JSON commands, so payloads are capped at
    ``max_len`` — a declared length beyond it is a protocol violation,
    not a reason to allocate gigabytes.
    """

    def __init__(self, conn: socket.socket, max_len: int = 1 << 20):
        self._conn = conn
        self._buf = b""
        self._max_len = max_len
        # in-progress fragmented message (RFC 6455 section 5.4): control
        # frames may interleave, so the reassembly lives on the reader
        self._frag_op: int | None = None
        self._frag = b""

    def _need(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self._conn.recv(65536)
            if not chunk:
                raise ConnectionError("websocket closed")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def read_frame(self) -> tuple[int, bytes]:
        """Returns (opcode, unmasked payload) of the next complete
        MESSAGE. Fragmented messages (FIN=0 + CONTINUATION frames, RFC
        6455 section 5.4 — some proxies/client libraries fragment larger
        commands) reassemble here; control frames may interleave between
        fragments and return immediately (the in-progress reassembly
        persists on the reader across those returns)."""
        while True:
            fin, opcode, payload = self._read_raw()
            if opcode >= OP_CLOSE:   # control frames never fragment
                return opcode, payload
            if self._frag_op is None:
                if fin:
                    return opcode, payload
                self._frag_op, self._frag = opcode, payload
                continue
            if opcode != 0:
                raise ConnectionError(
                    "websocket protocol violation: new data frame before "
                    "the previous fragmented message finished")
            self._frag += payload
            if len(self._frag) > self._max_len:
                raise ConnectionError("websocket message too large")
            if fin:
                op, out = self._frag_op, self._frag
                self._frag_op, self._frag = None, b""
                return op, out

    def _read_raw(self) -> tuple[bool, int, bytes]:
        """One wire frame: (fin, opcode, unmasked payload)."""
        b0, b1 = self._need(2)
        fin = bool(b0 & 0x80)
        opcode = b0 & 0x0F
        masked = bool(b1 & 0x80)
        n = b1 & 0x7F
        if n == 126:
            (n,) = struct.unpack(">H", self._need(2))
        elif n == 127:
            (n,) = struct.unpack(">Q", self._need(8))
        if n > self._max_len:
            raise ConnectionError(f"websocket frame too large ({n} bytes)")
        mask = self._need(4) if masked else b"\x00" * 4
        payload = self._need(n)
        if masked:
            payload = (np.frombuffer(payload, np.uint8)
                       ^ np.resize(np.frombuffer(mask, np.uint8),
                                   n)).tobytes() if n else b""
        return fin, opcode, payload


class _WSSink:
    """Audio sink writing PCM as binary websocket frames.

    Writes are paced to real time plus a small lead (server.RealTimePacer
    has the rationale): the browser plays at the sample rate, so an
    unpaced stream only grows client latency — and on a small host it
    lets the synthesis thread starve the command dispatcher of CPU.
    """

    def __init__(self, conn: socket.socket, send_timeout: float = 5.0,
                 pace_lead: float | None = 0.3):
        self._conn = conn
        conn.settimeout(send_timeout)
        self._lock = threading.Lock()
        self.closed = False
        self._pacer = RealTimePacer(pace_lead)

    def _send(self, frame: bytes) -> bool:
        try:
            with self._lock:
                self._conn.sendall(frame)
            return True
        except (OSError, socket.timeout):
            self.closed = True
            return False

    def write(self, block: np.ndarray) -> bool:
        self._pacer.pace(np.shape(block)[0])
        data = np.ascontiguousarray(block, "<f4").tobytes()
        return self._send(encode_frame(OP_BINARY, data))

    def send_json(self, obj) -> None:
        self._send(encode_frame(OP_TEXT, json.dumps(obj).encode()))

    def pong(self, payload: bytes) -> None:
        self._send(encode_frame(OP_PONG, payload))

    def close(self) -> None:
        self._send(encode_frame(OP_CLOSE, b""))


def start_color_pusher(server, engine_getter, send, interval=0.15):
    """qnorm -> transfer-ball color poll loop, shared by the single-client
    and broadcast WS servers (the reference colors its icosphere from
    qnorm each frame, real_time_modal_sound.cpp:917-979).

    ``engine_getter`` re-fetches the current engine each tick so an
    elastic engine restart keeps the feed alive. Returns (thread, stop).
    """
    stop = threading.Event()

    def loop():
        server._ball_payload(engine_getter())  # warm mesh+transfer cache
        import time as _time
        while not stop.is_set():
            eng = engine_getter()
            if eng is not None:
                q = eng.latest_qnorm()
                if q is not None:
                    c = server.ball_colors(q)
                    if c is not None:
                        send({"ball_colors":
                              np.asarray(c, np.float32).tolist()})
            _time.sleep(interval)

    t = threading.Thread(target=loop, daemon=True)
    t.start()
    return t, stop


class WebSocketAudioServer(AudioServer):
    """AudioServer speaking HTTP/WebSocket instead of raw framing.

    Reuses AudioServer's engine lifecycle and command dispatch; only the
    transport differs. ``GET /`` serves the demo page.
    """

    def _upgrade(self, conn: socket.socket) -> bool:
        """Serve the demo page / 400s, or complete the WS handshake.

        Returns True when the socket is now an upgraded WebSocket; False
        when the request was already answered (page, 404, 400)."""
        conn.settimeout(10.0)
        req = b""
        while b"\r\n\r\n" not in req:
            chunk = conn.recv(8192)
            if not chunk:
                return False
            req += chunk
        head = req.split(b"\r\n\r\n", 1)[0].decode("latin-1")
        lines = head.split("\r\n")
        parts = lines[0].split(" ")
        if parts[0] != "GET" or len(parts) < 2:
            conn.sendall(b"HTTP/1.1 400 Bad Request\r\n"
                         b"Content-Length: 0\r\nConnection: close\r\n\r\n")
            return False
        path = parts[1]
        headers = {}
        for ln in lines[1:]:
            if ":" in ln:
                k, v = ln.split(":", 1)
                headers[k.strip().lower()] = v.strip()

        if headers.get("upgrade", "").lower() != "websocket":
            body = DEMO_PAGE.encode()
            status = b"200 OK" if path == "/" else b"404 Not Found"
            if path != "/":
                body = b"openpbso-tpu: connect a WebSocket at /ws"
            conn.sendall(b"HTTP/1.1 " + status +
                         b"\r\nContent-Type: text/html; charset=utf-8"
                         b"\r\nContent-Length: " +
                         str(len(body)).encode() +
                         b"\r\nConnection: close\r\n\r\n" + body)
            return False

        key = headers.get("sec-websocket-key", "")
        conn.sendall(
            b"HTTP/1.1 101 Switching Protocols\r\n"
            b"Upgrade: websocket\r\nConnection: Upgrade\r\n"
            b"Sec-WebSocket-Accept: " + ws_accept_key(key).encode() +
            b"\r\n\r\n")
        return True

    def _handle(self, conn: socket.socket) -> None:
        if not self._upgrade(conn):
            return

        from .engine import StreamingEngine
        session = self._make_session()
        sink = _WSSink(conn)
        sink.send_json({"hello": "openpbso-tpu",
                        "sample_rate": SAMPLE_RATE,
                        "channels": int(session.gains.shape[-1]),
                        "block_size": session.config.block_size,
                        "modes": int(session.bank.num_modes),
                        "objects": int(session.bank.num_objects),
                        "has_positions":
                            self._positions is not None})
        engine = StreamingEngine(
            session, sink, lookahead=self._lookahead,
            qnorm_every=self._qnorm_every,
            post_mix=(self._post_mix_factory()
                      if self._post_mix_factory else None))
        engine.start()
        reader = _FrameReader(conn)
        pusher = None
        if self._qnorm_every > 0 and session.ffat is not None \
                and self._model is not None:
            # transfer-ball HUD feed: color the icosphere by the latest
            # per-mode energy telemetry (real_time_modal_sound.cpp:960-979)
            pusher = start_color_pusher(self, lambda: engine,
                                        sink.send_json)
        try:
            while not sink.closed and engine.healthy:
                try:
                    opcode, payload = reader.read_frame()
                except socket.timeout:
                    continue
                except (ConnectionError, OSError):
                    break   # client reset must end this connection only
                if opcode == OP_CLOSE:
                    break
                if opcode == OP_PING:
                    sink.pong(payload)
                    continue
                if opcode == OP_TEXT and payload.strip():
                    if self._dispatch(engine, sink, payload):
                        break
            if not engine.healthy and engine.error is not None:
                sink.send_json({"error": f"synthesis failed: "
                                         f"{engine.error!r}"})
        finally:
            if pusher is not None:
                pusher[1].set()
                pusher[0].join(timeout=5.0)
            self._stop_motion_ticker()   # per-connection kinematics
            # stop synthesis FIRST so no PCM frame follows the CLOSE frame
            engine.stop()
            sink.close()


# The browser viewer: the reference's interactive surface re-hosted in a
# self-contained page (no JS dependencies, software-projected canvas 3D):
#   - mesh viewport with orbit camera; orbiting moves the listener
#     (computeTransfer on camera move, real_time_modal_sound.cpp:1166-1175)
#   - shift-click ray-pick -> face + barycentric -> hit_face
#     (CurrentMouseSurfPos / GetModalForceFace, :162-185, 236-266)
#   - shift-drag -> sustained AR contact with mouse-velocity scaling
#     (:1126-1160); keys 1/2/3 pick the force type (:1052-1063),
#     'd' repeats the last hit (:1111-1118)
#   - gaussian width slider 10-500 us (:783-792)
#   - mode-shape animation viewer with scale control (:855-884, 1037-1046)
#   - transfer-ball HUD colored live from qnorm telemetry (:917-979)
#   - buffer-health bar (:818-831)
DEMO_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>openpbso-tpu live demo</title>
<style>
 body{font-family:system-ui,sans-serif;background:#14161a;color:#dfe3ea;
      max-width:860px;margin:1.2rem auto;padding:0 1rem}
 button{font-size:1rem;padding:.45rem 1rem;margin:.2rem;border:0;
        border-radius:.5rem;background:#3b82f6;color:#fff;cursor:pointer}
 button:disabled{background:#444}
 canvas{background:#0b0d10;border-radius:.5rem;touch-action:none}
 #row{display:flex;gap:1rem;align-items:flex-start;flex-wrap:wrap}
 #side{width:200px}
 label{font-size:.85rem;color:#9aa3b2;display:block;margin-top:.5rem}
 input[type=range]{width:100%}
 #log{font-family:ui-monospace,monospace;font-size:.8rem;color:#9aa3b2;
      white-space:pre-line;margin-top:.6rem;max-height:8rem;overflow:auto}
 .bar{height:10px;background:#222;border-radius:5px;overflow:hidden}
 .bar>div{height:100%;width:0;background:#22c55e}
 #help{font-size:.8rem;color:#7b8494}
</style></head><body>
<h3>openpbso-tpu &mdash; live modal synthesis</h3>
<div id="help">shift-click: strike &middot; shift-drag: sustained contact
 &middot; drag: orbit (moves listener) &middot; alt-drag: move object
 (release fast to THROW &mdash; the server integrates the flight;
 alt-grab catches it)
 &middot; keys 1/2/3/4: point/gaussian/AR/hertz &middot; d: repeat hit</div>
<button id="start">connect + start audio</button>
<span id="ftype">force: gaussian</span>
<div id="row">
 <canvas id="view" width="520" height="390"></canvas>
 <div id="side">
  <canvas id="ball" width="150" height="150"></canvas>
  <label>gaussian width <span id="wv">200</span> &micro;s
   <input id="width" type="range" min="10" max="500" value="200"></label>
  <label>mode shape <input id="mode" type="number" min="-1" value="-1"
   style="width:4.5rem"> (-1 off)</label>
  <label>shape scale <input id="mscale" type="range" min="1" max="100"
   value="30"></label>
  <label>buffer health</label><div class="bar"><div id="meter"></div></div>
  <label>transfer per mode (log)
   <input id="comp" type="checkbox"> compressed Psi</label>
  <canvas id="hist" width="200" height="70"></canvas>
 </div>
</div>
<div id="log"></div>
<script>
'use strict';
let ws=null,actx=null,info=null,t=0;
let scenes=[],ball=null,ballColors=null,modeShape=null;
let yaw=0.9,pitch=0.4,dist=3.2,center=[0,0,0],radius=1;
let forceKind='gaussian',lastHit=null,dragging=false,orbiting=false;
let movingObj=null;   // alt-drag object motion (server cmds object_pos
                      // while held, object_vel on a fast release: fling)
const S={blocks:0,peak:0,connected:false,lastPick:null,health:1};
window.state=S;
const $=id=>document.getElementById(id);
const log=m=>{$('log').textContent=(m+"\\n"+
  $('log').textContent).slice(0,2000)};
const send=o=>{if(ws&&ws.readyState===1){ws.send(JSON.stringify(o));
  return true}return false};
window.send=send;
// ---- vec helpers ----
const sub=(a,b)=>[a[0]-b[0],a[1]-b[1],a[2]-b[2]];
const add=(a,b)=>[a[0]+b[0],a[1]+b[1],a[2]+b[2]];
const mul=(a,s)=>[a[0]*s,a[1]*s,a[2]*s];
const dot=(a,b)=>a[0]*b[0]+a[1]*b[1]+a[2]*b[2];
const cross=(a,b)=>[a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],
                    a[0]*b[1]-a[1]*b[0]];
const norm=a=>{const n=Math.hypot(a[0],a[1],a[2])||1;return mul(a,1/n)};
// ---- camera ----
const FOV=Math.PI/4;
function camera(w,h){
  const cp=Math.cos(pitch),sp=Math.sin(pitch);
  const eye=add(center,mul([cp*Math.cos(yaw),sp,cp*Math.sin(yaw)],
                           dist*radius));
  const fwd=norm(sub(center,eye));
  const right=norm(cross(fwd,[0,1,0]));
  const up=cross(right,fwd);
  const tf=Math.tan(FOV/2),aspect=w/h;
  return {eye,fwd,right,up,tf,aspect,w,h};
}
function project(c,p){
  const q=sub(p,c.eye);
  const z=dot(q,c.fwd);
  if(z<1e-4)return null;
  return [(dot(q,c.right)/(z*c.tf*c.aspect)+1)/2*c.w,
          (1-dot(q,c.up)/(z*c.tf))/2*c.h,z];
}
function pixelRay(c,x,y){
  const nx=2*x/c.w-1,ny=1-2*y/c.h;
  return {o:c.eye,d:norm(add(c.fwd,add(mul(c.right,nx*c.tf*c.aspect),
                                       mul(c.up,ny*c.tf))))};
}
// ---- Moller-Trumbore ray pick: face + barycentric (the browser side of
// igl::unproject_onto_mesh, real_time_modal_sound.cpp:162-185) ----
function pick(x,y){
  if(!scenes.length)return null;
  const c=camera($('view').width,$('view').height);
  const r=pixelRay(c,x,y);
  let best=null;
  for(const sc of scenes){
    if(!sc)continue;
    for(let f=0;f<sc.nf;f++){
      const v0=sc.wvert(sc.f[3*f]),e1=sub(sc.wvert(sc.f[3*f+1]),v0),
            e2=sub(sc.wvert(sc.f[3*f+2]),v0);
      const pv=cross(r.d,e2),det=dot(e1,pv);
      if(Math.abs(det)<1e-12)continue;
      const inv=1/det,tv=sub(r.o,v0);
      const u=dot(tv,pv)*inv;if(u<0||u>1)continue;
      const qv=cross(tv,e1);
      const v=dot(r.d,qv)*inv;if(v<0||u+v>1)continue;
      const tt=dot(e2,qv)*inv;
      if(tt>1e-6&&(!best||tt<best.t))
        best={t:tt,obj:sc.obj,face:f,bary:[1-u-v,u,v]};
    }
  }
  return best;
}
window.pick=pick;
// ---- render loop ----
function shade(base,d){const k=0.35+0.65*Math.max(0,d);
  return `rgb(${base[0]*k|0},${base[1]*k|0},${base[2]*k|0})`}
function drawMeshes(cv,items){
  // items: [{vertFn, faces, nf, base, colors?}] — all objects of the
  // scene depth-sort into ONE triangle list so they occlude each other
  const g=cv.getContext('2d');
  g.clearRect(0,0,cv.width,cv.height);
  const c=camera(cv.width,cv.height);
  const light=norm([0.4,0.8,0.5]);
  const tris=[];
  for(const it of items){
    if(!it||!it.faces)continue;
    for(let f=0;f<it.nf;f++){
      const p=[it.vertFn(it.faces[3*f]),it.vertFn(it.faces[3*f+1]),
               it.vertFn(it.faces[3*f+2])];
      const s=[project(c,p[0]),project(c,p[1]),project(c,p[2])];
      if(!s[0]||!s[1]||!s[2])continue;
      const n=norm(cross(sub(p[1],p[0]),sub(p[2],p[0])));
      if(dot(n,sub(c.eye,p[0]))<0)continue;   // backface
      tris.push({z:(s[0][2]+s[1][2]+s[2][2])/3,s,
                 col:it.colors?it.colors(f):shade(it.base,dot(n,light))});
    }
  }
  tris.sort((a,b)=>b.z-a.z);
  for(const tr of tris){
    g.beginPath();g.moveTo(tr.s[0][0],tr.s[0][1]);
    g.lineTo(tr.s[1][0],tr.s[1][1]);g.lineTo(tr.s[2][0],tr.s[2][1]);
    g.closePath();g.fillStyle=tr.col;g.fill();
    g.strokeStyle='rgba(0,0,0,0.25)';g.stroke();}
}
const PALETTE=[[92,140,230],[230,140,92],[120,200,140],[200,120,200],
               [220,200,90],[90,200,210]];
function frame(ts){
  if(scenes.length){
    const k=parseInt($('mode').value);
    const items=scenes.filter(Boolean).map(sc=>{
      let vf=i=>sc.wvert(i);
      if(modeShape&&modeShape.mode===k&&k>=0
         &&(modeShape.obj||0)===sc.obj){
        const s=$('mscale').value/100*radius*0.5;
        const ph=Math.cos(2*Math.PI*1.5*ts/1000);  // slowed visual rate
        vf=i=>{const v=sc.wvert(i);
          return [v[0]+s*ph*modeShape.disp[3*i],
                  v[1]+s*ph*modeShape.disp[3*i+1],
                  v[2]+s*ph*modeShape.disp[3*i+2]]}
      }
      return {vertFn:vf,faces:sc.f,nf:sc.nf,
              base:PALETTE[sc.obj%PALETTE.length]};
    });
    drawMeshes($('view'),items);
  }
  if(ball){
    const bc=$('ball');
    let colors=null;
    if(ballColors){
      let lo=1e30,hi=-1e30;
      for(const v of ballColors){lo=Math.min(lo,v);hi=Math.max(hi,v);}
      const span=Math.max(hi-lo,1e-6);
      colors=f=>{const i0=ball.f[3*f];
        const w=(ballColors[i0]-lo)/span;
        return `rgb(${(40+215*w)|0},${60|0},${(255-200*w)|0})`};
    }
    // the HUD ball orbits with the same camera (viewport 2 of the
    // reference's 3-viewport layout)
    drawMeshes(bc,[{vertFn:i=>ball.vert(i),faces:ball.f,nf:ball.nf,
                    base:[150,150,160],colors}]);
  }
  requestAnimationFrame(frame);
}
requestAnimationFrame(frame);
// ---- transfer histogram (per-mode |transfer|, log scale) ----
function drawHist(h){
  const c=$('hist'),g=c.getContext('2d');
  g.clearRect(0,0,c.width,c.height);
  const v=h.values,n=v.length;if(!n)return;
  let lo=1e30,hi=-1e30;
  const lg=v.map(x=>Math.log10(Math.max(x,1e-12)));
  for(const x of lg){lo=Math.min(lo,x);hi=Math.max(hi,x);}
  const span=Math.max(hi-lo,1e-6),w=c.width/n;
  g.fillStyle=h.compressed?'#eab308':'#22c55e';
  for(let i=0;i<n;i++){
    const t2=(lg[i]-lo)/span,bh=2+t2*(c.height-4);
    g.fillRect(i*w,c.height-bh,Math.max(w-1,1),bh);}
  $('comp').checked=!!h.compressed;
}
// ---- audio ----
function play(f32){
  const ch=info.channels,n=f32.length/ch;
  const buf=actx.createBuffer(ch,n,info.sample_rate);
  for(let c=0;c<ch;c++){const d=buf.getChannelData(c);
    for(let i=0;i<n;i++)d[i]=f32[i*ch+c];}
  const src=actx.createBufferSource();src.buffer=buf;
  src.connect(actx.destination);
  if(t<actx.currentTime)t=actx.currentTime+0.05;
  src.start(t);t+=n/info.sample_rate;
}
// ---- wire ----
function wrapMesh(m){
  const v=new Float32Array(m.vertices),f=new Int32Array(m.faces);
  return {v,f,nf:f.length/3,vert:i=>[v[3*i],v[3*i+1],v[3*i+2]]};
}
$('start').onclick=async()=>{
  actx=new AudioContext();await actx.resume();
  ws=new WebSocket(`ws://${location.host}/ws`);
  ws.binaryType='arraybuffer';
  ws.onopen=()=>{};
  ws.onmessage=ev=>{
    if(typeof ev.data==='string'){
      const m=JSON.parse(ev.data);
      if(m.hello){info=m;S.connected=true;log('connected: '+ev.data);
        // fetch one mesh per object only when the server knows distinct
        // world positions (--scene); otherwise N instances of one model
        // would draw as N coincident copies at the origin
        const no=m.has_positions?Math.min(m.objects||1,24):1;
        if(m.has_positions&&(m.objects||1)>24)
          log(`scene has ${m.objects} objects; drawing first 24`);
        for(let k=0;k<no;k++)send({cmd:'scene',obj:k});
        send({cmd:'ball'});
        setInterval(()=>send({cmd:'stats'}),2000);
        // per-mode transfer histogram feed (the reference's ImGui
        // PlotHistogram next to the compressed toggle)
        setInterval(()=>send({cmd:'transfer_hist'}),1000);
        $('comp').onchange=()=>send({cmd:'transfer',
                                     compressed:$('comp').checked});}
      else if(m.scene){
        const sc=wrapMesh(m.scene);
        sc.obj=m.scene.obj||0;sc.modes=m.scene.modes_audible;
        sc.pos=m.scene.position||[0,0,0];
        sc.wvert=i=>add(sc.vert(i),sc.pos);   // world-space vertex
        scenes[sc.obj]=sc;
        let lo=[1e9,1e9,1e9],hi=[-1e9,-1e9,-1e9];
        for(const s2 of scenes){if(!s2)continue;
          for(let i=0;i<s2.v.length/3;i++){const p=s2.wvert(i);
            for(let a=0;a<3;a++){lo[a]=Math.min(lo[a],p[a]);
              hi[a]=Math.max(hi[a],p[a]);}}}
        center=mul(add(lo,hi),0.5);
        radius=Math.hypot(hi[0]-lo[0],hi[1]-lo[1],hi[2]-lo[2])/2||1;
        S.scene=true;S.nScenes=scenes.filter(Boolean).length;
        log(`obj ${sc.obj}: ${sc.v.length/3} verts, `+
          `${sc.nf} faces, ${sc.modes} modes`);
        sendListener();}
      else if(m.ball){ball=wrapMesh(m.ball);S.ball=true;}
      else if(m.transfer_hist){drawHist(m.transfer_hist);S.hist=true;}
      else if(m.ball_colors){ballColors=m.ball_colors;S.ballColors=true;}
      else if(m.mode_shape){modeShape=m.mode_shape;
        log(`mode ${m.mode_shape.mode}: ${m.mode_shape.freq_hz.toFixed(1)} Hz`);}
      else if(m.health!==undefined){S.health=m.health;
        $('meter').style.width=(m.health*100)+'%';}
      else log('server: '+ev.data);
      return;}
    const f32=new Float32Array(ev.data);
    S.blocks++;
    let p=0;for(const v of f32)p=Math.max(p,Math.abs(v));
    S.peak=Math.max(S.peak,p);
    play(f32);
  };
  ws.onclose=()=>{S.connected=false;log('closed');};
};
// ---- listener follows the orbit camera ----
let listenerTimer=null;
function sendListener(){
  if(listenerTimer)return;
  // trailing-edge debounce: capture the camera INSIDE the timeout so the
  // final resting position of an orbit is what actually gets sent
  listenerTimer=setTimeout(()=>{listenerTimer=null;
    send({cmd:'listener',pos:camera(1,1).eye});},100);
}
// ---- mouse: orbit / pick / sustained drag ----
const view=$('view');
let lastXY=null,lastDragT=0;
view.onpointerdown=e=>{
  const r=view.getBoundingClientRect();
  const x=e.clientX-r.left,y=e.clientY-r.top;
  lastXY=[x,y];
  if(e.altKey){
    // alt-drag: move the picked object in its camera-depth plane
    const hit=pick(x,y);
    if(hit&&scenes[hit.obj]){
      const c=camera(view.width,view.height);
      const r2=pixelRay(c,x,y);
      const hp=add(r2.o,mul(r2.d,hit.t));
      movingObj={obj:hit.obj,depth:hit.t,off:sub(scenes[hit.obj].pos,hp),
                 hist:[]};
      // grabbing CATCHES a flying object (server-integrated object_vel)
      send({cmd:'object_vel',obj:hit.obj,vel:[0,0,0]});
    }
  } else if(e.shiftKey){
    const hit=pick(x,y);S.lastPick=hit;
    if(hit){
      if(forceKind==='ar'){dragging=true;
        send({cmd:'sustain',obj:hit.obj,face:hit.face,bary:hit.bary});}
      else{lastHit={cmd:'hit',obj:hit.obj,face:hit.face,bary:hit.bary,
        kind:forceKind,width_us:+$('width').value};send(lastHit);}
    }
  } else orbiting=true;
  view.setPointerCapture(e.pointerId);
};
view.onpointermove=e=>{
  const r=view.getBoundingClientRect();
  const x=e.clientX-r.left,y=e.clientY-r.top;
  if(orbiting&&lastXY){
    yaw+=(x-lastXY[0])*0.01;
    pitch=Math.max(-1.4,Math.min(1.4,pitch+(y-lastXY[1])*0.01));
    sendListener();
  } else if(movingObj){
    const now=performance.now();
    if(now-lastDragT>66){
      lastDragT=now;
      const c=camera(view.width,view.height);
      const r2=pixelRay(c,x,y);
      const p=add(add(r2.o,mul(r2.d,movingObj.depth)),movingObj.off);
      const sc=scenes[movingObj.obj];
      if(sc)sc.pos=p;            // draw at the new spot immediately
      send({cmd:'object_pos',obj:movingObj.obj,pos:p});
      movingObj.hist.push([now,p]);          // fling velocity window
      if(movingObj.hist.length>4)movingObj.hist.shift();
    }
  } else if(dragging&&lastXY){
    const now=performance.now();
    if(now-lastDragT>33){
      lastDragT=now;
      const hit=pick(x,y);
      if(hit){
        // normalized mouse speed scales the sustained force (the
        // reference's velocity drag, real_time_modal_sound.cpp:1126-1160)
        const vel=Math.min(1,Math.hypot(x-lastXY[0],y-lastXY[1])/30);
        send({cmd:'drag',obj:hit.obj,face:hit.face,bary:hit.bary,vel});
      }
    }
  }
  if(orbiting||dragging)lastXY=[x,y];
};
view.onpointerup=e=>{
  if(dragging)send({cmd:'release',
                    obj:S.lastPick?S.lastPick.obj:0});
  if(movingObj&&movingObj.hist.length>=2){
    // fast release = THROW: the server integrates the flight from here
    // (object_vel; Doppler rides the audio clock, transfer the ticker)
    const h=movingObj.hist,a=h[0],b=h[h.length-1];
    const dt=(b[0]-a[0])/1000;
    if(dt>0.02){
      let v=mul(sub(b[1],a[1]),1/dt);
      const sp=Math.hypot(v[0],v[1],v[2]);
      if(sp>0.5){
        if(sp>8)v=mul(v,8/sp);     // clamp to a sane room-scale speed
        send({cmd:'object_vel',obj:movingObj.obj,vel:v});
      }
    }
  }
  dragging=false;orbiting=false;movingObj=null;lastXY=null;
};
window.onkeydown=e=>{
  if(e.key==='1')forceKind='point';
  else if(e.key==='2')forceKind='gaussian';
  else if(e.key==='3')forceKind='ar';
  else if(e.key==='4')forceKind='hertz';
  else if(e.key==='d'&&lastHit)send(lastHit);
  $('ftype').textContent='force: '+forceKind;
};
$('width').oninput=e=>$('wv').textContent=e.target.value;
$('mode').onchange=e=>{const k=+e.target.value;
  // the mode-shape viewer animates the most recently picked object
  if(k>=0)send({cmd:'mode_shape',mode:k,
                obj:S.lastPick?S.lastPick.obj:0});
  else modeShape=null;};
</script></body></html>
"""


class BroadcastWebSocketAudioServer(BroadcastAudioServer,
                                    WebSocketAudioServer):
    """One engine, many browsers: the WS transport of BroadcastAudioServer.

    Inherits the broadcast machinery (fan-out hub with real-time pacing,
    bounded per-client queues, elastic engine restart on synthesis
    failure) from BroadcastAudioServer and the HTTP/WS handshake + demo
    page from WebSocketAudioServer. The transfer-ball telemetry pusher
    runs once server-side and broadcasts colors to everyone (per-client
    pushers would steal each other's qnorm messages); a mid-stream engine
    restart keeps every browser connected.
    """

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._pusher = None

    def _after_engine_start(self, engine) -> None:
        if self._pusher is not None or self._qnorm_every <= 0 \
                or engine.session.ffat is None or self._model is None:
            return
        self._pusher = start_color_pusher(self, lambda: self._engine,
                                          self._fanout.broadcast_json)

    def _serve_client(self, conn: socket.socket) -> None:
        from .server import _ClientStream
        engine = self._ensure_engine()
        try:
            upgraded = self._upgrade(conn)
        except OSError:
            upgraded = False
        if not upgraded:
            conn.close()
            return
        session = engine.session
        # per-client sink without its own pacing: the shared fan-out hub
        # paces the stream once for everyone
        sink = _WSSink(conn, pace_lead=None)
        slot = self._alloc_listener_slot()
        hello = {"hello": "openpbso-tpu",
                 "sample_rate": SAMPLE_RATE,
                 "channels": (2 if self._pcl
                              else int(session.gains.shape[-1])),
                 "block_size": session.config.block_size,
                 "modes": int(session.bank.num_modes),
                 "objects": int(session.bank.num_objects),
                 "has_positions": self._positions is not None}
        if self._pcl:
            hello["listener_slot"] = slot   # None = sharing slot 0's view
        sink.send_json(hello)
        client = _ClientStream(sink, depth=self._client_depth,
                               channel=(slot if slot is not None else
                                        (0 if self._pcl else None)))
        self._fanout.register(client)
        reader = _FrameReader(conn)
        try:
            # track the server's CURRENT engine so a mid-stream restart
            # does not disconnect the browser
            while not sink.closed and not self._dead and not self._closed:
                try:
                    opcode, payload = reader.read_frame()
                except socket.timeout:
                    continue
                except (ConnectionError, OSError):
                    break
                if opcode == OP_CLOSE:
                    break
                if opcode == OP_PING:
                    sink.pong(payload)
                    continue
                if opcode == OP_TEXT and payload.strip():
                    # shared routing with the raw transport: health
                    # check, per-client listener intercept, dispatch —
                    # one JSON parse (server._route_client_command)
                    if self._route_client_command(sink, slot, payload):
                        break
        finally:
            self._free_listener_slot(slot)
            self._fanout.unregister(client)
            sink.closed = True
            client.join()
            sink.close()
            conn.close()

    def close(self) -> None:
        if self._pusher is not None:
            self._pusher[1].set()
            self._pusher[0].join(timeout=5.0)
            self._pusher = None
        super().close()
