"""pbso-serve — network audio synthesis server CLI.

The port's counterpart of openpbso_tpu/apps/serve.py, with the same flags
but ``--device {cuda,cpu}`` (cuda by default) for ``--platform``. Serves a
model (or a generated synthetic one) over TCP: clients send JSON
commands (hit/listener/sustain/...) and receive the live PCM stream. See
runtime/server.py for the protocol.

    python -m openpbso_tpu_torch.apps.serve --demo-synth --port 9473
    python -m openpbso_tpu_torch.apps.serve -d /data/models -name wine
"""
from __future__ import annotations

import argparse

from ..config import DEFAULT_BLOCK, FILE_NOT_EXIST


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-d", dest="data_dir", default=FILE_NOT_EXIST)
    p.add_argument("-name", dest="obj_name", default=FILE_NOT_EXIST)
    p.add_argument("-m", dest="mesh", default=FILE_NOT_EXIST)
    p.add_argument("-s", dest="surf_mode", default=FILE_NOT_EXIST)
    p.add_argument("-t", dest="material", default=FILE_NOT_EXIST)
    p.add_argument("-p", dest="ffat_map", default=FILE_NOT_EXIST)
    p.add_argument("-tex", dest="obj_texture_map", default=FILE_NOT_EXIST)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=9473)
    p.add_argument("--block", type=int, default=DEFAULT_BLOCK)
    p.add_argument("--backend", default="auto",
                   choices=["auto", "blocked", "scan", "pallas"])
    p.add_argument("--instances", type=int, default=1)
    p.add_argument("--lookahead", type=int, default=1)
    p.add_argument("--no-transfer", action="store_true")
    p.add_argument("--listener", default="1.0,0.5,0.5",
                   help="initial listener position x,y,z")
    p.add_argument("--smooth-transfer", action="store_true",
                   help="ramp the transfer across the block after listener "
                        "moves")
    p.add_argument("--demo-synth", action="store_true")
    p.add_argument("--scene", default=None, metavar="SCENE_JSON",
                   help="serve a multi-model scene: JSON with "
                        "{'instances': [{'meta': path, 'position': [x,y,z],"
                        " 'gain': g, 'pan': p}, ...], optional "
                        "'listener_offsets' [[...]] or 'binaural': true, "
                        "'itd': true (interaural time differences), "
                        "'compressed': true (lookups read each model's "
                        "uint8-compressed maps)}")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--one-shot", action="store_true",
                   help="serve a single connection then exit")
    p.add_argument("--qnorm-every", type=int, default=None,
                   help="stream per-mode energy telemetry every N blocks "
                        "(transfer-ball HUD feed; default 8 with --web, "
                        "else off)")
    p.add_argument("--web", action="store_true",
                   help="speak HTTP/WebSocket instead of the raw protocol "
                        "and serve a browser demo page at /")
    p.add_argument("--multi-client", action="store_true",
                   help="broadcast ONE synthesis stream to many concurrent "
                        "clients (shared world/listener) instead of one "
                        "engine per connection")
    p.add_argument("--live-doppler", action="store_true",
                   help="apply LIVE physical Doppler to the stream (a "
                        "per-object fractional delay-line fed by listener "
                        "moves, ops/doppler.py; rides the span dispatch). "
                        "Composes with --per-client-listeners L (one delay "
                        "line per object-listener pair).")
    p.add_argument("--per-client-listeners", default="0", metavar="L",
                   help="with --multi-client: give each of up to L "
                        "concurrent clients its OWN listener (shared-state "
                        "multi-listener solver rows; each client hears its "
                        "own mix column). A comma list '2,4,8' makes L "
                        "DYNAMIC (the server grows to the next bucket when "
                        "full). Raw protocol or --web.")
    args = p.parse_args(argv)
    if "," in str(args.per_client_listeners):
        args.per_client_listeners = tuple(
            int(v) for v in str(args.per_client_listeners).split(","))
    else:
        args.per_client_listeners = int(args.per_client_listeners)
    if args.per_client_listeners:
        if not args.multi_client:
            raise SystemExit("--per-client-listeners needs --multi-client")
        pcl = args.per_client_listeners
        args.num_listeners = (min(pcl) if isinstance(pcl, tuple) else pcl)
        # --live-doppler composes with dynamic buckets here, unlike the
        # JAX package: a bucket grow rebuilds the post-mix through the
        # factory, which reads the grown session's L, and carries the old
        # one's delay lines into it (runtime/server.py
        # _grow_listener_slots)
    return args


def build_server(args):
    """Construct the configured AudioServer (split from main so tests can
    drive the full CLI wiring — scene rebuild carry-over, live-Doppler
    factory — without a subprocess)."""
    from .real_time_modal_sound import make_session, resolve_device
    from ..runtime.server import AudioServer

    device = resolve_device(args)   # raises here without a CUDA device

    if args.scene:
        import json as _json

        import numpy as np

        from ..io.meta import read_meta
        from ..models.modal_model import load_model
        from ..models.scene import Scene, SceneInstance
        from ..ops.ffat_fit import compress_map
        with open(args.scene) as f:
            desc = _json.load(f)

        compressed = bool(desc.get("compressed", False))

        def build_scene():
            cache = {}
            insts = []
            for inst in desc["instances"]:
                meta = inst["meta"]
                if meta not in cache:
                    cache[meta] = load_model(read_meta(meta))
                insts.append(SceneInstance(
                    cache[meta],
                    np.asarray(inst.get("position", (0.0, 0.0, 0.0)),
                               np.float64),
                    gain=float(inst.get("gain", 1.0)),
                    pan=float(inst.get("pan", 0.0))))
            offsets = desc.get("listener_offsets")
            binaural = bool(desc.get("binaural", False))
            if args.per_client_listeners:
                # per-client listeners: L independent world listeners
                # (zero offsets; the scene frame maps [L, 3] world rows
                # straight to per-object relative positions)
                if offsets is not None or binaural:
                    raise SystemExit("--per-client-listeners replaces the "
                                     "scene's own listener_offsets/"
                                     "binaural rows")
                offsets = [[0.0, 0.0, 0.0]] * int(args.num_listeners)
            # the models' maps through the uint8 quantisation (no image
            # codec), one dict a model in the order the scene meets them
            comp = ([{k: compress_map(v, jpeg_quality=None)
                      for k, v in mdl.ffat_maps.items()}
                     for mdl in cache.values()] if compressed else None)
            sc = Scene(
                insts, block_size=args.block, backend=args.backend,
                binaural=binaural,
                listener_offsets=offsets,
                use_ffat=not args.no_transfer,
                smooth_transfer=args.smooth_transfer,
                itd=bool(desc.get("itd", False)),
                compressed_maps=comp, use_compressed=compressed,
                device=device)
            sc.set_listener(np.asarray(
                [float(v) for v in args.listener.split(",")]))
            return sc

        first = build_scene()
        print(f"scene: {len(first.logical_instances)} instances, "
              f"{first.session.bank.num_objects} solver rows, "
              f"{first.session.gains.shape[-1]} channels")
        model = [i.model for i in first.instances]
        positions = [list(map(float, i.position)) for i in first.instances]
        scene_obj = first       # enables the object_pos live-motion cmd
        first.session.step()   # first use BEFORE accepting clients
        sessions = [first.session]
        # live world state shared with rebuilt engines: the server keeps
        # ``positions`` current (object_pos/object_vel), and after an
        # elastic restart the fresh scene must come back with THOSE
        # positions — not the JSON's initial layout — and the server's
        # _scene must rebind to it (the old scene's listener_frame died
        # with its session)
        scene_state = {"srv": None, "scene": first}

        def make(num_listeners=None):
            # dynamic per-client-listener buckets rebuild the scene with
            # a bigger L (the broadcast grow passes num_listeners); the
            # oscillator/force state transplant across the swap happens
            # at the session level in _grow_listener_slots
            if num_listeners is not None:
                args.num_listeners = num_listeners
            if sessions and (num_listeners is None or
                             sessions[-1].num_listeners == num_listeners):
                return sessions.pop()
            sc = build_scene()
            sc.positions[:] = np.asarray(positions, np.float64)
            prev = scene_state["scene"]
            lw = getattr(prev, "_last_world_listener", None)
            if lw is None:
                lw = np.asarray(
                    [float(v) for v in args.listener.split(",")])
            lw = np.asarray(lw, np.float64)
            if lw.ndim == 2 and lw.shape[0] == sc.session.num_listeners:
                # per-client rows survive the rebuild (same bucket)
                sc.session.set_listener(lw)
            elif lw.ndim == 2:
                # bucket size changed across the rebuild: keep row 0's
                # world position for everyone; the broadcast server
                # re-pushes its merged [L, 3] rows right after
                sc.set_listener(lw[0])
            else:
                sc.set_listener(lw)  # relative rows from LIVE positions
            scene_state["scene"] = sc
            if scene_state["srv"] is not None:
                scene_state["srv"]._scene = sc
            return sc.session

        load_from_meta = None
    else:
        scene_state = None
        positions = None
        scene_obj = None
        model, first_session = make_session(args)
        first_session.step()  # first use BEFORE accepting clients
        sessions = [first_session]

        def make(num_listeners=None):
            # dynamic per-client-listener buckets rebuild with a bigger L
            if num_listeners is not None:
                args.num_listeners = num_listeners
            if sessions:
                cached = sessions.pop()
                if (num_listeners is None
                        or cached.num_listeners == num_listeners):
                    return cached
            _, sess = make_session(args)
            return sess

        def load_from_meta(meta_path):
            # the ONE meta-to-session hot-swap recipe, shared with the
            # interactive CLI's 'load' command
            from .real_time_modal_sound import session_from_meta
            return session_from_meta(args, meta_path)

    cls = AudioServer
    if args.web and args.multi_client:
        from ..runtime.wsbridge import BroadcastWebSocketAudioServer
        cls = BroadcastWebSocketAudioServer
    elif args.web:
        from ..runtime.wsbridge import WebSocketAudioServer
        cls = WebSocketAudioServer
    elif args.multi_client:
        from ..runtime.server import BroadcastAudioServer
        cls = BroadcastAudioServer
    qnorm_every = args.qnorm_every
    if qnorm_every is None:
        qnorm_every = 8 if args.web else 0
    extra = {}
    if args.per_client_listeners:
        extra["per_client_listeners"] = args.per_client_listeners
    if args.live_doppler:
        import numpy as np

        from ..ops.doppler import DopplerPostMix
        n_rows = (len(positions) if positions is not None
                  else args.instances)

        def post_mix_factory():
            # read the LIVE per-row positions at build time: an elastic
            # engine restart mid-motion must come back with the moved
            # world, not the startup layout (the _MotionTicker re-pushes
            # velocities into the fresh post-mix on its next tick).
            # Scene runs keep the session's per-object gains (instance
            # gain/pan columns) since the post-mix REPLACES the session
            # mixdown; per-client runs (nl > 1) get one delay line per
            # (object, listener) and a [N, L] per-client mix. L is read at
            # build time: a listener-bucket grow raises it (make above).
            pos = (np.asarray(positions, np.float64)
                   if positions is not None else np.zeros((n_rows, 3)))
            gains = None
            nl_now = int(getattr(args, "num_listeners", 0) or 1)
            if scene_state is not None:
                sess = scene_state["scene"].session
                # the SESSION's listener count is authoritative: a scene
                # JSON with binaural/listener_offsets makes an L>1
                # shared-state session even without --per-client-listeners,
                # and the span feeds [O, L, N] — a single-listener post-mix
                # would rank-mismatch at the first dispatch. L>1 here gives
                # each (object, listener/ear) pair its own delay line.
                nl_now = sess.num_listeners
                gains = sess.gains
            return DopplerPostMix(pos, num_listeners=nl_now, gains=gains,
                                  device=device)

        extra["post_mix_factory"] = post_mix_factory
    srv = cls(make, model=model, host=args.host, port=args.port,
              lookahead=args.lookahead, session_loader=load_from_meta,
              qnorm_every=qnorm_every, positions=positions,
              scene=scene_obj, **extra)
    if scene_state is not None:
        scene_state["srv"] = srv   # rebind target for scene rebuilds
    return srv


def main(argv=None) -> int:
    args = parse_args(argv)
    srv = build_server(args)
    kind = "http/websocket" if args.web else "pbso protocol"
    print(f"serving {kind} on {srv.address[0]}:{srv.address[1]} "
          f"(block {args.block}, backend {args.backend})", flush=True)
    try:
        if args.one_shot:
            srv.serve_one()
        else:
            srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
