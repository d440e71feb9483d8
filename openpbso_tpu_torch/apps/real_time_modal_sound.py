"""real_time_modal_sound — interactive/streaming synthesizer CLI.

The port's counterpart of openpbso_tpu/apps/real_time_modal_sound.py, and
like it of the reference's main binary (tools/real_time_modal_sound.cpp). Mirrors its flag surface
(CreateParser, real_time_modal_sound.cpp:42-64):

  -d DIR        data directory containing the model (naming convention)
  -name NAME    object prefix name inside -d (e.g. wine)
  -m/-s/-t/-p   explicit mesh / modes / material / FFAT-dir paths
  -tex PATH     matcap texture for the 'preview' snapshot command

plus the JAX package's extras: --out WAV, --seconds, --block, --backend,
--instances (batch the model O times), --listener x,y,z, --no-transfer,
--interactive; its --platform is --device here (cuda, the default, or cpu).
``--backend pallas`` is read as the fused CUDA step
(ops/integrator.py::resolve_backend_name).

Without a display, interaction runs over stdin (one command per line):

  hit <obj> <vertex> [point|gaussian|hertz [width_us]]  strike the surface
  sustain <obj> <vertex>                            start sustained AR force
  arparam <obj> <a1> <a2> <sigma> <mu>              retune AR live
  release <obj>                                     end sustained force
  listener <x> <y> <z>                              move the listener
  transfer on|off                                   toggle FFAT transfer
  transfer compressed on|off                        raw vs compressed Psi
  clear                                             clear all forces
  stats                                             print health/latency
  qnorm                                             per-mode energy telemetry
  again | d                                         repeat the last hit
  preview [out.png]                                 matcap snapshot (-tex)
  load <file.meta>                                  hot-swap the model
  quit
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..config import DEFAULT_BLOCK, FILE_NOT_EXIST, SAMPLE_RATE
from ..io.meta import ModelPaths, resolve_model_dir
from ..models.modal_model import load_model


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="real_time_modal_sound",
        description="GPU real-time modal sound synthesizer "
                    "(flag-compatible with the openpbso reference tool)")
    p.add_argument("-d", dest="data_dir", default=FILE_NOT_EXIST,
                   help="Data directory that contains the model")
    p.add_argument("-name", dest="obj_name", default=FILE_NOT_EXIST,
                   help="Data object prefix name, e.g. wine")
    p.add_argument("-m", dest="mesh", default=FILE_NOT_EXIST,
                   help="Triangle mesh for the object")
    p.add_argument("-s", dest="surf_mode", default=FILE_NOT_EXIST,
                   help="surface modes file")
    p.add_argument("-t", dest="material", default=FILE_NOT_EXIST,
                   help="modal material file")
    p.add_argument("-p", dest="ffat_map", default=FILE_NOT_EXIST,
                   help="ffat map folder that contains *.fatcube files")
    p.add_argument("-tex", dest="obj_texture_map", default=FILE_NOT_EXIST,
                   help="matcap texture map, used by the interactive "
                        "'preview' snapshot (softrender matcap shading)")
    p.add_argument("--out", default="output.wav", help="output wav path")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--block", type=int, default=DEFAULT_BLOCK)
    p.add_argument("--backend", default="blocked",
                   choices=["blocked", "scan", "pallas"])
    p.add_argument("--instances", type=int, default=1,
                   help="number of batched instances of the model")
    p.add_argument("--listener", default="1.0,0.5,0.5",
                   help="listener position x,y,z")
    p.add_argument("--no-transfer", action="store_true",
                   help="use the unit transfer instead of FFAT maps")
    p.add_argument("--interactive", action="store_true",
                   help="read interaction commands from stdin")
    p.add_argument("--hit-vertex", type=int, default=0,
                   help="vertex struck at t=0 in non-interactive mode")
    p.add_argument("--demo-synth", action="store_true",
                   help="run on a generated synthetic model (no data files)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the session runs: the CUDA device (the "
                        "default; raises without one) or the CPU")
    p.add_argument("--print-frequencies", action="store_true",
                   help="print every mode's natural frequency and exit "
                        "(the reference's printAllFrequency)")
    p.add_argument("--lookahead", type=int, default=1,
                   help="blocks synthesized per device dispatch (amortizes "
                        "dispatch latency at the cost of event latency)")
    p.add_argument("--record", default=None, metavar="TIMELINE_JSON",
                   help="record applied events and write a render_timeline"
                        " JSON on exit (bake what you played)")
    p.add_argument("--smooth-transfer", action="store_true",
                   help="ramp the acoustic transfer across the block after "
                        "a listener move (removes the zipper step of "
                        "block-constant transfer)")
    return p


def resolve_paths(args) -> ModelPaths:
    if args.data_dir != FILE_NOT_EXIST:
        name = (args.obj_name if args.obj_name != FILE_NOT_EXIST else None)
        return resolve_model_dir(args.data_dir, name)
    if FILE_NOT_EXIST in (args.mesh, args.surf_mode, args.material):
        raise SystemExit(
            "**Usage: either input -d (and optionally -name), or specify "
            "full paths to -m, -s, -t, and -p.")
    return ModelPaths(args.mesh, args.surf_mode, args.material,
                      args.ffat_map)


def load_model_only(args):
    """Resolve paths (or synthesize the demo model) and load mesh+modes+
    material WITHOUT building a device session — metadata-only queries
    (--print-frequencies) need no device at all."""
    if args.demo_synth:
        import tempfile

        from ..utils.synth import synth_model_dir
        root = tempfile.mkdtemp(prefix="pbso_demo_")
        synth_model_dir(root, "demo", num_modes=48, subdivisions=2,
                        ffat_n=16)
        paths = resolve_model_dir(root, "demo")
    else:
        paths = resolve_paths(args)
    model = load_model(paths)
    print(f"model: {model.num_vertices} vertices, "
          f"{model.modes.num_modes} modes "
          f"({model.num_modes_audible} audible), "
          f"{len(model.ffat_maps)} FFAT maps")
    return model


def resolve_device(args):
    """The ``--device`` flag as a torch.device: cuda (the default) raises
    without a CUDA device instead of falling back to the CPU."""
    from ..device import resolve_device as _resolve
    return _resolve(None if getattr(args, "device", "cuda") == "cuda"
                    else args.device)


def make_session(args):
    import torch

    from ..ops.coeffs import bank_from_material
    from ..ops.ffat import build_ffat
    from ..runtime.session import ModalSession
    from ..runtime.solver import SolverConfig

    device = resolve_device(args)
    model = load_model_only(args)
    bank = bank_from_material(
        model.material.density,
        model.modes.omega_squared[: model.num_modes_audible],
        model.material.alpha, model.material.beta,
        num_objects=args.instances, block_size=args.block,
        dtype=torch.float32, device=device)
    # f64 eigenvalues enable the span dispatches (ops/span.py) — the
    # fastest measured path for offline renders AND the live engine
    from ..ops.coeffs import lambda_from_modes
    lam64, _, _ = lambda_from_modes(
        model.material.density,
        model.modes.omega_squared[: model.num_modes_audible],
        model.material.alpha, model.material.beta)
    ffat = None
    if model.ffat_maps and not args.no_transfer:
        # carry BOTH Psi textures (raw + compressed) like the reference's
        # runtime map, so `transfer compressed on` is a zero-rebuild
        # switch; skip the second texture if the image codec is missing
        try:
            ffat = build_ffat(model.ffat_maps, bank.num_modes,
                              dtype=torch.float32, device=device,
                              compressed_maps="auto")
            texture = "raw + compressed"
        except ImportError:
            ffat = build_ffat(model.ffat_maps, bank.num_modes,
                              dtype=torch.float32, device=device)
            texture = "raw only (no image codec for the compressed one)"
        # said aloud: a silently missing compressed texture would only
        # show when a client toggles it
        print(f"ffat texture: {texture}", flush=True)
    nl = int(getattr(args, "num_listeners", 1) or 1)
    sess = ModalSession(bank, ffat=ffat, lam64=lam64,
                        num_listeners=nl,
                        config=SolverConfig(
                            block_size=args.block, backend=args.backend,
                            smooth_transfer=getattr(args, "smooth_transfer",
                                                    False)))
    listener = np.asarray([float(v) for v in args.listener.split(",")])
    if nl > 1:
        listener = np.broadcast_to(listener, (nl, 3))
    sess.set_listener(listener)
    return model, sess


def session_from_meta(args, meta_path: str):
    """(model, session) rebuilt from a 4-line .meta descriptor — the ONE
    hot-swap recipe shared by the interactive 'load' command and the
    server's load_model (the reference's LoadNewModel flow,
    real_time_modal_sound.cpp:347-474)."""
    import copy

    from ..io.meta import read_meta
    meta = read_meta(meta_path)
    new_args = copy.copy(args)
    new_args.data_dir = FILE_NOT_EXIST
    new_args.mesh = meta.obj_file
    new_args.surf_mode = meta.modes_file
    new_args.material = meta.material_file
    new_args.ffat_map = meta.ffat_dir
    new_args.demo_synth = False
    return make_session(new_args)


def interactive_loop(engine, model, args) -> None:
    print("interactive mode; type 'help' for commands", flush=True)
    last_hit = None
    for line in sys.stdin:
        toks = line.split()
        if not toks:
            continue
        cmd = toks[0].lower()
        try:
            if cmd == "quit":
                break
            elif cmd == "help":
                print(__doc__.split("stdin (one command per line):")[-1])
            elif cmd == "hit":
                obj, vid = int(toks[1]), int(toks[2])
                kind = toks[3] if len(toks) > 3 else "point"
                width = float(toks[4]) if len(toks) > 4 else 100.0
                last_hit = dict(obj=obj, space=model.modal_force_vertex(vid),
                                kind=kind, width_us=width)
                engine.hit(last_hit["obj"], last_hit["space"],
                           kind=kind, width_us=width)
            elif cmd == "preview":
                # matcap-shaded snapshot of the model — the headless
                # stand-in for the reference's GUI viewport; honors the
                # -tex texture (real_time_modal_sound.cpp:1179-1199)
                import os as _os
                out = toks[1] if len(toks) > 1 else "preview.png"
                from .render_fields import _write_png
                from .softrender import (default_matcap, load_matcap,
                                         render_mesh)
                tex = getattr(args, "obj_texture_map", FILE_NOT_EXIST)
                mc = (load_matcap(tex)
                      if tex != FILE_NOT_EXIST and _os.path.isfile(tex)
                      else default_matcap())
                _write_png(out, render_mesh(model.vertices, model.faces,
                                            matcap=mc))
                print(f"wrote {out}")
            elif cmd in ("again", "d"):
                # repeat the cached hit (the reference's GetModalForceCopy
                # on key 'd', real_time_modal_sound.cpp:214-234,1111-1118)
                if last_hit is None:
                    print("no hit to repeat yet")
                else:
                    engine.hit(last_hit["obj"], last_hit["space"],
                               kind=last_hit["kind"],
                               width_us=last_hit["width_us"])
            elif cmd == "sustain":
                obj, vid = int(toks[1]), int(toks[2])
                engine.sustained_start(obj, model.modal_force_vertex(vid))
            elif cmd == "arparam":
                obj = int(toks[1])
                engine.set_ar_params(obj, (float(toks[2]), float(toks[3])),
                                     float(toks[4]), float(toks[5]))
            elif cmd == "release":
                engine.sustained_end(int(toks[1]))
            elif cmd == "listener":
                engine.set_listener(np.asarray(
                    [float(toks[1]), float(toks[2]), float(toks[3])]))
            elif cmd == "transfer":
                # transfer on|off  /  transfer compressed on|off (the
                # reference's useCompressed ImGui toggle,
                # real_time_modal_sound.cpp:835-853)
                if toks[1] == "compressed":
                    engine.session.set_use_compressed(toks[2] == "on")
                else:
                    engine.session.set_use_transfer(toks[1] == "on")
            elif cmd == "clear":
                engine.clear_forces()
            elif cmd == "load":
                # hot-swap to a new model from a 4-line .meta descriptor
                from ..runtime.checkpoint import swap_model
                model, new_sess = session_from_meta(args, toks[1])
                new_sess.step()  # first use before swapping the live stream
                swap_model(engine, new_sess)
                print(f"loaded {toks[1]}: {model.num_modes_audible} "
                      f"audible modes")
            elif cmd == "stats":
                st = engine.profiler.stats()
                print(f"health={engine.health.health:.2f} "
                      f"block p50={st.p50_ms:.2f}ms p99={st.p99_ms:.2f}ms "
                      f"deadline={st.deadline_ms:.2f}ms rtf={st.rtf:.1f}"
                      if st else "no blocks yet")
            elif cmd == "qnorm":
                # per-mode energy telemetry (the transfer-ball data feed,
                # modal_solver.h:153-159); prints the top modes
                q = engine.latest_qnorm()
                if q is None:
                    if engine._qnorm_every == 0:
                        engine._qnorm_every = 4
                    print("qnorm telemetry enabled; ask again shortly")
                else:
                    row = np.asarray(q[0])
                    top = np.argsort(row)[::-1][:8]
                    print("top modes:",
                          " ".join(f"{i}:{row[i]:.3g}" for i in top))
            else:
                print(f"unknown command: {cmd}")
        except (IndexError, ValueError, OSError) as e:
            print(f"bad command args: {e}")


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.print_frequencies:
        # metadata-only query: load the model WITHOUT building the device
        # session (none of it would be used)
        model = load_model_only(args)
        freqs = model.modes.frequencies_hz(model.material.density)
        for i, f in enumerate(freqs):
            marker = "" if i < model.num_modes_audible else "  (culled)"
            print(f"Mode {i}: {f:.3f} Hz{marker}")
        return 0
    model, sess = make_session(args)

    from ..runtime.audio import WavFileSink
    from ..runtime.engine import StreamingEngine

    sink = WavFileSink(args.out, SAMPLE_RATE, normalize=True)
    engine = StreamingEngine(sess, sink, lookahead=args.lookahead,
                             record=args.record is not None)

    if args.interactive:
        engine.start()
        try:
            interactive_loop(engine, model, args)
        finally:
            engine.stop()
    else:
        # scripted run: strike every instance at t=0, stream for --seconds
        for o in range(args.instances):
            engine.hit(o, model.modal_force_vertex(args.hit_vertex))
        engine.run_for(args.seconds)
    st = engine.profiler.stats()
    if st:
        print(f"done: {st.count} blocks, p50 {st.p50_ms:.2f} ms, "
              f"p99 {st.p99_ms:.2f} ms vs deadline {st.deadline_ms:.2f} ms, "
              f"buffer health {engine.health.health:.2f}")
    print(f"wrote {args.out}")
    if args.record:
        import json as _json
        with open(args.record, "w") as f:
            _json.dump(engine.export_timeline(), f, indent=1)
        print(f"recorded timeline -> {args.record}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
