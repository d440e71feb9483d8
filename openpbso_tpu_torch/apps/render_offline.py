"""render_offline — deterministic offline renders of the eval configs.

The port's counterpart of openpbso_tpu/apps/render_offline.py: the same
configs, flags and report, on the CUDA device (``run_config`` takes
``device="cpu"`` for a CPU run).

Runs the BASELINE.json evaluation configurations end-to-end and writes wav
files + a JSON timing report. Each config mirrors one of the benchmark's eval
scenarios (BASELINE.md 'Eval configs'):

1. ball: ~20 modes, unit transfer, single unit impulse, 1 s render
2. full FFAT transfer, static listener, single hammer (gaussian) hit
3. moving listener + multi-impact gaussian force train on one object
4. batched scene: 8 objects x 128 modes, simultaneous impacts, stereo mix
5. streaming mode: 128-sample blocks with interactive hit events

Usage: python -m openpbso_tpu_torch.apps.render_offline [--out-dir DIR]
       [--config N] [--backend blocked|scan|pallas]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from ..config import SAMPLE_RATE


def _session_for(num_modes, num_objects, block, backend, with_ffat,
                 seed=0, n_verts_subdiv=1, device=None):
    import torch

    from ..device import resolve_device
    from ..ops.coeffs import bank_from_material
    from ..ops.ffat import build_ffat
    from ..runtime.session import ModalSession
    from ..runtime.solver import SolverConfig
    from ..utils.synth import CERAMIC, synth_fatcube, synth_mode_data

    device = resolve_device(device)
    md = synth_mode_data(num_modes, 32, seed=seed)
    bank = bank_from_material(CERAMIC.density, md.omega_squared,
                              CERAMIC.alpha, CERAMIC.beta,
                              num_objects=num_objects, block_size=block,
                              dtype=torch.float32, device=device)
    ffat = None
    if with_ffat:
        freqs = md.frequencies_hz(CERAMIC.density)
        maps = {i: synth_fatcube(i, float(freqs[i]), n=16, seed=seed)
                for i in range(num_modes)}
        ffat = build_ffat(maps, bank.num_modes, dtype=torch.float32,
                          device=device)
    sess = ModalSession(bank, ffat=ffat,
                        config=SolverConfig(block_size=block,
                                            backend=backend))
    return md, sess


def _prepared(n: int, backend: str, doppler: bool = False, device=None):
    """Build config ``n``'s session with its events scheduled and return
    (session, render_fn). Separating setup from the render lets
    run_config warm up with a throwaway identical render and time ONLY
    the real one — otherwise a cold run reports first-use costs (the
    kernels' load, library handles) as render throughput."""
    rng = np.random.default_rng(100 + n)
    if n == 1:
        md, sess = _session_for(20, 1, 512, backend, with_ffat=False,
                                device=device)
        sess.hit(0, rng.standard_normal(20), kind="point")
        return sess, lambda: sess.render_multi(SAMPLE_RATE // 512)
    if n == 2:
        md, sess = _session_for(48, 1, 512, backend, with_ffat=True,
                                device=device)
        sess.set_listener(np.asarray([0.8, 0.5, 0.4]))
        sess.hit(0, rng.standard_normal(48), kind="gaussian",
                 width_us=150.0)
        return sess, lambda: sess.render_multi(SAMPLE_RATE // 512)
    if n == 3:
        md, sess = _session_for(48, 1, 512, backend, with_ffat=True,
                                device=device)
        # moving listener + impact train, fully scheduled up front: hits
        # are future-dated slots and the listener path is a per-block
        # transfer schedule, so the whole ~2.3 s render is
        # ceil(200/100) = 2 dispatches (vs 20 one-per-move dispatches
        # round 1; the reference pays one transfer recompute per move,
        # modal_solver.h:286-300)
        angles = 0.2 * (1 + np.arange(20))           # ~2.3 s, 10 Hz updates
        positions = np.stack([1.2 * np.cos(angles),
                              np.full(20, 0.5),
                              1.2 * np.sin(angles)], axis=1)
        per_block = np.repeat(positions, 10, axis=0)  # hold 10 blocks each
        for step in range(0, 20, 4):                 # impact train
            sess.hit(0, rng.standard_normal(48), kind="gaussian",
                     width_us=100.0 + 40.0 * (step % 3),
                     when=step * 10 * 512)
        if doppler:
            # beyond-reference: same render with physical propagation
            # delay (time-varying r/c -> Doppler shift; ops/doppler.py)
            return sess, lambda: sess.render_doppler(
                per_block, blocks_per_dispatch=100)
        return sess, lambda: sess.render_moving(per_block,
                                                blocks_per_dispatch=100)
    if n == 4:
        md, sess = _session_for(128, 8, 512, backend, with_ffat=True,
                                device=device)
        sess.set_listener(np.asarray([1.0, 0.6, 0.2]))
        for o in range(8):
            sess.hit(o, rng.standard_normal(128), kind="point")
        return sess, lambda: sess.render_multi(SAMPLE_RATE // 512)
    raise ValueError(f"unknown config {n}")


def run_config(n: int, backend: str, out_dir: str,
               doppler: bool = False, warm: bool = True,
               device=None) -> dict:
    """Render config ``n`` and write its wav; returns its report entry.
    ``device`` None is the CUDA device (raises without one)."""
    rng = np.random.default_rng(100 + n)
    if n == 5:
        from ..runtime.audio import RawCollectorSink
        from ..runtime.engine import StreamingEngine
        md, sess = _session_for(64, 1, 128, backend, with_ffat=False,
                                device=device)
        sess.step()  # first use, so the stream starts warm
        sink = RawCollectorSink()
        engine = StreamingEngine(sess, sink)
        t_start = time.perf_counter()
        engine.start()
        for k in range(6):
            engine.hit(0, rng.standard_normal(64),
                       kind="gaussian" if k % 2 else "point")
            time.sleep(0.15)
        engine.stop()
        audio = sink.concatenated()
    else:
        if warm:
            # throwaway identical render: the timed render measures
            # throughput, not first use
            _, render0 = _prepared(n, backend, doppler, device)
            np.asarray(render0())
        sess, render = _prepared(n, backend, doppler, device)
        t_start = time.perf_counter()
        audio = render()
    wall = time.perf_counter() - t_start

    duration = audio.shape[0] / SAMPLE_RATE
    peak = float(np.abs(audio).max())
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"config{n}_{backend}.wav")
    from ..runtime.audio import WavFileSink
    sink = WavFileSink(path, normalize=True)
    sink.write(audio)
    sink.close()
    return {
        "config": n,
        "backend": backend,
        # only config 3 (the moving-listener render) applies Doppler
        **({"doppler": True} if doppler and n == 3 else {}),
        "samples": int(audio.shape[0]),
        "audio_seconds": round(duration, 3),
        "wall_seconds": round(wall, 3),
        "rtf": round(duration / wall, 2) if wall > 0 else None,
        "peak": peak,
        "wav": path,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out-dir", default="renders")
    p.add_argument("--config", type=int, default=0,
                   help="run one config (1-5); 0 = all")
    p.add_argument("--backend", default="blocked",
                   choices=["blocked", "scan", "pallas"])
    p.add_argument("--doppler", action="store_true",
                   help="config 3: apply physical propagation delay "
                        "(Doppler) to the moving-listener render")
    args = p.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    configs = [args.config] if args.config else [1, 2, 3, 4, 5]
    results = []
    for n in configs:
        r = run_config(n, args.backend, args.out_dir,
                       doppler=args.doppler)
        print(json.dumps(r))
        results.append(r)
    report = os.path.join(args.out_dir, "report.json")
    with open(report, "w") as f:
        json.dump(results, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
