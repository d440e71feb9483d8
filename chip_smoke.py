#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (openpbso_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure raises and the script exits non-zero:

1. environment: a CUDA device is required (there is no CPU fallback);
   prints the card's name and power limit, torch and CUDA versions;
2. build: compiles every csrc/*.cu for sm_90a from this checkout (one nvcc
   per source, in parallel) into openpbso_tpu_torch/_build/ and prints the
   build time;
3. kernel vs plain: step_block_fused on the card against its plain PyTorch
   twin (<= -110 dB: both mode contractions are 3xTF32 products on the
   tensor cores) and against the blocked backend (<= -90 dB) for a
   heterogeneous and a shared 256x1024 bank at S=512, a ragged bank and a
   chunk larger than the block; two runs must be bitwise equal; times the
   kernel and the plain twin with CUDA events (median of 30), the kernel's
   device time and the host's enqueue of one step;
4. the per-block path end to end: a ModalSession on a heterogeneous
   256x1024 bank with 1024-mode FFAT maps and per-object listeners renders
   ~2 s of a hit script (point, gaussian and hertz, some future-dated)
   through the fused kernel; checks the output, the kernels' launch counts
   and the blocked backend's render (<= -90 dB), and times synced
   per-block steps;
5. the chunked span: (a) the chunk-scan kernel against its plain twin
   (<= -100 dB) and the Toeplitz-conv kernel against its twin (<= -110
   dB: the 3xTF32 split on the tensor cores), both bitwise repeatable and
   timed with CUDA events (medians), the conv also beside one cuDNN
   conv1d call that computes the same function and against its FP32 and
   3xTF32 bounds, at the span shapes of a shared 256x1024 bank at 512
   blocks and a heterogeneous one at 1024 blocks, with the ms and
   real-time factor of one full span dispatch at each; (b) the phase-4
   session, built with its float64 eigenvalues, renders the same script
   with render_multi (16 blocks per span): checked against phase 4's fused
   render (<= -90 dB) and the kernels' launch counts; each kernel is held
   against its twin on the inputs of the render's first busy (and first
   ring-down) dispatch; and the span dispatches are timed; (c) the conv at
   the span's short chunks: a 3-block span (C = 192) and a one-block span
   with a full slot bucket (C = 64, K = 16, X = 8);
6. the sustained AR(2) channel: (a) the ar_noise kernel against its
   threefry twin (bits bitwise, normals <= -120 dB) at the --sustained
   span shape 256 x 512 blocks x 512 and at 16 blocks across the rebase
   modulo, the ar_block kernel against its twin (bitwise, given the
   kernel's normals) with a quarter of the objects inactive, and
   toeplitz_conv as the AR noise convolution (as in 5a), all bitwise
   repeatable and timed with CUDA events; (b) one sustained span dispatch
   as bench.py --sustained drives it (shared 256x1024, 512 blocks, every
   object dragging, the drag-only bucket, a span-covering AR table), then with
   one object retuned (per-object table); (c) phase 4's session and script
   plus drags on 32 objects (start ~0.2 s, update ~0.6 s, a sigma/mu retune
   ~0.7 s, end ~1.5 s), rendered per block (fused + ar_block) and by
   render_multi (ar_noise, chunk_scan, toeplitz_conv): the two agree to
   <= -60 dB, every kernel of each path launched, and each of ar_noise and
   ar_block held against its twin on the inputs of the first drag dispatch;
7. the live stream, on phase 4's bank, maps and listeners: (a) one xfade
   block (a listener move ramped across the block; the fused backend takes
   the blocked form for it) against the blend of two constant-row renders
   through the fused kernel (<= -90 dB), and a ramp from a row to itself
   against the plain step; (b) a block with qnorm on the fused backend:
   sound and state bitwise the plain step's, qnorm against the scan
   backend's (<= -100 dB), qnorm_probe leaving state and clock untouched,
   with ms and peak memory; (c) render_moving over a 64-block listener
   path, held rows against the loop "set_listener, step" and ramped rows
   against a smooth_transfer session stepped per block (<= -90 dB), the
   fused launches counted; (d) StreamingEngine, unpaced into a collector,
   over a session without lam64 (fused per block) and with it (one-block
   and four-block spans), ~200 blocks each with qnorm every 8 blocks,
   smooth listener moves and drags arriving live: the first 20 blocks
   against an offline render of the same hits (<= -90 dB); the kernels'
   launches, read from start() to stop(), against a log of the session's
   dispatches, and the stream's share of them (all but start()'s warmup)
   against what the engine's recorded events and the blocks of each
   dispatch imply without the session (reckon_launches); the profiler's
   per-block statistics, warmup seconds and first block; then the two
   span streams again with a rattle (bench/stream_ab.py::rattle_schedule:
   two soft hits a block on one of four objects in turn), so every span
   takes the full slot table (K = 16, 17 with the drags): the span
   contractions' shapes and variants counted over the stream (stacked
   and split must take the full table), the first 20 blocks against an
   offline per-block replay of the recorded events (<= -90 dB); (e) the fused
   engine paced at the audio rate for ~3 s with hits arriving live: no
   late block that a stall of the whole process (a watchdog thread's late
   wake) does not explain, no missed block beyond the late ones, p99
   under the block's deadline, and the device's idle share; (f) a snapshot of the running session taken through
   engine.control, restored into a fresh session: both render the next 16
   blocks bitwise equal, drags and a retuned AR table included;
8. the spatial path: SCENE_MODELS synthetic model directories of M modes,
   written by worker processes while phases 3-6 run, loaded and placed as
   O instances on a grid: a binaural Scene with ITD (interaural time
   difference: complex [2, O, M] transfer rows), smooth listener moves and
   compressed FFAT maps (compress_map, uint8), a heterogeneous O x M bank
   with its float64 eigenvalues. (a) compute_transfer from both textures
   against the same calls on CPU tensors (<= -100 dB), the textures
   differ, set_use_compressed switches the rows at once with no rebuild;
   one lookup of both ears equals one call per ear bitwise; (b) a
   binaural Scene's shared-state rows (blocked form) against the
   replicated layout (2*O rows through fused_block) per channel (<= -90
   dB); (c) the ITD Scene per block against render_multi (16 blocks a
   span, <= -90 dB), the span kernels on the render's own L = 2 complex-row inputs
   (chunk_scan bitwise, toeplitz_conv <= -110 dB and repeatable), launch
   counts, per-block and span ms; (d) Scene.render_moving along a 64-block
   world path, held and ramped (binaural Scenes without and with
   smooth_transfer), against the per-move loop (<= -90 dB), and
   render_doppler on that path: silent before the first wavefront, and at
   c = 1e12 equal to render_moving (<= -90 dB); (e) StreamingEngine
   streams of ~200 blocks: the ITD Scene through DopplerPostMix at
   lookahead 1 and 4 and a single-listener Scene through HRTFPostMix on
   the fused path (first 20 blocks against an offline per-block render
   through a fresh post-mix, <= -90 dB; launches from start() to stop()
   against the dispatch log and the recorded events; HRTF process_span
   against per-block processing <= -90 dB), then the Doppler stream paced
   for 3 s (missed, late blocks and p99 reported, not gated). Every
   render starts from the Scene's own session as it was built (as_built);
   the HRTF stream's Scene alone gets a session without span tables; (f)
   per-client serving: a listener_offsets Scene of 4 listeners and the
   same Scene with [4, 3] world rows through DopplerPostMix(num_listeners
   =4), each per block against one span (<= -90 dB). Prints the binaural
   per-block and span ms, the span RTF, set_listener's latency with ITD
   and the compressed lookup's ms beside the card's name and power limit;
9. the served path: phase 8's model directories as .meta files in scene
   JSONs of O instances on phase 8's grid, served by apps/serve.py's
   build_server to the port's own clients on threads over loopback, every
   engine recording its events and dispatches. (a) --web --multi-client
   --per-client-listeners 4,8 --live-doppler (the HUD's colour pusher on):
   four WebSocket clients, unpaced, each moving its own listener every 20
   blocks and striking, one dragging, one asking for its transfer
   histogram; a fifth grows the bucket to 8 (the ring-down and the four
   old Doppler delay lines carried bitwise, checked). Every block a client
   receives is bitwise the next of its channel of the engine's blocks,
   but for replays the engine's missed count allows and the blocks a swap
   drops in flight; the first session's blocks (>= 120) against an
   offline per-block replay of the recorded events through a fresh
   DopplerPostMix, the grown session's from the state and post-mix its
   stream started with (<= -90 dB before a drag, <= -60 dB with it); then
   paced 3 s with the HUD on and 2 s off (p99, missed, the card's idle
   share). (b) the TCP broadcast of a single-listener Scene: hits, a drag
   retuned while impacts ring (the per-block path: the stream's own
   fused_block and ar_block launches, start()'s warmup not counted, must
   be > 0), PCM bitwise the engine's, stats, and a load_model hot swap to
   one model's meta. (c) render_timeline.bake of a timeline with 64 hits
   (three slot waves) and a drag, with listener keyframes (render_moving)
   and without (render_multi), each against a per-block render of the
   same script (<= -90 dB before the drag, <= -60 dB with it), and
   render_offline's configs 1-5 with their report. Phase 9's launches in
   the kernels line are the served streams' own (less each start() and
   the first step of a session built beside them) and the bakes';
10. the multi-device session (parallel/): ShardedSession on (obj, mode)
   meshes (2, 1), (1, 2) and (2, 2), each of distinct cards where the
   machine has them, else every cell on cuda:0 (printed). (a) phase 4's
   scene per block: hits, four drags, a smooth listener move, then the
   ring-down through the decay step, against the unsharded session (<=
   -90 dB before the first drag, <= -60 dB with it; ar_block launched by
   every shard, and on (2, 2) held bitwise against its twin on one
   shard's inputs of the first drag block), each card's memory held by
   the session (one bank's shards and the state: the whole bank is not
   kept) and its peak; (b) render_multi (16-block spans, C = 512) of phase 4's
   scene and of a shared 256x1024 bank against the unsharded render (<=
   -90 dB), chunk_scan and toeplitz_conv launched shards x dispatches,
   exactly one cross-shard reduction a dispatch; on (2, 2) the span
   kernels against their twins on one shard's inputs of the first busy
   dispatch (chunk_scan bitwise, toeplitz_conv <= -110 dB and
   repeatable) and one full span dispatch timed unsharded and sharded, A
   B B A (on one card this is the layout's cost, not a speed-up; where
   the mesh has cards of its own, the same mesh with every cell on
   cuda:0 is timed beside them, A B C C B A); (c) drags on 32 objects by
   span on (2, 2): every shard's ar_noise bits bitwise the unsharded rows
   of its objects, and one shard's ar_noise against its threefry twin on
   that shard's inputs (bits bitwise, normals <= -120 dB), the mix <= -60
   dB; (d)
   StreamingEngine over the (2, 2) session at lookahead 2, ~200 unpaced
   blocks of 7d's events: the first 20 blocks against an offline render
   (<= -90 dB), launches against the dispatch log and the recorded events
   (times the shards), p50/p99; (e) Scene(mesh=...) on (2, 2), binaural
   with ITD on phase 8's models, against the same Scene without a mesh,
   per block and by render_multi (<= -90 dB); (f) save_session of a (2,
   2) session mid-drag and load_session into a fresh one: the next 16
   blocks bitwise;
11. ml/ on the card: synthesize_dataset of the six materials, 256 objects
   x 1024 modes each (a hetero bank stepped through fused_block; its
   launches counted), 2 hits and 0.5 s; one material against the blocked
   form (<= -90 dB); features_matrix of every clip (seconds printed); the
   study where sklearn is installed, else its error printed;
12. the span forms and the native decoder, reusing phase 5's banks and
   tables and phase 8's model directories. Phase 5's busy dispatch (a
   gaussian on every object, the one-slot bucket) and a ring-down from
   its start state run through each form against the flat single-level
   chunked form (mix and state <= -90 dB), every chunk_scan call of a
   form bitwise its twin on its own inputs, the busy dispatch timed
   synced A B B A against flat, with peak memory and the kernels'
   launches: (a) shared 256x1024 at 512 blocks (N = 262144): the default
   tables (superchunk X = 512, G = 32), factored (R = 512, X = 512) and
   full ([1024, 262145]); (b) hetero 256x1024 at 64 blocks (X = 64):
   factored and the opt-in superchunk (passes A and C and the group scan
   through chunk_scan); (c) a (2, 2) mesh of cuda:0 cells: two 64-block
   spans of the shared bank (superchunk tables split on the mode axis)
   against the unsharded session (<= -90 dB); (d) the native library
   (g++, built into openpbso_tpu_torch/_build/): every .fatcube of phase
   8's directories decoded natively with no fallback, bitwise the Python
   codec's; the bulk load timed A B B A against the codec's, load_model
   once, and 10^4 [512, 2] blocks through NativeSpscRing between two
   threads, whole and in order;
13. the span's mode contractions: span_inject and span_reduce (g and hom)
   against their twins (<= -110 dB, bitwise repeatable) and timed (CUDA
   events over one chain of 100 calls, the profiler's device time, retaken
   while it reads below the bound and else the chained time, the twin, the
   cuBLAS SGEMM pair of the same contraction as a yardstick, chained too,
   the bound of bench/roofline.py) at the main path's shapes: shared
   256x1024 nb=512 (C = X = 512), hetero nb=1024 and nb=16 (5b's spans),
   the engine's one- and four-block spans (C = 64 and 256, X = 8, K = 17,
   with toeplitz_conv beside one cuDNN conv1d), phase 8c's L = 2 complex
   rows and a (2, 2) shard's (8c's and 10b's captured inputs); then
   phase 5's busy dispatch at shared nb=512 and hetero nb=1024 and nb=16
   through the twin-composed stages and the kernels, synced, A B B A, and
   7d's engine p50/p99.
   Phases 5b, 8c and 10b also hold both kernels against their twins on
   their dispatches' own inputs.

Every timed kernel also gets its device time: the torch.profiler duration
of one launch, median over 30 calls (CUDA events time the host's enqueue
as well where it is the longer). The last two lines of stdout are the
kernels' JSON summary (each kernel's launches on its path, error, ms,
device ms, plain and library ms, and its bound from bench/roofline.py at
the timed shape) and {"ok": true, "device": {...}}. Each phase prints its
seconds.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import weakref

import numpy as np

O, M, S, CHUNK = 256, 1024, 512, 64
RENDER_BLOCKS = 172          # ~2 s of audio at 44.1 kHz
LAST_HIT_BLOCK = 86          # no hit later than ~1 s
TIMED_RUNS = 30
SPAN_CASES = (("shared", 512), ("hetero", 1024))   # bank, blocks per span
SPAN_DISPATCH = 16           # render_multi's blocks per dispatch
SUS_SPAN_BLOCKS = 512        # bench.py --sustained: one span of 512 blocks
DRAGGED = 32                 # objects dragged in phase 6c
DRAG_EVENTS = (16, 48, 64, 128)   # blocks of start, update, retune, end
MOVING_BLOCKS = 64           # phase 7c's listener path
ENGINE_BLOCKS = 200          # blocks of each unpaced engine stream (7d)
ENGINE_HITS = 16             # enqueued before start(): all apply at block 0
ENGINE_COMPARED = 20         # first blocks held against the offline render
ENGINE_DRAGGED = 4           # objects dragged live in 7d
QNORM_EVERY = 8
PACED_SECONDS = 3.0          # phase 7e
CHECKPOINT_BLOCKS = 16       # phase 7f
FORM_RUNS = 5                # phase 12: synced dispatches a timed turn
LONG_SPAN_BLOCKS = 64        # 12b, 12c: 64 chunks of 512 samples
SCENE_MODELS = 4             # phase 8: model directories the O instances
#                              cycle through (a heterogeneous bank)
SCENE_SPACING = 0.6          # meters between grid neighbours
SCENE_LISTENER = np.array([0.3, 0.2, 1.5])   # the world listener
SCENE_LAST_HIT = 12          # no phase-8 hit later than this block
SPATIAL_BLOCKS = 49          # 8b, 8c: a ramp block and three 16-block spans
PER_CLIENT = 4               # 8f's listeners
PER_CLIENT_BLOCKS = 8
SERVED_CLIENTS = 4           # 9a: the first clients (bucket 4, then 8)
SERVED_BLOCKS = 200          # blocks each of them reads at least
SERVED_GROW_AT = 100         # the fifth client connects after these
SERVED_LATE_BLOCKS = 60      # blocks the fifth client reads
SERVED_COMPARED = 120        # 9a's blocks held against the offline replay
SERVED_PACED_SECONDS = 3.0   # 9a paced with the HUD on (then 2 s off)
MONO_BLOCKS = 100            # 9b: blocks each client reads
BAKE_BLOCKS = 96             # 9c's timeline
MESHES = ((2, 1), (1, 2), (2, 2))   # phase 10's (obj, mode) meshes
MESH_BLOCKS = 64             # 10a: blocks of events, then a ring-down of
MESH_RINGDOWN = 16           # this many blocks (the decay step)
MESH_HIT_LAST = 40           # 10a takes phase 4's hits up to this block
MESH_DRAGS = (16, 48)        # 10a: four drags start and end at these blocks
MESH_MOVE = 28               # 10a: the smooth listener move
MESH_SUSTAINED_BLOCKS = 32   # 10c: two 16-block spans with drags
DATASET_OBJECTS = 256        # phase 11: objects per material (M modes)
DATASET_HITS = 2             # batches (one hit each object) per material
DATASET_SECONDS = 0.5
TOEPLITZ_DB = -110.0         # the 3xTF32 conv against its FP32 twin
FUSED_DB = -110.0            # the 3xTF32 fused step against its FP32 twin
TOEPLITZ_SHAPES = (   # the span's short chunks: label, (O, L, K, X, C)
    ("3-block span", (O, 1, 1, 8, 192)),
    ("one-block span, full slot bucket", (O, 1, 16, 8, 64)),
)
CUDA_NAMES = {   # name -> the CUDA kernel its wrapper launches
    "fused_block": "fused_block_kernel", "chunk_scan": "chunk_scan_kernel",
    "toeplitz_conv": "toeplitz_conv_tc", "ar_noise": "ar_noise_kernel",
    "ar_block": "ar_block_kernel", "span_inject": "span_inject_tc",
    "span_reduce": "span_reduce"}
KERNELS = {   # name -> (source, the TPU kernel or XLA stage it replaces)
    "fused_block": ("openpbso_tpu_torch/csrc/fused_block.cu",
                    "openpbso_tpu/ops/pallas_integrator.py:60"),
    "chunk_scan": ("openpbso_tpu_torch/csrc/chunk_scan.cu",
                   "openpbso_tpu/ops/span.py:414"),
    "toeplitz_conv": ("openpbso_tpu_torch/csrc/toeplitz_conv.cu",
                      "openpbso_tpu/ops/span.py:577"),
    "ar_noise": ("openpbso_tpu_torch/csrc/ar_noise.cu",
                 "openpbso_tpu/ops/forces.py:378"),
    "ar_block": ("openpbso_tpu_torch/csrc/ar_block.cu",
                 "openpbso_tpu/ops/forces.py:607"),
    "span_inject": ("openpbso_tpu_torch/csrc/span_inject.cu",
                    "openpbso_tpu/ops/pallas_integrator.py:98"),
    "span_reduce": ("openpbso_tpu_torch/csrc/span_reduce.cu",
                    "openpbso_tpu/ops/pallas_integrator.py:86"),
}


def db_error(test, ref) -> float:
    """20*log10(||test - ref|| / ||ref||) in float64; -inf when equal."""
    test = np.asarray(test, np.float64)
    ref = np.asarray(ref, np.float64)
    err = float(np.linalg.norm(test - ref))
    if err == 0.0:
        return float("-inf")
    return 20.0 * np.log10(err / float(np.linalg.norm(ref)))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def hetero_modes(o, n_modes):
    """Per-object mode sets, as bench.py --hetero builds them: (lam, b,
    valid) [O, n_modes] in float64."""
    from openpbso_tpu_torch.utils.synth import CERAMIC, synth_mode_data
    from openpbso_tpu_torch.ops.coeffs import lambda_from_modes
    parts = [lambda_from_modes(CERAMIC.density, synth_mode_data(
        n_modes, 8, seed=100 + i, f_low=100.0 + i,
        f_high=15000.0 + 3 * i).omega_squared, CERAMIC.alpha, CERAMIC.beta)
        for i in range(o)]
    return tuple(np.stack(x) for x in zip(*parts))


def hetero_bank(o, n_modes, s, device, modes=None):
    from openpbso_tpu_torch.ops.coeffs import build_modal_bank
    lam, b, valid = modes if modes is not None else hetero_modes(o, n_modes)
    return build_modal_bank(lam, b, valid, block_size=s, shared=False,
                            device=device)


def shared_modes(n_modes):
    """One mode set for every object: (ceramic material, omega^2)."""
    from openpbso_tpu_torch.utils.synth import CERAMIC, synth_mode_data
    return CERAMIC, synth_mode_data(n_modes, 8, seed=0).omega_squared


def shared_bank(o, n_modes, s, device):
    from openpbso_tpu_torch.ops.coeffs import bank_from_material
    mat, omega_squared = shared_modes(n_modes)
    return bank_from_material(mat.density, omega_squared, mat.alpha,
                              mat.beta, num_objects=o, block_size=s,
                              device=device)


def kernel_modules() -> dict:
    """kernel name -> the wrapper module holding its LAUNCHES count."""
    from openpbso_tpu_torch.ops import (ar_block, ar_noise, chunk_scan,
                                        fused_integrator, span_inject,
                                        span_reduce, toeplitz_conv)
    return {"fused_block": fused_integrator, "chunk_scan": chunk_scan,
            "toeplitz_conv": toeplitz_conv, "ar_noise": ar_noise,
            "ar_block": ar_block, "span_inject": span_inject,
            "span_reduce": span_reduce}


def reset_launches():
    for mod in kernel_modules().values():
        mod.LAUNCHES = 0


def read_launches() -> dict:
    return {name: mod.LAUNCHES for name, mod in kernel_modules().items()}


def span_want(busy, idle, drags=0) -> dict:
    """The kernels' launches of ``busy`` and ``idle`` (ring-down) chunked
    span dispatches, ``drags`` of the busy ones with the sustained
    channel: each one chunk_scan; a busy one one toeplitz_conv, one
    span_inject and two span_reduce (g, hom), with the channel one
    ar_noise and the noise's toeplitz_conv; a ring-down one span_reduce
    (hom)."""
    return dict(dict.fromkeys(KERNELS, 0), chunk_scan=busy + idle,
                toeplitz_conv=busy + drags, span_inject=busy,
                span_reduce=2 * busy + idle, ar_noise=drags)


def block_inputs(bank, s, rng):
    import torch
    o, m = bank.num_objects, bank.num_modes
    mask = bank.mask.cpu().numpy()

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=bank.device)
    return (dev(rng.standard_normal((o, m)) * mask),
            dev(rng.standard_normal((o, m)) * mask),
            dev(rng.standard_normal((o, m)) * mask),
            dev(rng.standard_normal((o, s))),
            dev(rng.uniform(0.5, 2.0, (o, m))))


def time_ms(fn, runs=TIMED_RUNS) -> float:
    """Median of per-call CUDA-event times, after two warm-up calls."""
    import torch
    for _ in range(2):
        fn()
    pairs = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def device_ms(fn, kernel, runs=TIMED_RUNS, traces=3, floor=None):
    """Device time (ms) of one launch of the CUDA kernel ``kernel`` that
    ``fn`` makes, from torch.profiler's trace of ``runs`` calls: the median
    duration. The tracer may drop records of a window, now and then all of
    them, and truncates some of a short call's: a trace holding fewer than
    half the launches, or with ``floor`` (the call's bound) a median below
    it, is taken again, up to ``traces`` times; more than one launch a call
    raises at once. When no trace gives a reading, raises, or with
    ``floor`` returns None (the caller has another)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA and kernel in e.name]
        check(len(times) <= runs, f"the profiler saw {len(times)} launches "
              f"of {kernel} in {runs} calls")
        kept = len(times) >= runs // 2
        ms = statistics.median(times) / 1e3 if kept else None
        if kept and (floor is None or ms >= floor):
            return ms
        print(f"device time: the profiler kept {len(times)} of {runs} "
              f"launches of {kernel}, median {ms} ms against a floor of "
              f"{floor} ms; tracing again", flush=True)
    check(floor is not None, f"the profiler kept fewer than {runs // 2} of "
          f"{runs} launches of {kernel} in {traces} traces")
    return None


def device_times(fn, name, bound, chained) -> dict:
    """A phase-13 call's device time: the profiler's (device_ms, its floor
    the call's bound), else, where no trace kept its launches with a
    median at or above the bound, the chained time ``chained``;
    ``device_from`` says which."""
    ms = device_ms(fn, CUDA_NAMES[name], floor=bound["bound_ms"])
    return ({"device_ms": ms, "device_from": "profiler"} if ms is not None
            else {"device_ms": chained, "device_from": "chain"})


def enqueue_ms(fn, runs=TIMED_RUNS) -> float:
    """The host's time to enqueue one call (no synchronisation inside)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(runs):
        fn()
    host = time.perf_counter() - t
    torch.cuda.synchronize()
    return 1e3 * host / runs


def toeplitz_case(label, g, f, timed=True, want=None) -> dict:
    """toeplitz_conv against its twin on (g, f): <= TOEPLITZ_DB and two
    runs bitwise equal, the variant variant_for picks ``want`` when given;
    timed beside the twin and one cuDNN conv1d call that computes the same
    function (the yardstick, never called by the port), at the short
    chunks also one torch.matmul on the materialised Toeplitz operand,
    with its achieved TFLOP/s and its shares of the FP32 (CUDA cores) and
    3xTF32 (tensor cores) bounds of bench/roofline.py."""
    import torch
    from openpbso_tpu_torch.bench import roofline
    from openpbso_tpu_torch.bench.toeplitz_ab import (
        chain_ms, conv1d_call, toeplitz_matmul_call)
    from openpbso_tpu_torch.ops import toeplitz_conv as k2
    got, again, plain = (fn(g, f) for fn in (
        k2.toeplitz_conv, k2.toeplitz_conv, k2.toeplitz_conv_reference))
    torch.cuda.synchronize()
    check(torch.equal(got, again),
          f"toeplitz_conv ({label}) differs between two runs")
    check(bool(torch.isfinite(got).all()),
          f"toeplitz_conv ({label}) not finite")
    o, nl, k, c = g.shape
    x = f.shape[2]
    out = {"case": label, "O": o, "L": nl, "K": k, "X": x, "C": c,
           "variant": k2.variant_for(o, nl, k, x, c),
           "db_vs_plain": db_error(got.cpu().numpy(), plain.cpu().numpy()),
           "max_abs_err": float((got - plain).abs().max())}
    check(want is None or out["variant"] == want,
          f"toeplitz_conv ({label}) routed to {out['variant']}, not {want}")
    check(out["db_vs_plain"] <= TOEPLITZ_DB,
          f"toeplitz_conv ({label}) {out['db_vs_plain']} dB vs plain")
    del got, again, plain
    if timed:
        call, _ = conv1d_call(g, f)
        bound = roofline.toeplitz_conv(o, nl, k, f.shape[2], c)
        out["ms"] = chain_ms(lambda: k2.toeplitz_conv(g, f))
        out.update(device_times(lambda: k2.toeplitz_conv(g, f),
                                "toeplitz_conv", bound, out["ms"]))
        out["plain_ms"] = time_ms(lambda: k2.toeplitz_conv_reference(g, f))
        out["library_ms"] = chain_ms(call)
        if x <= 16 and c <= 256:   # the operand of the short chunks fits
            matmul = toeplitz_matmul_call(g, f)
            out["matmul_ms"] = chain_ms(matmul)
            del matmul
            torch.cuda.empty_cache()
        out.update(bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                   tflops=bound["flops"] / out["ms"] / 1e9,
                   share_fp32_bound=bound["fp32_ms"] / out["ms"],
                   share_3xtf32_bound=bound["tf32x3_ms"] / out["ms"],
                   share_bound=bound["bound_ms"] / out["ms"])
    print("toeplitz_conv case:", json.dumps(out), flush=True)
    return out


def phase_toeplitz_shapes(seed, device) -> dict:
    """Phase 5c: toeplitz_conv at the span's short-chunk shapes."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for label, (o, nl, k, x, c) in TOEPLITZ_SHAPES:
        g = torch.randn((o, nl, k, c), generator=gen, device=device)
        f = torch.randn((o, k, x, c), generator=gen, device=device)
        out[label] = toeplitz_case(label, g, f)
    return out


def kernel_case(name, bank, s, chunk, rng, timed=False):
    """Phase 3 for one bank: kernel vs plain twin vs blocked."""
    import torch
    from openpbso_tpu_torch.ops import fused_integrator as fi
    from openpbso_tpu_torch.ops.integrator import step_block_blocked
    z_re, z_im, space, tp, tr = block_inputs(bank, s, rng)
    args = (z_re, z_im, bank, space, tp, tr)
    got = fi.step_block_fused(*args, chunk=chunk)[:3]
    again = fi.step_block_fused(*args, chunk=chunk)[:3]
    plain = fi.fused_block_reference(*args, chunk=chunk)
    blocked = step_block_blocked(*args)[:3]
    torch.cuda.synchronize()
    out = {"case": name, "O": bank.num_objects, "M": bank.num_modes,
           "S": s, "chunk": min(chunk, s), "max_abs_err": 0.0}
    for label, k, a, p, b in zip(("z_re", "z_im", "sound"), got, again,
                                 plain, blocked):
        check(torch.equal(k, a), f"{name}: {label} differs between two runs")
        k, p, b = (x.cpu().numpy() for x in (k, p, b))
        check(np.isfinite(k).all(), f"{name}: {label} not finite")
        out[f"{label}_db_vs_plain"] = db_error(k, p)
        out[f"{label}_db_vs_blocked"] = db_error(k, b)
        out["max_abs_err"] = max(out["max_abs_err"],
                                 float(np.max(np.abs(k - p))))
        check(out[f"{label}_db_vs_plain"] <= FUSED_DB,
              f"{name}: {label} {out[f'{label}_db_vs_plain']} dB vs plain")
        check(out[f"{label}_db_vs_blocked"] <= -90.0,
              f"{name}: {label} {out[f'{label}_db_vs_blocked']} dB vs "
              f"blocked")
    if timed:
        def step():
            return fi.step_block_fused(*args, chunk=chunk)
        out["kernel_ms"] = time_ms(step)
        out["device_ms"] = device_ms(step, CUDA_NAMES["fused_block"])
        out["enqueue_ms"] = enqueue_ms(step)
        out["plain_ms"] = time_ms(lambda: fi.fused_block_reference(
            *args, chunk=chunk))
        out["blocked_ms"] = time_ms(lambda: step_block_blocked(*args))
    print("kernel case:", json.dumps(out), flush=True)
    return out


def hit_script(rng, o, n_modes, block):
    """Point, gaussian and hertz hits on every third object; three in four
    future-dated (block-aligned, no later than LAST_HIT_BLOCK)."""
    kinds = ("point", "gaussian", "hertz")
    hits = []
    for i, obj in enumerate(range(0, o, 3)):
        when = (None if i % 4 == 0
                else int(rng.integers(1, LAST_HIT_BLOCK + 1)) * block)
        hits.append(dict(obj=obj, space=rng.standard_normal(n_modes),
                         kind=kinds[i % 3],
                         width_us=float(rng.uniform(200.0, 2000.0)),
                         amp=float(rng.uniform(0.5, 1.5)), when=when))
    return hits


def new_session(bank, ffat, listeners, hits, backend, lam64=None):
    from openpbso_tpu_torch.runtime.session import ModalSession
    from openpbso_tpu_torch.runtime.solver import SolverConfig
    sess = ModalSession(bank, ffat, SolverConfig(block_size=S,
                                                 backend=backend),
                        lam64=lam64)
    sess.set_listener(listeners)
    for h in hits:
        sess.hit(h["obj"], h["space"], kind=h["kind"],
                 width_us=h["width_us"], amp=h["amp"], when=h["when"])
    return sess


def session_scene(bank, rng) -> dict:
    """Phase 4's scene, which the later phases render again: the bank, its
    FFAT maps, per-object listeners, the hit script and the sample at which
    its last slot expires."""
    from openpbso_tpu_torch.utils.synth import synth_fatcube
    from openpbso_tpu_torch.ops.ffat import build_ffat
    t = time.perf_counter()
    freqs = np.geomspace(120.0, 15000.0, M)
    ffat = build_ffat({i: synth_fatcube(i, float(freqs[i]), n=16)
                       for i in range(M)}, M, device=bank.device)
    print(f"ffat maps: {M} modes in {time.perf_counter() - t} s", flush=True)
    listeners = rng.uniform(-1.0, 1.0, (O, 3)) * 2.0
    listeners[:, 2] += 1.0
    hits = hit_script(rng, O, M, S)
    return dict(bank=bank, ffat=ffat, listeners=listeners, hits=hits,
                last_expiry=script_expiry(hits))


def script_expiry(hits) -> int:
    """The sample at which a hit script's last slot expires: every block
    before it is busy (a future-dated slot keeps the scene live until it
    has fired)."""
    from openpbso_tpu_torch.config import SAMPLE_RATE
    from openpbso_tpu_torch.ops.forces import (FORCE_GAUSSIAN, FORCE_HERTZ,
                                               FORCE_POINT, slot_duration)
    code = {"point": FORCE_POINT, "gaussian": FORCE_GAUSSIAN,
            "hertz": FORCE_HERTZ}
    last_expiry = 0
    for h in hits:
        width = (1.0 if h["kind"] == "point"
                 else max(1, int(h["width_us"] / 1e6 * SAMPLE_RATE)))
        last_expiry = max(last_expiry, (h["when"] or 0)
                          + slot_duration(code[h["kind"]], width, S))
    return last_expiry


def phase_session(scene) -> dict:
    """Phase 4; returns the scene with the render and its launches."""
    import torch
    bank, ffat, listeners, hits, last_expiry = (scene[k] for k in (
        "bank", "ffat", "listeners", "hits", "last_expiry"))
    busy = sum(1 for b in range(RENDER_BLOCKS) if b * S < last_expiry)
    check(0 < busy < RENDER_BLOCKS, f"hit script leaves {busy} busy blocks")

    sess = new_session(bank, ffat, listeners, hits, "auto")
    check(sess.decay_eligible(), "fused session is not decay-eligible")
    reset_launches()
    mix = sess.render(RENDER_BLOCKS)
    counts = read_launches()
    launches = counts["fused_block"]
    check(all(n == 0 for k, n in counts.items() if k != "fused_block"),
          f"the per-block path launched other kernels: {counts}")
    check(mix.shape == (RENDER_BLOCKS * S, 2), f"mix shape {mix.shape}")
    check(bool(np.isfinite(mix).all()), "mix not finite")
    peak = float(np.abs(mix).max())
    check(peak > 0.0, "mix is silent")
    check(launches == busy and launches > 0,
          f"kernel launches {launches} != busy blocks {busy}")
    after = mix[(LAST_HIT_BLOCK + 4) * S:(LAST_HIT_BLOCK + 24) * S]
    tail = mix[-20 * S:]
    e_after, e_tail = float(np.sum(after ** 2)), float(np.sum(tail ** 2))
    check(e_tail < e_after, f"tail energy {e_tail} >= {e_after}")

    ref = new_session(bank, ffat, listeners, hits, "blocked").render(
        RENDER_BLOCKS)
    db_blocked = db_error(mix, ref)
    check(db_blocked <= -90.0, f"session mix {db_blocked} dB vs blocked")

    # synced per-block dispatch, split into full and idle decay blocks
    timed = new_session(bank, ffat, listeners, hits, "auto")
    full_ms, decay_ms = [], []
    for _ in range(RENDER_BLOCKS):
        decay = timed._idle() and timed.decay_eligible()
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, blk, _ = timed.step()
        blk.cpu()
        (decay_ms if decay else full_ms).append(
            1e3 * (time.perf_counter() - t))
    summary = {
        "blocks": RENDER_BLOCKS, "busy_blocks": busy, "launches": launches,
        "peak": peak, "energy_after_hits": e_after, "energy_tail": e_tail,
        "db_vs_blocked": db_blocked,
        "full_blocks": len(full_ms),
        "full_ms_median": statistics.median(full_ms),
        "full_ms_mean": statistics.fmean(full_ms),
        "decay_blocks": len(decay_ms),
        "decay_ms_median": statistics.median(decay_ms),
        "decay_ms_mean": statistics.fmean(decay_ms),
        "all_ms_mean": statistics.fmean(full_ms + decay_ms),
    }
    print("session:", json.dumps(summary), flush=True)
    return dict(scene, launches=launches, mix=mix)


def session_span_tables(bank, lam64, n_blocks):
    """The span tables a session dispatches n_blocks with (the flat
    chunked form: ModalSession.span_tables_for)."""
    from openpbso_tpu_torch.runtime.session import ModalSession
    from openpbso_tpu_torch.runtime.solver import SolverConfig
    sess = ModalSession(bank, config=SolverConfig(block_size=S),
                        lam64=lam64)
    return sess.span_tables_for(n_blocks)


def span_kernel_case(name, bank, lam64, n_blocks, seed):
    """Phase 5a for one bank: the chunk-scan and Toeplitz-conv kernels at
    the shapes a span of n_blocks gives them (one slot, one listener),
    against their twins, then one full span dispatch timed."""
    import torch
    from openpbso_tpu_torch.config import SAMPLE_RATE
    from openpbso_tpu_torch.ops import chunk_scan as k1
    from openpbso_tpu_torch.ops.forces import FORCE_GAUSSIAN
    from openpbso_tpu_torch.runtime.solver import default_gains, step_span
    from openpbso_tpu_torch.runtime.state import make_solver_state
    dev = bank.device
    t = time.perf_counter()
    tables = session_span_tables(bank, lam64, n_blocks)
    table_s = time.perf_counter() - t
    c, x, m = tables.chunk, tables.n_chunks, bank.num_modes
    check(tables.shared == (name == "shared"), f"{name}: table layout")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    scan_args = (randn(O, m), randn(O, m), tables.b_re[:, c],
                 tables.b_im[:, c], x, randn(O, x, m), randn(O, x, m))
    conv_args = (randn(O, 1, 1, c), randn(O, 1, x, c))
    out = {"case": name, "O": O, "M": m, "n_blocks": n_blocks, "chunk": c,
           "n_chunks": x, "table_build_s": table_s}
    got, again, plain = (fn(*scan_args) for fn in (
        k1.chunk_scan, k1.chunk_scan, k1.chunk_scan_reference))
    torch.cuda.synchronize()
    err, dbs = 0.0, []
    for k, a, p in zip(got, again, plain):
        check(torch.equal(k, a), f"{name}: chunk_scan differs between runs")
        check(bool(torch.isfinite(k).all()), f"{name}: chunk_scan not finite")
        err = max(err, float((k - p).abs().max()))
        dbs.append(db_error(k.cpu().numpy(), p.cpu().numpy()))
    check(max(dbs) <= -100.0, f"{name}: chunk_scan {max(dbs)} dB vs plain")
    del got, again, plain
    out["chunk_scan"] = {
        "db_vs_plain": max(dbs), "max_abs_err": err,
        "ms": time_ms(lambda: k1.chunk_scan(*scan_args)),
        "device_ms": device_ms(lambda: k1.chunk_scan(*scan_args),
                               CUDA_NAMES["chunk_scan"]),
        "plain_ms": time_ms(lambda: k1.chunk_scan_reference(*scan_args),
                            runs=10)}
    out["toeplitz_conv"] = toeplitz_case(f"{name} span", *conv_args)
    del scan_args, conv_args

    # one full span dispatch, as bench.py's span headline drives it: a
    # gaussian hit planted on every object, the one-slot bucket
    state = make_solver_state(O, m, num_slots=8, device=dev)
    state.slots.ftype[:, 0] = FORCE_GAUSSIAN
    state.slots.width[:, 0] = 40.0
    state.slots.space[:, 0] = randn(O, m)
    gains = default_gains(O, device=dev)
    spans = []
    for i in range(7):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        state, mix = step_span(state, bank, tables, gains,
                               n_blocks=n_blocks, block_size=S, num_slots=1)
        b.record()
        spans.append((a, b))
        if i == 0:
            check(bool(torch.isfinite(mix).all())
                  and float(mix.abs().max()) > 0, f"{name}: span mix")
    torch.cuda.synchronize()
    span_ms = statistics.median(a.elapsed_time(b) for a, b in spans[2:])
    out["span_ms"] = span_ms
    out["span_rtf"] = n_blocks * S / SAMPLE_RATE / (span_ms / 1e3)
    print("span kernel case:", json.dumps(out), flush=True)
    out["tables"] = tables      # phase 12b shares the hetero baby table
    return out


def span_call_kind(label, args) -> str:
    """Which call of a span dispatch a span-module kernel call is:
    chunk_scan "busy" (injections) or "decay"; span_reduce "g" (table row
    0), "hom" (with the convolution added) or "decay"; else "busy"."""
    if label == "chunk_scan":
        return "decay" if args[5] is None else "busy"
    if label == "span_reduce":
        if args[6] == 0:
            return "g"
        return "decay" if len(args) < 8 or args[7] is None else "hom"
    return "busy"


SPAN_TABLE_ARGS = {"span_inject": (3, 4), "span_reduce": (4, 5)}


@contextlib.contextmanager
def capture_span_kernel_inputs():
    """While open, keep a copy of the arguments of the first call of each
    kind (span_call_kind) that the span module makes of chunk_scan,
    toeplitz_conv, span_inject and span_reduce, so the kernels can be held
    against their twins on a real dispatch's own inputs (the power tables,
    which nothing writes, by reference)."""
    import torch
    from openpbso_tpu_torch.ops import span as span_mod
    captured = {}
    names = ("chunk_scan", "toeplitz_conv", "span_inject", "span_reduce")

    def capturing(fn, label):
        def call(*args):
            key = (label, span_call_kind(label, args))
            if key not in captured:
                keep = SPAN_TABLE_ARGS.get(label, ())
                captured[key] = [
                    a.clone() if isinstance(a, torch.Tensor)
                    and i not in keep else a for i, a in enumerate(args)]
            return fn(*args)
        return call
    originals = {n: getattr(span_mod, n) for n in names}
    for n in names:
        setattr(span_mod, n, capturing(originals[n], n))
    try:
        yield captured
    finally:
        for n in names:
            setattr(span_mod, n, originals[n])


CONTRACTION_DB = -110.0      # the 3xTF32 span GEMMs against their twins
CONTRACTION_INPUTS = {}      # label -> {kind: args}: 8c's and 10b's inputs
ENGINE_STATS = {}            # 7d's streams -> p50 and p99 ms a block


def keep_contraction_inputs(label, captured):
    """Keep a dispatch's captured span_inject and span_reduce inputs for
    phase 13's timings."""
    CONTRACTION_INPUTS[label] = {
        "span_inject": captured[("span_inject", "busy")],
        "g": captured[("span_reduce", "g")],
        "hom": captured[("span_reduce", "hom")]}


TWIN_ARGS = {"span_inject": 5, "span_reduce": 8}   # the twins' arguments


def contraction_call(name):
    """span_inject's or span_reduce's wrapper and plain twin, the twin
    called without the planes (the wrappers' last argument: the twin
    reads the table itself)."""
    from openpbso_tpu_torch.ops import span_inject as k3
    from openpbso_tpu_torch.ops import span_reduce as k4
    kernel, twin = ((k3.span_inject, k3.span_inject_reference)
                    if name == "span_inject"
                    else (k4.span_reduce, k4.span_reduce_reference))
    return kernel, lambda *args: twin(*args[:TWIN_ARGS[name]])


def contraction_case(label, name, args) -> dict:
    """span_inject or span_reduce against its twin on ``args``: <=
    CONTRACTION_DB and two runs bitwise equal."""
    import torch
    kernel, twin = contraction_call(name)
    got, again, plain = (fn(*args) for fn in (kernel, kernel, twin))
    if name == "span_reduce":
        got, again, plain = [got], [again], [plain]
    torch.cuda.synchronize()
    out = {"case": label, "kernel": name, "max_abs_err": 0.0,
           "shapes": [list(a.shape) for a in args
                      if isinstance(a, torch.Tensor)]}
    dbs = []
    for k, a, p in zip(got, again, plain):
        check(torch.equal(k, a), f"{name} ({label}) differs between runs")
        check(bool(torch.isfinite(k).all()), f"{name} ({label}) not finite")
        dbs.append(db_error(k.cpu().numpy(), p.cpu().numpy()))
        out["max_abs_err"] = max(out["max_abs_err"],
                                 float((k - p).abs().max()))
    out["db_vs_plain"] = max(dbs)
    check(out["db_vs_plain"] <= CONTRACTION_DB,
          f"{name} ({label}) {out['db_vs_plain']} dB vs plain")
    return out


def check_dispatch_inputs(captured) -> dict:
    """Each captured dispatch's kernel call against its twin: chunk_scan
    <= -100 dB, toeplitz_conv through toeplitz_case, span_inject and
    span_reduce through contraction_case."""
    import torch
    from openpbso_tpu_torch.ops import chunk_scan as k1
    want = {("chunk_scan", "busy"), ("chunk_scan", "decay"),
            ("toeplitz_conv", "busy"), ("span_inject", "busy"),
            ("span_reduce", "g"), ("span_reduce", "hom"),
            ("span_reduce", "decay")}
    check(set(captured) == want, f"captured span calls {sorted(captured)}")
    out = {}
    for (label, kind), args in sorted(captured.items()):
        shapes = [list(a.shape) for a in args if isinstance(a, torch.Tensor)]
        if label == "toeplitz_conv":
            out[f"{label}_{kind}"] = dict(
                toeplitz_case(f"{kind} dispatch", *args), shapes=shapes)
            continue
        if label in ("span_inject", "span_reduce"):
            out[f"{label}_{kind}"] = contraction_case(f"{kind} dispatch",
                                                      label, args)
            continue
        got, plain = k1.chunk_scan(*args), k1.chunk_scan_reference(*args)
        torch.cuda.synchronize()
        db = max(db_error(k.cpu().numpy(), p.cpu().numpy())
                 for k, p in zip(got, plain))
        check(db <= -100.0, f"{label} ({kind} dispatch) {db} dB vs plain")
        out[f"{label}_{kind}"] = {"db_vs_plain": db, "shapes": shapes}
    return out


def phase_span_session(bank, lam64, per_block):
    """Phase 5b: phase 4's session and script, built with lam64, rendered
    by render_multi through the span kernels; each distinct table's planes
    built exactly once."""
    import torch
    from openpbso_tpu_torch.config import SAMPLE_RATE
    from openpbso_tpu_torch.ops import span as span_mod
    ffat, listeners, hits = (per_block[k] for k in ("ffat", "listeners",
                                                    "hits"))
    sizes = {SPAN_DISPATCH, RENDER_BLOCKS % SPAN_DISPATCH} - {0}
    n_dispatch = math.ceil(RENDER_BLOCKS / SPAN_DISPATCH)
    busy = sum(1 for d in range(n_dispatch)
               if d * SPAN_DISPATCH * S < per_block["last_expiry"])
    check(0 < busy < n_dispatch, f"{busy} of {n_dispatch} spans are busy")

    sess = new_session(bank, ffat, listeners, hits, "auto", lam64=lam64)
    span_mod.PLANE_BUILDS = 0
    t = time.perf_counter()
    for n in sizes:
        sess.span_tables_for(n)
    table_s = time.perf_counter() - t
    with capture_span_kernel_inputs() as dispatch_inputs:
        reset_launches()
        t = time.perf_counter()
        mix = sess.render_multi(RENDER_BLOCKS,
                                blocks_per_dispatch=SPAN_DISPATCH)
        render_s = time.perf_counter() - t
        counts = read_launches()
    # the planes of each distinct table, built once, with the tables
    tables = len({id(t) for t in sess._span_cache.values()})
    check(span_mod.PLANE_BUILDS == tables,
          f"5b: {span_mod.PLANE_BUILDS} plane builds for {tables} tables")
    check(mix.shape == (RENDER_BLOCKS * S, 2), f"span mix shape {mix.shape}")
    check(bool(np.isfinite(mix).all()) and float(np.abs(mix).max()) > 0,
          "span mix not finite or silent")
    want = span_want(busy, n_dispatch - busy)
    check(counts == want, f"span launches {counts} != {want}")
    db_fused = db_error(mix, per_block["mix"])
    check(db_fused <= -90.0, f"span mix {db_fused} dB vs the fused render")
    dispatch_db = check_dispatch_inputs(dispatch_inputs)

    # synced span dispatches, as render_multi issues them
    timed = new_session(bank, ffat, listeners, hits, "auto", lam64=lam64)
    for n in sizes:
        timed.span_tables_for(n)
    busy_ms, idle_ms = [], []
    done = 0
    while done < RENDER_BLOCKS:
        n = min(SPAN_DISPATCH, RENDER_BLOCKS - done)
        idle = timed._idle()
        torch.cuda.synchronize()
        t = time.perf_counter()
        timed._step_span(n).cpu()
        (idle_ms if idle else busy_ms).append(1e3 * (time.perf_counter() - t))
        done += n
    audio_s = RENDER_BLOCKS * S / SAMPLE_RATE
    summary = {
        "blocks": RENDER_BLOCKS, "blocks_per_dispatch": SPAN_DISPATCH,
        "dispatches": n_dispatch, "busy_dispatches": busy,
        "launches": counts, "db_vs_fused_render": db_fused,
        "plane_builds": span_mod.PLANE_BUILDS,
        "kernel_db_vs_plain_on_dispatch_inputs": dispatch_db,
        "table_build_s": table_s,
        "first_render_multi_s": render_s,   # includes first-use set-up
        "busy_span_ms": busy_ms, "idle_span_ms": idle_ms,
        "busy_span_ms_median": statistics.median(busy_ms),
        "idle_span_ms_median": statistics.median(idle_ms),
        "span_rtf": audio_s / (1e-3 * sum(busy_ms + idle_ms)),
    }
    print("span session:", json.dumps(summary), flush=True)
    return counts


def drag_channel(o, seed, device):
    """A sustained channel: every fourth object inactive and a ringing
    history."""
    import torch
    from openpbso_tpu_torch.ops.forces import make_sustained_state
    st = make_sustained_state(o, M, seed=seed, device=device)
    rng = np.random.default_rng(seed)
    st.active[:] = torch.as_tensor(np.arange(o) % 4 != 3)
    st.ar_hist[:] = torch.as_tensor(rng.standard_normal((o, 2)) * 0.01)
    return st


def noise_case(key, block_start, n_blocks, timed=False) -> dict:
    """ar_noise against its threefry twin: the bits bitwise, the normals
    <= -120 dB, two runs bitwise equal."""
    import torch
    from openpbso_tpu_torch.ops import ar_noise as ka
    idx0, period = ka.block_counter(block_start, S)
    got, again = (ka.ar_noise(key, block_start, n_blocks, S)
                  for _ in range(2))
    bits = ka.ar_noise(key, block_start, n_blocks, S, bits=True)
    plain = ka.ar_noise_reference(key, idx0, n_blocks, period, S)
    bits_equal = torch.equal(bits, ka.ar_noise_reference(
        key, idx0, n_blocks, period, S, bits=True))
    torch.cuda.synchronize()
    label = f"ar_noise {list(got.shape)} from {block_start}"
    check(torch.equal(got, again), f"{label}: differs between two runs")
    check(bits_equal, f"{label}: bits differ from the twin's")
    check(bool(torch.isfinite(got).all()), f"{label}: not finite")
    out = {"shape": list(got.shape), "block_start": block_start,
           "bits_bitwise": bits_equal,
           "normals_bitwise": bool(torch.equal(got, plain)),
           "db_vs_plain": db_error(got.cpu().numpy(), plain.cpu().numpy()),
           "max_abs_err": float((got - plain).abs().max())}
    check(out["db_vs_plain"] <= -120.0,
          f"{label}: normals {out['db_vs_plain']} dB vs plain")
    del got, again, bits, plain
    if timed:
        out["ms"] = time_ms(lambda: ka.ar_noise(key, block_start, n_blocks,
                                                S))
        out["device_ms"] = device_ms(
            lambda: ka.ar_noise(key, block_start, n_blocks, S),
            CUDA_NAMES["ar_noise"])
        out["plain_ms"] = time_ms(lambda: ka.ar_noise_reference(
            key, idx0, n_blocks, period, S), runs=5)
    return out


def block_case(st, block_start, timed=False) -> dict:
    """ar_block against its twin: bitwise given the kernel's own normals,
    <= -100 dB with the twin's, two runs bitwise equal."""
    import torch
    from openpbso_tpu_torch.ops import ar_block as kb
    from openpbso_tpu_torch.ops import ar_noise as ka
    args = (st.key, st.a, st.ar_hist, st.sigma, st.mu, st.active)
    idx, _ = ka.block_counter(block_start, S)
    got, again = (kb.ar_block(*args, block_start, S) for _ in range(2))
    noise = ka.ar_noise(st.key, block_start, 1, S)[:, 0]
    given = kb.ar_block_reference(*args, idx, S, noise=noise)
    own = kb.ar_block_reference(*args, idx, S)
    torch.cuda.synchronize()
    label = f"ar_block from {block_start}"
    dbs = []
    for name, k, a, g, r in zip(("profile", "hist"), got, again, given, own):
        check(torch.equal(k, a), f"{label}: {name} differs between runs")
        check(torch.equal(k, g), f"{label}: {name} differs from the twin "
              "on the kernel's normals")
        check(bool(torch.isfinite(k).all()), f"{label}: {name} not finite")
        dbs.append(db_error(k.cpu().numpy(), r.cpu().numpy()))
    inactive = ~st.active
    check(bool((got[0][inactive] == 0).all())
          and torch.equal(got[1][inactive], st.ar_hist[inactive]),
          f"{label}: inactive objects not left alone")
    check(max(dbs) <= -100.0, f"{label}: {max(dbs)} dB vs the twin")
    out = {"objects": st.key.shape[0],
           "active": int(st.active.sum()), "block_start": block_start,
           "bitwise_vs_plain_given_normals": True,
           "db_vs_plain_own_normals": max(dbs),
           "max_abs_err": max(float((k - g).abs().max())
                              for k, g in zip(got, given))}
    if timed:
        def step():
            return kb.ar_block(*args, block_start, S)
        out["ms"] = time_ms(step)
        out["device_ms"] = device_ms(step, CUDA_NAMES["ar_block"])
        out["enqueue_ms"] = enqueue_ms(step)
        out["plain_ms"] = time_ms(lambda: kb.ar_block_reference(
            *args, idx, S), runs=5)
    return out


def phase_ar_kernels(seed, device) -> dict:
    """Phase 6a: the two AR kernels and the noise-conv use of
    toeplitz_conv against their twins at the shapes the channel gives
    them."""
    import torch
    from openpbso_tpu_torch.config import REBASE_PERIOD
    from openpbso_tpu_torch.ops import ar_noise as ka
    from openpbso_tpu_torch.ops.forces import ar_impulse_g
    st = drag_channel(O, seed, device)
    out = {"ar_noise": noise_case(st.key, 0, SUS_SPAN_BLOCKS, timed=True),
           "ar_noise_wrap": noise_case(st.key, REBASE_PERIOD - 8 * S, 16),
           "ar_block": block_case(st, 3 * S, timed=True),
           "ar_block_wrap": block_case(st, REBASE_PERIOD + 5 * S)}
    # the noise convolution of sustained_span: K = 1, C = S, X = 512
    g = torch.as_tensor(ar_impulse_g((0.783, 0.116), S)[:, :S],
                        dtype=torch.float32, device=st.key.device)
    args = (g.expand(O, S)[:, None, None, :],
            ka.ar_noise(st.key, 0, SUS_SPAN_BLOCKS, S)[:, None])
    out["toeplitz_conv_noise"] = toeplitz_case("AR noise conv", *args)
    print("ar kernels:", json.dumps(out), flush=True)
    return out


def phase_sustained_span(bank, lam64, seed) -> dict:
    """Phase 6b: one sustained span dispatch as bench.py --sustained drives
    it (bench.py:159-176): every object dragging, the drag-only bucket, a
    span-covering shared AR table (grp 512); then one object retuned, a
    per-object table capped at 32 blocks."""
    import torch
    from openpbso_tpu_torch.config import SAMPLE_RATE
    from openpbso_tpu_torch.ops.forces import FORCE_GAUSSIAN, ar_impulse_g
    from openpbso_tpu_torch.runtime.session import ModalSession
    from openpbso_tpu_torch.runtime.solver import default_gains, step_span
    from openpbso_tpu_torch.runtime.state import make_solver_state
    dev, m, n_blocks = bank.device, bank.num_modes, SUS_SPAN_BLOCKS
    tables = session_span_tables(bank, lam64, n_blocks)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = make_solver_state(O, m, num_slots=8, seed=seed, device=dev)
    state.slots.ftype[:, 0] = FORCE_GAUSSIAN
    state.slots.width[:, 0] = 40.0
    state.slots.space[:, 0] = torch.randn((O, m), generator=gen, device=dev)
    state.sustained.active[:] = True
    state.sustained.space[:] = torch.randn((O, m), generator=gen, device=dev)
    gains = default_gains(O, device=dev)
    a = np.tile([[0.783, 0.116]], (O, 1))
    out = {"O": O, "M": m, "n_blocks": n_blocks, "chunk": tables.chunk}
    for case in ("shared", "per_object"):
        if case == "per_object":
            a[7] = (0.9, 0.05)
            state.sustained.a[7] = torch.tensor(a[7], device=dev)
        shared = case == "shared"
        grp = (ModalSession.AR_GROUP_CAP_SHARED if shared
               else ModalSession.AR_GROUP_CAP_PER_OBJECT)
        ar_g = torch.as_tensor(ar_impulse_g(a[:1] if shared else a, grp * S),
                               dtype=torch.float32, device=dev)
        st, spans = state, []
        for i in range(7):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            st, mix = step_span(st, bank, tables, gains, n_blocks=n_blocks,
                                block_size=S, num_slots=0,
                                with_sustained=True, ar_g=ar_g)
            t1.record()
            spans.append((t0, t1))
            if i == 0:
                check(bool(torch.isfinite(mix).all())
                      and float(mix.abs().max()) > 0,
                      f"sustained span ({case}): mix")
        torch.cuda.synchronize()
        ms = statistics.median(t0.elapsed_time(t1) for t0, t1 in spans[2:])
        out[case] = {"ar_table": list(ar_g.shape), "group": grp,
                     "span_ms": ms,
                     "span_rtf": n_blocks * S / SAMPLE_RATE / (ms / 1e3)}
    print("sustained span:", json.dumps(out), flush=True)
    return out


@contextlib.contextmanager
def capture_ar_kernel_inputs():
    """While open, keep a copy of the arguments of the first ar_noise and
    ar_block calls the forces module makes."""
    import torch
    from openpbso_tpu_torch.ops import forces as forces_mod
    captured = {}

    def capturing(fn, label):
        def call(*args):
            if label not in captured:
                captured[label] = [a.clone() if isinstance(a, torch.Tensor)
                                   else a for a in args]
            return fn(*args)
        return call
    originals = forces_mod.ar_noise, forces_mod.ar_block
    forces_mod.ar_noise = capturing(originals[0], "ar_noise")
    forces_mod.ar_block = capturing(originals[1], "ar_block")
    try:
        yield captured
    finally:
        forces_mod.ar_noise, forces_mod.ar_block = originals


def phase_sustained_session(bank, lam64, per_block) -> dict:
    """Phase 6c: phase 4's session and hit script plus drags, rendered per
    block and by span; returns the launch counts of each path."""
    import torch
    from openpbso_tpu_torch.config import SAMPLE_RATE
    from openpbso_tpu_torch.ops import ar_block as kb
    from openpbso_tpu_torch.ops import ar_noise as ka
    ffat, listeners, hits = (per_block[k] for k in ("ffat", "listeners",
                                                    "hits"))
    rng = np.random.default_rng(7)
    dragged = list(range(1, O, O // DRAGGED))[:DRAGGED]
    starts = rng.standard_normal((DRAGGED, M))
    updates = rng.standard_normal((DRAGGED, M))
    start_b, update_b, retune_b, end_b = DRAG_EVENTS
    segments = (start_b, update_b - start_b, retune_b - update_b,
                end_b - retune_b, RENDER_BLOCKS - end_b)

    def run(sess, render):
        out, seconds = [], []
        events = (
            lambda: [sess.sustained_start(o, v)
                     for o, v in zip(dragged, starts)],
            lambda: [sess.sustained_update(o, v)
                     for o, v in zip(dragged, updates)],
            lambda: sess.set_ar_params(dragged[0], sigma=0.003, mu=0.1),
            lambda: [sess.sustained_end(o) for o in dragged],
            lambda: None)
        for n, event in zip(segments, events):
            t = time.perf_counter()
            out.append(render(n))
            seconds.append(time.perf_counter() - t)
            event()
        return np.concatenate(out), seconds

    result = {"dragged": DRAGGED, "events_at_blocks": list(DRAG_EVENTS)}
    sess = new_session(bank, ffat, listeners, hits, "auto")
    with capture_ar_kernel_inputs() as block_inputs:
        reset_launches()
        block_mix, block_s = run(sess, sess.render)
        block_counts = read_launches()
    span_sess = new_session(bank, ffat, listeners, hits, "auto",
                            lam64=lam64)
    t = time.perf_counter()
    span_sess.span_tables_for(SPAN_DISPATCH)
    result["table_build_s"] = time.perf_counter() - t
    with capture_ar_kernel_inputs() as span_inputs:
        reset_launches()
        span_mix, span_s = run(span_sess, lambda n: span_sess.render_multi(
            n, blocks_per_dispatch=SPAN_DISPATCH))
        span_counts = read_launches()

    # expected launches, from the hit script's expiry and the drag blocks
    drag = [start_b <= b < end_b for b in range(RENDER_BLOCKS)]
    busy = [b * S < per_block["last_expiry"] or drag[b]
            for b in range(RENDER_BLOCKS)]
    check(block_counts == dict(dict.fromkeys(KERNELS, 0),
                               fused_block=sum(busy), ar_block=sum(drag)),
          f"per-block launches {block_counts}")
    dispatches = [b0 + d for b0, n in zip((0,) + DRAG_EVENTS, segments)
                  for d in range(0, n, SPAN_DISPATCH)]
    n_busy = sum(busy[b] for b in dispatches)
    want = span_want(n_busy, len(dispatches) - n_busy,
                     sum(drag[b] for b in dispatches))
    check(span_counts == want, f"span launches {span_counts} != {want}")
    for label, mix in (("per-block", block_mix), ("span", span_mix)):
        check(mix.shape == (RENDER_BLOCKS * S, 2)
              and bool(np.isfinite(mix).all())
              and float(np.abs(mix).max()) > 0,
              f"{label} drag mix not finite or silent")
    result["db_span_vs_per_block"] = db_error(span_mix, block_mix)
    print(f"sustained session: span vs per-block render "
          f"{result['db_span_vs_per_block']} dB", flush=True)
    check(result["db_span_vs_per_block"] <= -60.0,
          f"span render {result['db_span_vs_per_block']} dB vs per-block")
    drag_blocks = end_b - start_b
    drag_s = sum(block_s[1:4])
    result.update(
        launches_per_block=block_counts, launches_span=span_counts,
        drag_block_ms_mean=1e3 * drag_s / drag_blocks,
        drag_span_ms_mean=1e3 * sum(span_s[1:4]) / want["ar_noise"],
        per_block_rtf=RENDER_BLOCKS * S / SAMPLE_RATE / sum(block_s),
        span_rtf=RENDER_BLOCKS * S / SAMPLE_RATE / sum(span_s))

    # each kernel against its twin on the first drag dispatch's inputs
    key, start, n_blocks, s = span_inputs["ar_noise"]
    result["ar_noise_first_drag_span"] = noise_case(key, start, n_blocks)
    args = block_inputs["ar_block"]
    idx, _ = ka.block_counter(args[6], S)
    got = kb.ar_block(*args)
    given = kb.ar_block_reference(*args[:6], idx, S,
                                  noise=ka.ar_noise(args[0], args[6], 1,
                                                    S)[:, 0])
    torch.cuda.synchronize()
    check(all(torch.equal(k, g) for k, g in zip(got, given)),
          "ar_block differs from its twin on the first drag block")
    result["ar_block_first_drag_block"] = {"bitwise_vs_plain": True,
                                           "block_start": args[6]}
    print("sustained session:", json.dumps(result), flush=True)
    return {"block": block_counts, "span": span_counts}


def cuda_ms(fn) -> float:
    """CUDA-event time (ms) of one call of ``fn`` on a drained device."""
    import torch
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def live_session(scene, lam64=None, hits=(), smooth=True):
    """A session over phase 4's bank, maps and listeners as the live phases
    build it: the backend the bank's layout picks, smooth listener moves
    on."""
    from openpbso_tpu_torch.runtime.session import ModalSession
    from openpbso_tpu_torch.runtime.solver import SolverConfig
    sess = ModalSession(scene["bank"], scene["ffat"], SolverConfig(
        block_size=S, backend="auto", smooth_transfer=smooth), lam64=lam64)
    sess.set_listener(scene["listeners"])
    for h in hits:
        sess.hit(h["obj"], h["space"], kind=h["kind"],
                 width_us=h["width_us"], amp=h["amp"], when=h.get("when"))
    return sess


def phase_xfade(scene, rng) -> dict:
    """Phase 7a: one transfer-ramp block on the fused backend."""
    import dataclasses

    import torch
    from openpbso_tpu_torch.runtime.solver import (default_gains,
                                                   step_block,
                                                   step_block_xfade)
    bank, dev = scene["bank"], scene["bank"].device
    rows = scene["rows"]
    state = block_state(scene, rng, rows[1])
    gains = default_gains(O, device=dev)
    kw = dict(block_size=S, backend="auto", with_sustained=False)

    reset_launches()
    new, sound, _, _ = step_block_xfade(state, bank, gains, rows[0], **kw)
    noop = step_block_xfade(state, bank, gains, rows[1], **kw)[1]
    check(read_launches()["fused_block"] == 0,
          "an xfade block launched the fused kernel")
    const = [step_block(dataclasses.replace(state, transfer=r), bank, gains,
                        **kw) for r in rows]
    check(read_launches()["fused_block"] == 2,
          "the constant-row renders did not go through the fused kernel")
    ramp = torch.arange(1, S + 1, device=dev, dtype=torch.float32) / S
    blend = const[0][1] + ramp * (const[1][1] - const[0][1])
    torch.cuda.synchronize()
    check(bool(torch.isfinite(sound).all()) and float(sound.abs().max()) > 0,
          "xfade sound not finite or silent")
    out = {
        "db_vs_fused_blend": db_error(sound.cpu().numpy(),
                                      blend.cpu().numpy()),
        "db_state_vs_fused": db_error(new.z_im.cpu().numpy(),
                                      const[1][0].z_im.cpu().numpy()),
        "db_noop_vs_plain_step": db_error(noop.cpu().numpy(),
                                          const[1][1].cpu().numpy()),
        "ms": statistics.median(cuda_ms(lambda: step_block_xfade(
            state, bank, gains, rows[0], **kw)) for _ in range(7)),
        "fused_step_ms": statistics.median(cuda_ms(lambda: step_block(
            state, bank, gains, **kw)) for _ in range(7)),
    }
    for key in ("db_vs_fused_blend", "db_state_vs_fused",
                "db_noop_vs_plain_step"):
        check(out[key] <= -90.0, f"xfade {key} {out[key]} dB")
    print("xfade:", json.dumps(out), flush=True)
    return out


def block_state(scene, rng, transfer):
    """A solver state at full width with a ringing bank and a live gaussian
    slot on every object, under the given transfer rows."""
    import dataclasses

    from openpbso_tpu_torch.ops.forces import FORCE_GAUSSIAN
    from openpbso_tpu_torch.runtime.state import make_solver_state
    bank = scene["bank"]
    z_re, z_im, space, _, _ = block_inputs(bank, S, rng)
    state = make_solver_state(O, bank.num_modes, num_slots=4,
                              device=bank.device)
    state.slots.ftype[:, 0] = FORCE_GAUSSIAN
    state.slots.width[:, 0] = 40.0
    state.slots.space[:, 0] = space
    return dataclasses.replace(state, z_re=z_re, z_im=z_im,
                               transfer=transfer)


def phase_qnorm(scene, rng) -> dict:
    """Phase 7b: a block with the per-mode energy telemetry on the fused
    backend, and the session's probe."""
    import torch
    from openpbso_tpu_torch.runtime.solver import default_gains, step_block
    from openpbso_tpu_torch.runtime.state import clone_state, state_leaves
    bank, dev = scene["bank"], scene["bank"].device
    state = block_state(scene, rng, scene["rows"][0])
    gains = default_gains(O, device=dev)
    kw = dict(block_size=S, with_sustained=False)

    plain = step_block(state, bank, gains, backend="auto", **kw)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    withq = step_block(state, bank, gains, backend="auto",
                       compute_qnorm=True, **kw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - resident
    check(read_launches()["fused_block"] == 1,
          "the qnorm block did not step through the fused kernel")
    for name, a, b in (("z_re", withq[0].z_re, plain[0].z_re),
                       ("z_im", withq[0].z_im, plain[0].z_im),
                       ("sound", withq[1], plain[1]),
                       ("mix", withq[2], plain[2])):
        check(torch.equal(a, b), f"qnorm changed the step's {name}")
    qnorm = withq[3]
    check(plain[3] is None and tuple(qnorm.shape) == (O, bank.num_modes)
          and bool(torch.isfinite(qnorm).all()) and float(qnorm.max()) > 0,
          "qnorm shape or values")
    scan = step_block(state, bank, gains, backend="scan",
                      compute_qnorm=True, **kw)[3]
    out = {"db_vs_scan": db_error(qnorm.cpu().numpy(), scan.cpu().numpy()),
           "peak_bytes_above_resident": peak,
           "resident_bytes": resident,
           "ms": statistics.median(cuda_ms(lambda: step_block(
               state, bank, gains, backend="auto", compute_qnorm=True,
               **kw)) for _ in range(5))}
    check(out["db_vs_scan"] <= -100.0,
          f"qnorm {out['db_vs_scan']} dB vs the scan backend's")
    del withq, plain, scan

    sess = live_session(scene, hits=scene["engine_hits"])
    sess.render(3)
    before = clone_state(sess.state)
    clock = sess.sample_clock
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    probe = sess.qnorm_probe()
    torch.cuda.synchronize()
    out["probe_peak_bytes_above_resident"] = (
        torch.cuda.max_memory_allocated() - resident)
    check(sess.sample_clock == clock, "qnorm_probe moved the clock")
    for a, b in zip(state_leaves(before), state_leaves(sess.state)):
        check(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b,
              "qnorm_probe changed the state")
    check(tuple(probe.shape) == (O, bank.num_modes)
          and bool(torch.isfinite(probe).all()) and float(probe.max()) > 0,
          "qnorm_probe shape or values")
    out["probe_ms"] = statistics.median(
        cuda_ms(sess.qnorm_probe) for _ in range(5))
    print("qnorm:", json.dumps(out), flush=True)
    return out


def phase_moving(scene) -> dict:
    """Phase 7c: render_moving along a listener path, rows held and
    ramped, against the per-move flow."""
    t_blocks = MOVING_BLOCKS
    ang = 0.2 * np.arange(t_blocks)
    delta = 0.5 * np.stack([np.cos(ang), np.sin(ang), 0.2 * np.sin(3 * ang)],
                           axis=1)
    path = scene["listeners"][None] + delta[:, None, :]       # [T, O, 3]
    hits = scene["hits"]
    out = {"blocks": t_blocks}
    for smooth in (False, True):
        label = "ramped" if smooth else "held"
        sess = live_session(scene, hits=hits, smooth=smooth)
        reset_launches()
        t = time.perf_counter()
        got = sess.render_moving(path, smooth=smooth)
        seconds = time.perf_counter() - t
        counts = read_launches()
        want = dict.fromkeys(KERNELS, 0)
        want["fused_block"] = 0 if smooth else t_blocks
        check(counts == want, f"render_moving ({label}) launches {counts}")
        ref_sess = live_session(scene, hits=hits, smooth=smooth)
        ref = []
        for p in path:
            ref_sess.set_listener(p)
            ref.append(ref_sess.step()[1].cpu().numpy())
        ref = np.concatenate(ref)
        check(got.shape == (t_blocks * S, 2)
              and bool(np.isfinite(got).all())
              and float(np.abs(got).max()) > 0,
              f"render_moving ({label}) not finite or silent")
        db = db_error(got, ref)
        check(db <= -90.0, f"render_moving ({label}) {db} dB vs per move")
        check(sess.sample_clock == ref_sess.sample_clock == t_blocks * S,
              "render_moving clock")
        out[label] = {"db_vs_per_move": db, "launches": counts,
                      "ms_per_block": 1e3 * seconds / t_blocks}
    print("moving listener:", json.dumps(out), flush=True)
    return out


def fused_rows(sess) -> bool:
    """Whether the session's full blocks launch fused_block: the backend
    the solver picks for its rows (solver.block_backend; listener and
    complex rows take the blocked form)."""
    from openpbso_tpu_torch.ops.integrator import resolve_backend_name
    from openpbso_tpu_torch.runtime.solver import block_backend
    if resolve_backend_name(sess.config.backend, sess.bank) != "fused":
        return False      # no rows take the kernel (a mesh: blocked)
    return block_backend(sess.state, sess.config.backend,
                         sess.bank) == "fused"


def dispatch_log(sess) -> list:
    """Wrap the session's dispatch methods so that each call appends
    (kind, blocks, with_sustained, fused) to the returned list, resolved
    from the host mirrors and rows exactly as the method resolves them
    (``fused``: a full block through fused_block). Warmup's calls are
    logged like the stream's."""
    log = []
    full, xfade = sess._step_full, sess._step_xfade
    decay, span = sess._step_decay, sess._step_span
    span_sound = sess._step_span_sound

    def sustained(flag):
        return sess._with_sustained() if flag is None else flag

    def _full(with_sustained=None, num_slots="auto"):
        log.append(("full", 1, sustained(with_sustained), fused_rows(sess)))
        return full(with_sustained, num_slots)

    def _xfade(prev, with_sustained=None, num_slots="auto"):
        log.append(("xfade", 1, sustained(with_sustained), False))
        return xfade(prev, with_sustained, num_slots)

    def _decay():
        log.append(("decay", 1, False, False))
        return decay()

    def spans(inner):
        # _step_span, or _step_span_sound when a post-mix takes the span
        def _span(n, num_slots="auto", idle=None, with_sustained=None,
                  ar_per_object=False):
            if idle is None:
                idle = sess._idle() and sess.config.decay_fast_path
            log.append(("idle_span", n, False, False) if idle
                       else ("span", n, sustained(with_sustained), False))
            return inner(n, num_slots, idle, with_sustained, ar_per_object)
        return _span

    sess._step_full, sess._step_xfade = _full, _xfade
    sess._step_decay, sess._step_span = _decay, spans(span)
    sess._step_span_sound = spans(span_sound)
    return log


def expected_launches(log) -> dict:
    """The kernels' launches that a dispatch log of a heterogeneous CUDA
    session implies: a full block steps through fused_block where its rows
    take it, plus ar_block with the sustained channel; an xfade block goes
    through the blocked form; a span launches what span_want counts (one
    chunk_scan; unless idle one toeplitz_conv, one span_inject and two
    span_reduce, idle one span_reduce; with the channel one ar_noise and
    the noise's toeplitz_conv)."""
    want = dict.fromkeys(KERNELS, 0)
    for kind, _, with_sustained, fused in log:
        want["fused_block"] += fused
        if kind in ("full", "xfade"):
            want["ar_block"] += bool(with_sustained)
        if kind in ("span", "idle_span"):
            busy = kind == "span"
            for k, n in span_want(busy, not busy,
                                  busy and bool(with_sustained)).items():
                want[k] += n
    return want


def reckon_launches(recorded, sizes, spans, moved, fused) -> tuple:
    """The launches an engine stream over a heterogeneous CUDA session must
    make, reckoned without the session: from the events the engine recorded
    as it applied them (each stamped with its block's first sample) and the
    blocks each dispatch held. A listener move takes the next block through
    the transfer ramp (the blocked form: no fused_block); a block with every
    hit's slot expired and no drag is idle (the decay step, or a span of
    chunk_scan and one span_reduce; a busy span adds toeplitz_conv,
    span_inject and a second span_reduce); a drag adds ar_block per block,
    or ar_noise and the noise's toeplitz_conv per span. With ``spans`` (a
    session holding lam64) every dispatch is one span unless a move is
    pending, and then its blocks go one by one; ``moved`` says whether one
    is pending when the stream starts; ``fused`` whether the session's
    rows take a full block through fused_block (fused_rows). The stream
    retunes only sigma and mu, so the span stays eligible throughout.
    Returns (launches, dispatch kinds)."""
    from openpbso_tpu_torch.config import SAMPLE_RATE
    from openpbso_tpu_torch.ops.forces import (FORCE_GAUSSIAN, FORCE_HERTZ,
                                               FORCE_POINT, slot_duration)
    code = {"point": FORCE_POINT, "gaussian": FORCE_GAUSSIAN,
            "hertz": FORCE_HERTZ}
    want = dict.fromkeys(KERNELS, 0)
    kinds = {}
    by_clock = {}
    for clock, ev in recorded:
        by_clock.setdefault(clock, []).append(ev)
    check(all(c % S == 0 for c in by_clock), "an event applied inside a block")
    clock, busy_until, dragged = 0, 0, set()

    def one_block(at):
        nonlocal moved
        drag = bool(dragged)
        if moved:
            moved, kind = False, "xfade"
        elif not drag and busy_until <= at:
            return "decay"
        else:
            kind = "full"
            want["fused_block"] += fused
        want["ar_block"] += drag
        return kind + ("+drag" if drag else "")

    for n in sizes:
        for ev in by_clock.pop(clock, ()):
            name = type(ev).__name__
            if name == "HitEvent":
                width = (1.0 if ev.kind == "point" else
                         max(1, int(ev.width_us / 1e6 * SAMPLE_RATE)))
                busy_until = max(busy_until, clock + slot_duration(
                    code[ev.kind], width, S))
            elif name == "SustainedEvent" and ev.action == "start":
                dragged.add(ev.obj)
            elif name == "SustainedEvent" and ev.action == "end":
                dragged.discard(ev.obj)
            elif name == "TransferEvent":
                moved = True
            elif name == "ArParamEvent":
                check(tuple(ev.a) == (0.783, 0.116),
                      "the stream retuned an AR table's coefficients")
        if spans and not moved:
            drag = bool(dragged)
            idle = not drag and busy_until <= clock
            for k, v in span_want(not idle, idle, drag).items():
                want[k] += v
            done = [("idle_span" if idle else "span")
                    + ("+drag" if drag else "")]
        else:
            done = [one_block(clock + i * S) for i in range(n)]
        for kind in done:
            kinds[kind] = kinds.get(kind, 0) + 1
        clock += n * S
    check(not by_clock, f"events applied at no dispatch: {sorted(by_clock)}")
    return want, kinds


def tap_dispatches(engine, events=False):
    """Record what each synthesis dispatch produced (the consumer pads the
    sink with a stale block whenever the host stalls; the tap does not) and
    how many blocks it held, with ``events`` also a CUDA-event pair around
    each dispatch."""
    import torch
    produced, pairs, sizes = [], [], []
    inner = engine._synth_once

    def tapped():
        if events:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
        blocks = inner()
        if events:
            b.record()
            pairs.append((a, b))
        produced.extend(blocks)
        sizes.append(len(blocks))
        return blocks

    engine._synth_once = tapped
    return produced, pairs, sizes


def drive(engine, n_blocks, schedule) -> object:
    """Feed a running engine the events of ``schedule`` ([(block, fn)],
    ascending) as its block count passes each threshold, until it has
    produced n_blocks; returns the last qnorm it reported."""
    pending = list(schedule)
    qnorm = None
    deadline = time.perf_counter() + 300.0
    while engine._blocks_done < n_blocks:
        check(engine.healthy, f"engine died: {engine.error!r}")
        check(time.perf_counter() < deadline,
              f"engine produced {engine._blocks_done} blocks in 300 s")
        while pending and pending[0][0] <= engine._blocks_done:
            pending.pop(0)[1]()
        q = engine.latest_qnorm()
        qnorm = q if q is not None else qnorm
        time.sleep(0.002)
    return qnorm


def stats_dict(engine) -> dict:
    import dataclasses
    st = engine.profiler.stats()
    out = dataclasses.asdict(st)
    out["first_block_ms"] = 1e3 * float(engine.profiler._times[0])
    return out


def engine_stream(label, scene, lam64, lookahead, rng, session=None,
                  shards=1, rattle=False) -> dict:
    """One unpaced engine stream of phase 7d (or 10d: ``session`` a
    ShardedSession over phase 4's scene, whose ``shards`` each launch
    their own kernels), with ``rattle`` soft hits on a few objects at
    every block (bench/stream_ab.py::rattle_schedule); returns its
    produced audio, recorded events, launch counts, the span
    contractions' shapes and variants over the stream, and statistics."""
    import torch
    from openpbso_tpu_torch.bench.stream_ab import (count_variants,
                                                    rattle_schedule)
    from openpbso_tpu_torch.runtime.audio import RawCollectorSink
    from openpbso_tpu_torch.runtime.engine import StreamingEngine
    sess = session or live_session(scene, lam64=lam64)
    log = dispatch_log(sess)
    warmed = {}
    warmup = sess.warmup

    def counted_warmup(**kw):
        # start() warms up before it spawns the threads: what is counted
        # and logged when it returns is the warmup's, the rest the stream's
        warmup(**kw)
        warmed.update(launches=read_launches(), dispatches=len(log))

    sess.warmup = counted_warmup
    sink = RawCollectorSink()
    engine = StreamingEngine(sess, sink, qnorm_every=QNORM_EVERY,
                             lookahead=lookahead, record=True)
    produced, _, sizes = tap_dispatches(engine)
    for h in scene["engine_hits"]:
        check(engine.hit(h["obj"], h["space"], kind=h["kind"],
                         width_us=h["width_us"], amp=h["amp"]),
              "the engine dropped a hit")
    dragged = list(range(2, O, O // ENGINE_DRAGGED))[:ENGINE_DRAGGED]
    spaces = rng.standard_normal((2, ENGINE_DRAGGED, M))
    first = ENGINE_COMPARED + 4
    schedule = [(first, lambda: [engine.sustained_start(o, v)
                                 for o, v in zip(dragged, spaces[0])])]
    schedule += [(b, lambda b=b: engine.set_listener(
        scene["listeners"] + 0.3 * np.sin(0.1 * b)))
        for b in range(first + 6, ENGINE_BLOCKS, 20)]
    schedule += [
        (80, lambda: engine.set_ar_params(dragged[0], sigma=0.003, mu=0.1)),
        (100, lambda: [engine.sustained_update(o, v)
                       for o, v in zip(dragged, spaces[1])]),
        (150, lambda: [engine.sustained_end(o) for o in dragged])]
    if rattle:
        schedule += rattle_schedule(engine, O, M)
    schedule.sort(key=lambda e: e[0])

    # the counted window is the engine's own run, start() to stop()
    reset_launches()
    t = time.perf_counter()
    engine.start()
    start_s = time.perf_counter() - t
    with count_variants() as variants:
        qnorm = drive(engine, ENGINE_BLOCKS, schedule)
    health = dict(health=engine.health.health, missed=engine.health.missed)
    engine.stop()
    counts = read_launches()
    run_log = list(log)
    sess.warmup = warmup
    t = time.perf_counter()
    sess.warmup(qnorm=True, sustained=True,
                span_blocks=(lookahead,) if lam64 is not None else ())
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t

    check(engine.error is None, f"{label}: engine error {engine.error!r}")
    want = {k: v * shards for k, v in expected_launches(run_log).items()}
    check(counts == want, f"{label}: launches {counts} != {want} reckoned "
          "from the dispatch log")
    # the stream's own launches against the event record: of the
    # session's routing only the rows' backend enters this reckoning
    streamed = {k: counts[k] - warmed["launches"][k] for k in KERNELS}
    # live_session set the listener of a smooth_transfer session: block 0
    # ramps from the unit transfer, one xfade beside the recorded moves
    reckoned, kinds = reckon_launches(engine.recorded, sizes,
                                      lam64 is not None, moved=True,
                                      fused=fused_rows(sess))
    reckoned = {k: v * shards for k, v in reckoned.items()}
    check(streamed == reckoned, f"{label}: the stream launched {streamed}, "
          f"its events and block counts give {reckoned} ({kinds})")
    check(sum(sizes) == len(produced) >= ENGINE_BLOCKS
          and sum(n for _, n, _, _ in run_log[warmed["dispatches"]:])
          == len(produced),
          f"{label}: {len(produced)} blocks produced, dispatches {sizes}")
    moves = sum(1 for _, ev in engine.recorded
                if type(ev).__name__ == "TransferEvent")
    xfades = kinds.get("xfade", 0) + kinds.get("xfade+drag", 0)
    check(moves >= 3 and xfades == moves + 1
          and sum(1 for kind, *_ in run_log[warmed["dispatches"]:]
                  if kind == "xfade") == moves + 1,
          f"{label}: {moves} listener moves, dispatches {kinds}")
    if lam64 is not None and lookahead == 1:
        spans = sum(v for k, v in kinds.items() if "span" in k)
        check(spans == len(produced) - moves - 1,
              f"{label}: {spans} spans for {len(produced)} blocks and "
              f"{moves} + 1 ramped")
    check(qnorm is not None and qnorm.shape == (O, sess.bank.num_modes)
          and bool(np.isfinite(qnorm).all()),
          f"{label}: latest_qnorm gave "
          f"{None if qnorm is None else qnorm.shape}")
    audio = np.concatenate(produced)
    check(bool(np.isfinite(audio).all()) and float(np.abs(audio).max()) > 0,
          f"{label}: stream not finite or silent")
    out = {"lookahead": lookahead, "lam64": lam64 is not None,
           "blocks": len(produced), "dispatches": kinds,
           "launches": counts, "launches_of_start_warmup": warmed["launches"],
           "launches_of_stream": streamed, "listener_moves": moves,
           "health_before_stop": health,
           "collected_blocks": len(sink.blocks),
           "start_s_first": start_s, "warmup_s_again": warm_s,
           "variants": variants, "stats": stats_dict(engine)}
    print(f"engine {label}:", json.dumps(out), flush=True)
    return dict(out, audio=audio[:ENGINE_COMPARED * S],
                recorded=list(engine.recorded))


def phase_engine(scene, lam64, rng) -> dict:
    """Phase 7d: the engine, unpaced, over the fused per-block path and
    over one-block and four-block spans; then the two span streams with a
    rattle on top (the session's full slot table, K = 16 and 17 with the
    drags), each held against the offline per-block replay of its
    recorded events."""
    fused = engine_stream("(i) fused per block", scene, None, 1, rng)
    span1 = engine_stream("(ii) one-block spans", scene, lam64, 1, rng)
    span4 = engine_stream("(ii) four-block spans", scene, lam64, 4, rng)
    rattle1, rattle4 = (engine_stream(f"(iii) {n}-block spans, rattle",
                                      scene, lam64, b, rng, rattle=True)
                        for n, b in (("one", 1), ("four", 4)))
    span_kernels = ("chunk_scan", "toeplitz_conv", "span_inject",
                    "span_reduce", "ar_noise")
    for name, k in ([("fused_block", fused), ("ar_block", fused)]
                    + [(n, e) for e in (span1, span4, rattle1, rattle4)
                       for n in span_kernels]):
        check(k["launches"][name] > 0, f"an engine stream never launched "
              f"{name}: {k['launches']}")
    offline = live_session(scene, hits=scene["engine_hits"]).render(
        ENGINE_COMPARED)
    out = {"db_fused_engine_vs_offline_render":
           db_error(fused["audio"], offline),
           "db_span1_engine_vs_fused_engine":
           db_error(span1["audio"], fused["audio"]),
           "db_span4_engine_vs_fused_engine":
           db_error(span4["audio"], fused["audio"])}
    check(float(np.abs(offline).max()) > 0, "offline render is silent")
    full_tables = {}
    for label, e in (("one-block", rattle1), ("four-block", rattle4)):
        # the full table reached the short variants: an injection of 16 or
        # 17 slots through stacked, a g of as many rows through split
        full = {key: n for key, n in e["variants"].items()
                if key.startswith(("span_inject K=16 ", "span_inject K=17 ",
                                   "span_reduce rows=16 ",
                                   "span_reduce rows=17 "))}
        check(any(k.startswith("span_inject") and k.endswith(": stacked")
                  for k in full)
              and any(k.startswith("span_reduce") and k.endswith(": split")
                      for k in full),
              f"7d {label} rattle: the full slot table never went through "
              f"stacked and split: {e['variants']}")
        full_tables[label] = full
        replay = replay_engine_events(live_session(scene), None,
                                      e["recorded"], ENGINE_COMPARED)
        out[f"db_{label}_rattle_vs_offline_replay"] = db_error(e["audio"],
                                                               replay)
    for key, db in out.items():
        check(db <= -90.0, f"{key} {db} dB")
    print("engine, first blocks:", json.dumps(
        dict(out, rattle_full_table=full_tables)), flush=True)
    streams = (("fused", fused), ("one-block spans", span1),
               ("four-block spans", span4),
               ("one-block spans, rattle", rattle1),
               ("four-block spans, rattle", rattle4))
    for label, e in streams:
        ENGINE_STATS[label] = {k: e["stats"][k] for k in ("p50_ms", "p99_ms")}
    return {k: sum(e["launches"][k] for _, e in streams) for k in KERNELS}


@contextlib.contextmanager
def host_stalls():
    """A watchdog thread that sleeps 1 ms at a time and records each wake
    more than 3 ms late as (end, length) on the perf_counter clock: while
    the whole process stands still (descheduled by the OS, or the
    interpreter held), it cannot wake either."""
    stalls, stop = [], threading.Event()

    def watch():
        while not stop.is_set():
            t = time.perf_counter()
            time.sleep(0.001)
            now = time.perf_counter()
            if now - t > 0.004:
                stalls.append((now, now - t))
    thread = threading.Thread(target=watch, daemon=True)
    thread.start()
    try:
        yield stalls
    finally:
        stop.set()
        thread.join()


def unexplained_late(writes, dispatches, stalls, deadline_s) -> list:
    """The late writes of a paced stream (times) that no host stall
    explains. A late write is the host's when the watchdog saw the process
    stand still for 5 ms or more, ending within the two blocks before the
    write (the queue's depth) or just after it, and no dispatch in that
    window ran past the deadline; any other late write is the code's."""
    out = []
    for t in (t for t, on_time in writes if not on_time):
        lo, hi = t - 2 * deadline_s, t + 0.005
        stalled = any(lo <= end <= hi and length >= 0.005
                      for end, length in stalls)
        slow = any(a < hi and b > lo and b - a >= deadline_s
                   for a, b in dispatches)
        if slow or not stalled:
            out.append(t)
    return out


def phase_paced(scene, rng) -> dict:
    """Phase 7e: the fused engine against a consumer paced at the audio
    rate, hits arriving live; then the device's idle share."""
    import torch
    from openpbso_tpu_torch.config import SAMPLE_RATE
    from openpbso_tpu_torch.runtime.audio import RealTimePacerSink
    from openpbso_tpu_torch.runtime.engine import StreamingEngine
    from openpbso_tpu_torch.runtime.profiling import device_trace

    def stream(seconds, events):
        sess = live_session(scene)
        sink = RealTimePacerSink()
        engine = StreamingEngine(sess, sink, qnorm_every=QNORM_EVERY)
        _, pairs, _ = tap_dispatches(engine, events=events)
        # host times of each dispatch and each write, for the stall gate
        dispatches, writes = [], []
        synth, write = engine._synth_once, sink.write

        def timed_synth():
            t = time.perf_counter()
            blocks = synth()
            dispatches.append((t, time.perf_counter()))
            return blocks

        def timed_write(block):
            t = time.perf_counter()
            on_time = write(block)
            writes.append((t, on_time))
            return on_time
        engine._synth_once, sink.write = timed_synth, timed_write
        engine.start()
        with host_stalls() as stalls:
            t0 = time.perf_counter()
            n = 0
            while time.perf_counter() - t0 < seconds:
                check(engine.healthy, f"paced engine died: {engine.error!r}")
                h = scene["hits"][n % len(scene["hits"])]
                engine.hit(h["obj"], h["space"], kind=h["kind"],
                           width_us=h["width_us"], amp=h["amp"])
                n += 1
                time.sleep(0.1)
            wall = time.perf_counter() - t0
            # read before stop(): the consumer books the block it was
            # waiting for when the stream ends as one more miss
            health = dict(health=engine.health.health,
                          missed=engine.health.missed,
                          late_blocks=sink.late_blocks,
                          paced_blocks=sink.total_blocks)
            late = unexplained_late(list(writes), list(dispatches),
                                    list(stalls), S / SAMPLE_RATE)
        engine.stop()
        torch.cuda.synchronize()
        check(engine.error is None, f"paced engine error {engine.error!r}")
        health.update(host_stalls_over_5ms=[
            [end - t0, length * 1e3] for end, length in stalls
            if length >= 0.005],
            late_without_host_stall=[t - t0 for t in late])
        return engine, health, pairs, wall, n

    engine, health, pairs, wall, n_hits = stream(PACED_SECONDS, True)
    busy_ms = sum(a.elapsed_time(b) for a, b in pairs)
    st = stats_dict(engine)
    deadline_ms = 1e3 * S / SAMPLE_RATE
    out = dict(health, seconds=wall, blocks=engine._blocks_done, hits=n_hits,
               stats=st, deadline_ms=deadline_ms,
               dispatch_event_ms_sum=busy_ms,
               idle_share_by_events=1.0 - busy_ms / (1e3 * wall))
    print("engine, paced:", json.dumps(out), flush=True)   # before its gate
    # a late block is the code's unless the process stood still beside it
    # with no dispatch past the deadline (a shared host's stall); a missed
    # block is a late one, or an underrun that no late write shows
    check(not health["late_without_host_stall"],
          f"paced: {health['late_blocks']} late blocks, at "
          f"{health['late_without_host_stall']} s with no host stall")
    check(health["missed"] <= health["late_blocks"],
          f"paced: {health['missed']} missed, {health['late_blocks']} late")
    check(st["p99_ms"] < deadline_ms,
          f"paced: p99 {st['p99_ms']} ms >= {deadline_ms} ms")
    check(engine._blocks_done >= int(0.8 * PACED_SECONDS * SAMPLE_RATE / S),
          f"paced: only {engine._blocks_done} blocks")

    # the same stream for 1 s under the profiler: the kernels' own time
    from torch.autograd import DeviceType
    with tempfile.TemporaryDirectory() as tmp:
        with device_trace(tmp) as prof:
            _, _, _, wall_p, _ = stream(1.0, False)
        check(os.path.getsize(os.path.join(tmp, "trace.json")) > 0,
              "device_trace wrote no trace")
    kernel_us = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
    profiled = {"profiled_seconds": wall_p,
                "profiled_kernel_ms_sum": kernel_us / 1e3,
                "idle_share_by_profiler": (1.0 - kernel_us / 1e6 / wall_p
                                           if kernel_us > 0 else None)}
    print("engine, paced, profiled:", json.dumps(profiled), flush=True)
    return dict(out, **profiled)


def phase_checkpoint(scene, rng) -> dict:
    """Phase 7f: a snapshot of the running session through engine.control,
    restored into a fresh session."""
    from openpbso_tpu_torch.runtime.audio import RawCollectorSink
    from openpbso_tpu_torch.runtime.checkpoint import (load_session,
                                                       save_session)
    from openpbso_tpu_torch.runtime.engine import StreamingEngine
    sess = live_session(scene)
    engine = StreamingEngine(sess, RawCollectorSink())
    for h in scene["engine_hits"]:
        engine.hit(h["obj"], h["space"], kind=h["kind"],
                   width_us=h["width_us"], amp=h["amp"])
    dragged = list(range(2, O, O // ENGINE_DRAGGED))[:ENGINE_DRAGGED]
    box = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "live.npz")

        def snapshot(s):
            save_session(path, s)
            box["clock"] = s.sample_clock
            box["drags"] = int(s._sus_active.sum())
            box["next"] = s.render(CHECKPOINT_BLOCKS)

        reset_launches()
        engine.start()
        for o in dragged:
            engine.sustained_start(o, rng.standard_normal(M))
        engine.set_ar_params(dragged[0], a=(0.6, 0.2), sigma=0.003, mu=0.1)
        drive(engine, 12, [])
        check(engine.control(snapshot), "engine.control timed out")
        engine.stop()
        counts = read_launches()
        check(engine.error is None, f"engine error {engine.error!r}")
        size = os.path.getsize(path)
        fresh = live_session(scene)
        load_session(path, fresh)
    check(box["drags"] == ENGINE_DRAGGED and box["clock"] > 0,
          f"snapshot state {box['drags']} drags at clock {box['clock']}")
    check(fresh.sample_clock == box["clock"], "restored clock")
    check(tuple(fresh._ar_host[dragged[0]]) == (0.6, 0.2),
          "restored AR mirror")
    again = fresh.render(CHECKPOINT_BLOCKS)
    check(float(np.abs(again).max()) > 0, "restored render is silent")
    check(np.array_equal(again, box["next"]),
          f"restored render differs: {db_error(again, box['next'])} dB")
    check(counts["ar_block"] > 0 and counts["fused_block"] > 0,
          f"checkpoint stream launches {counts}")
    out = {"snapshot_clock": box["clock"], "drags": box["drags"],
           "npz_bytes": size, "blocks": CHECKPOINT_BLOCKS, "bitwise": True}
    print("checkpoint:", json.dumps(out), flush=True)
    return out


def phase_live(scene, lam64, rng) -> dict:
    """Phase 7; returns the engine streams' launches per kernel."""
    import torch
    from openpbso_tpu_torch.ops.ffat import compute_transfer
    dev = scene["bank"].device
    scene = dict(scene)
    scene["rows"] = [compute_transfer(scene["ffat"], torch.as_tensor(
        p, dtype=torch.float32, device=dev))
        for p in (scene["listeners"], scene["listeners"][::-1].copy())]
    scene["engine_hits"] = [dict(h, when=None)
                            for h in scene["hits"][:ENGINE_HITS]]
    phase_xfade(scene, rng)
    phase_qnorm(scene, rng)
    phase_moving(scene)
    launches = phase_engine(scene, lam64, rng)
    phase_paced(scene, rng)
    phase_checkpoint(scene, rng)
    return launches


def write_scene_model(root, seed):
    """One synthetic model directory of M modes (a worker of phase 8's
    pool: its M FFAT maps take tens of seconds of host time)."""
    from openpbso_tpu_torch.utils.synth import synth_model_dir
    return synth_model_dir(root, "m", num_modes=M, seed=seed)


def start_scene_models(root, seed):
    """Write phase 8's model directories in worker processes while the
    earlier phases run; returns (pool, futures)."""
    import concurrent.futures
    import multiprocessing
    pool = concurrent.futures.ProcessPoolExecutor(
        SCENE_MODELS, mp_context=multiprocessing.get_context("spawn"))
    futures = [pool.submit(write_scene_model, os.path.join(root, f"m{i}"),
                           seed + 11 + i) for i in range(SCENE_MODELS)]
    return pool, futures


def scene_instances(dirs, compress=True):
    """Phase 8's instances: the models loaded from their directories, O
    instances cycling through them on a square grid, and each model's
    compressed maps (compress_map, uint8 quantisation; None without
    ``compress``)."""
    from openpbso_tpu_torch.io.meta import resolve_model_dir
    from openpbso_tpu_torch.models import SceneInstance, load_model
    from openpbso_tpu_torch.ops.ffat_fit import compress_map
    t = time.perf_counter()
    models = [load_model(resolve_model_dir(d, "m")) for d in dirs]
    for mdl in models:
        check(mdl.num_modes_audible == M and len(mdl.ffat_maps) == M,
              f"a scene model has {mdl.num_modes_audible} audible modes and "
              f"{len(mdl.ffat_maps)} maps, not {M}")
    side = math.isqrt(O)
    ij = np.stack(np.meshgrid(np.arange(side), np.arange(side),
                              indexing="ij"), -1).reshape(-1, 2)
    xy = (ij - (side - 1) / 2.0) * SCENE_SPACING
    instances = [SceneInstance(models[i % len(models)],
                               np.array([xy[i, 0], xy[i, 1], 0.0]),
                               gain=1.0 + 0.1 * (i % 3)) for i in range(O)]
    compressed = None if not compress else {
        id(mdl): {k: compress_map(v, jpeg_quality=None)
                  for k, v in mdl.ffat_maps.items()} for mdl in models}
    print(f"scene models: {len(models)} loaded"
          + (" and compressed" if compress else "")
          + f" in {time.perf_counter() - t} s", flush=True)
    return instances, compressed


def build_scene(instances, compressed=None, **kw):
    """A Scene on the card (built without ``device=``); with
    ``compressed`` its session's maps also carry the compressed texture."""
    import torch
    from openpbso_tpu_torch.models import Scene
    from openpbso_tpu_torch.ops.ffat import build_ffat_hetero
    t = time.perf_counter()
    scene = Scene(instances, block_size=S, **kw)
    if compressed is not None:
        scene.session.ffat = build_ffat_hetero(
            [inst.model.ffat_maps for inst in scene.instances],
            scene.bank.num_modes, compressed_maps=[
                compressed[id(inst.model)] for inst in scene.instances])
    torch.cuda.synchronize()
    check(scene.bank.device.type == "cuda" and not scene.bank.shared_tables,
          f"scene bank on {scene.bank.device}, shared tables "
          f"{scene.bank.shared_tables}")
    print(f"scene {kw}: {scene.num_objects} rows x {scene.bank.num_modes} "
          f"modes in {time.perf_counter() - t} s", flush=True)
    keep_as_built(scene)
    return scene


AS_BUILT = weakref.WeakKeyDictionary()   # Scene -> (its attributes, its
                                         # session's), as built


def copied(attrs: dict) -> dict:
    """Attributes with their arrays copied and the solver state cloned
    (slots and the sustained channel are written in place); tensors that
    are only ever replaced, the bank, the maps and the span-table cache
    stay shared."""
    from openpbso_tpu_torch.runtime.state import SolverState, clone_state
    return {k: (v.copy() if isinstance(v, np.ndarray)
                else clone_state(v) if isinstance(v, SolverState) else v)
            for k, v in attrs.items()}


def keep_as_built(scene):
    AS_BUILT[scene] = (copied(vars(scene)), copied(vars(scene.session)))


def as_built(scene):
    """Put the Scene and its own session back as they were built (or as
    keep_as_built last recorded them): the session's state, host mirrors
    and gains, and the Scene's listener records. A method a phase wrapped
    on the session (warmup, the dispatches) is unwrapped. Returns the
    session."""
    own, session = AS_BUILT[scene]
    vars(scene).clear()
    vars(scene).update(copied(own))
    vars(scene.session).clear()
    vars(scene.session).update(copied(session))
    return scene.session


def without_span_tables(scene):
    """Give a single-listener Scene a session without the float64
    eigenvalues that a Scene always passes on, so that the engine at
    lookahead 1 steps per block through fused_block instead of taking
    one-block spans; everything else as the Scene configured it."""
    from openpbso_tpu_torch.runtime.session import ModalSession
    old = scene.session
    check(old.num_listeners == 1 and not old.auto_itd,
          "without_span_tables takes a single-listener Scene")
    scene.session = ModalSession(scene.bank, ffat=old.ffat,
                                 config=old.config)
    scene.session.gains = old.gains
    scene.session.listener_frame = old.listener_frame
    keep_as_built(scene)


def scene_hits(rng, instances, future=True):
    """Point, gaussian and hertz hits on every third logical instance at
    a random vertex; with ``future`` three in four are future-dated
    (block-aligned, no later than SCENE_LAST_HIT)."""
    kinds = ("point", "gaussian", "hertz")
    hits = []
    for i, obj in enumerate(range(0, len(instances), 3)):
        when = (None if i % 4 == 0 or not future
                else int(rng.integers(1, SCENE_LAST_HIT + 1)) * S)
        hits.append(dict(
            index=obj, kind=kinds[i % 3],
            vertex=int(rng.integers(0, instances[obj].model.num_vertices)),
            width_us=float(rng.uniform(200.0, 2000.0)),
            amp=float(rng.uniform(0.5, 1.5)), when=when))
    return hits


def apply_hits(scene, hits):
    for h in hits:
        scene.hit(h["index"], h["vertex"], kind=h["kind"],
                  width_us=h["width_us"], amp=h["amp"], when=h["when"])


def scene_setup(scene, hits, world=None):
    """The Scene as built (as_built), the world listener and the hits: the
    start of every phase-8 render."""
    sess = as_built(scene)
    scene.set_listener(SCENE_LISTENER if world is None else world)
    apply_hits(scene, hits)
    return sess


def synced_blocks(sess, n_blocks):
    """Step n_blocks one by one, each copied to the host; returns (mix,
    host ms of each full block)."""
    import torch
    out, full_ms = [], []
    for _ in range(n_blocks):
        full = sess._xfade_from is None and not sess._idle()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out.append(sess.step()[1].cpu().numpy())
        if full:
            full_ms.append(1e3 * (time.perf_counter() - t))
    return np.concatenate(out), full_ms


def ffat_to_cpu(ffat):
    import dataclasses
    return dataclasses.replace(
        ffat, cell_size=ffat.cell_size.cpu(), geom=dataclasses.replace(
            ffat.geom, **{f.name: getattr(ffat.geom, f.name).cpu()
                          for f in dataclasses.fields(ffat.geom)
                          if getattr(ffat.geom, f.name) is not None}))


def phase_compressed(scene, plain) -> dict:
    """Phase 8a: compute_transfer from both textures against the same
    calls on CPU tensors, the session's toggle, and set_listener's latency
    with ITD (``scene``) and without (``plain``)."""
    import torch
    from openpbso_tpu_torch.ops.ffat import compute_transfer
    sess = as_built(scene)
    ffat = sess.ffat
    rel = scene._relative_rows(SCENE_LISTENER)                # [2, O, 3]
    p = torch.as_tensor(rel[0], dtype=torch.float32, device=ffat.geom.psi.device)
    ffat_cpu = ffat_to_cpu(ffat)
    rows = {}
    out = {}
    for compressed in (False, True):
        label = "compressed" if compressed else "raw"
        got = compute_transfer(ffat, p, compressed=compressed)
        ref = compute_transfer(ffat_cpu, p.cpu(), compressed=compressed)
        check(bool(torch.isfinite(got).all()) and float(got.max()) > 0,
              f"{label} transfer not finite or zero")
        out[f"{label}_db_vs_cpu"] = db_error(got.cpu().numpy(), ref.numpy())
        check(out[f"{label}_db_vs_cpu"] <= -100.0,
              f"{label} transfer {out[f'{label}_db_vs_cpu']} dB vs the CPU")
        rows[label] = got
    del ffat_cpu
    check(not torch.equal(rows["raw"], rows["compressed"]),
          "the compressed texture gives the raw rows")
    out["db_compressed_vs_raw"] = db_error(rows["compressed"].cpu().numpy(),
                                           rows["raw"].cpu().numpy())
    out["compressed_transfer_ms"] = time_ms(
        lambda: compute_transfer(ffat, p, compressed=True))
    out["raw_transfer_ms"] = time_ms(lambda: compute_transfer(ffat, p))

    # the session's toggle: at once, from the resident textures
    scene.set_listener(SCENE_LISTENER)
    raw = (sess.state.transfer.clone(), sess.state.transfer_im.clone())
    check(tuple(raw[0].shape) == (2, O, M) and raw[1] is not None,
          f"binaural ITD rows {tuple(raw[0].shape)}")
    psi = (ffat.geom.psi.data_ptr(), ffat.geom.psi_c.data_ptr())
    sess.set_use_compressed(True)
    comp = (sess.state.transfer.clone(), sess.state.transfer_im.clone())
    check(not torch.equal(comp[0], raw[0]), "the toggle left the rows")
    scene.set_listener(SCENE_LISTENER)
    check(torch.equal(sess.state.transfer, comp[0])
          and torch.equal(sess.state.transfer_im, comp[1]),
          "toggled rows differ from a compressed set_listener")
    sess.set_use_compressed(False)
    check(torch.equal(sess.state.transfer, raw[0])
          and torch.equal(sess.state.transfer_im, raw[1]),
          "toggling back did not restore the raw rows")
    check(sess.ffat is ffat and psi == (ffat.geom.psi.data_ptr(),
                                        ffat.geom.psi_c.data_ptr()),
          "the toggle rebuilt the maps")
    # set_listener's latency with ITD, without it, and its two lookups
    def host_ms(fn, runs=10):
        ms = []
        for i in range(runs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn(i)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t))
        return statistics.median(ms)
    out["set_listener_itd_ms_median"] = host_ms(
        lambda i: scene.set_listener(SCENE_LISTENER + 0.01 * i))
    rows = torch.as_tensor(rel, dtype=torch.float32, device=p.device)
    # the session looks both ears up in one call: each ear's row is the
    # single-listener call's, bitwise
    for compressed in (True, False):
        sess.set_use_compressed(compressed)
        both = sess._lookup(rows)
        check(all(torch.equal(both[ear], compute_transfer(
            ffat, rows[ear], compressed=compressed)) for ear in range(2)),
            f"one lookup of both ears (compressed {compressed}) differs "
            "from one call per ear")
    out["both_ears_one_lookup_bitwise"] = True
    out["set_listener_lookups_ms_median"] = host_ms(
        lambda i: sess._lookup(rows))
    as_built(plain)
    out["set_listener_no_itd_ms_median"] = host_ms(
        lambda i: plain.set_listener(SCENE_LISTENER + 0.01 * i))
    print("compressed texture:", json.dumps(out), flush=True)
    return out


def phase_replicated(scene, instances, hits) -> tuple:
    """Phase 8b: a binaural Scene's shared-state rows (blocked form, no
    kernel; no ITD, which the replicated layout lacks) against the
    replicated layout (2*O single-listener rows, fused_block), per block
    over the same hits."""
    import torch
    expiry = script_expiry(hits)
    scene_setup(scene, hits)
    reset_launches()
    shared_mix = scene.render(SPATIAL_BLOCKS)
    shared_counts = read_launches()
    rep = build_scene(instances, binaural=True, shared_state=False,
                      smooth_transfer=True)
    check(rep.num_objects == 2 * O and rep.session.num_listeners == 1
          and tuple(rep.session.gains.shape) == (2 * O, 2),
          "the replicated layout")
    scene_setup(rep, hits)
    reset_launches()
    rep_mix = rep.render(SPATIAL_BLOCKS)
    rep_counts = read_launches()
    del rep
    torch.cuda.empty_cache()
    # block 0 ramps from the unit transfer (blocked form); then every
    # busy block is one fused step, and none of the shared rows' blocks
    want = dict.fromkeys(KERNELS, 0)
    check(shared_counts == want, f"shared rows launched {shared_counts}")
    want["fused_block"] = sum(1 for b in range(1, SPATIAL_BLOCKS)
                              if b * S < expiry)
    check(rep_counts == want and want["fused_block"] > 0,
          f"replicated rows launched {rep_counts}, want {want}")
    out = {"blocks": SPATIAL_BLOCKS, "launches": rep_counts}
    for ch in range(2):
        out[f"db_channel_{ch}"] = db_error(shared_mix[:, ch],
                                           rep_mix[:, ch])
        check(out[f"db_channel_{ch}"] <= -90.0,
              f"shared vs replicated channel {ch}: "
              f"{out[f'db_channel_{ch}']} dB")
    check(float(np.abs(shared_mix).max()) > 0, "binaural render is silent")
    print("shared vs replicated:", json.dumps(out), flush=True)
    return out, rep_counts


def phase_binaural_span(scene, hits) -> tuple:
    """Phase 8c: the binaural ITD Scene per block and by render_multi; the
    span kernels on the render's own L = 2 complex-row inputs."""
    import torch
    from openpbso_tpu_torch.config import SAMPLE_RATE
    from openpbso_tpu_torch.ops import chunk_scan as k1
    expiry = script_expiry(hits)
    sess = scene_setup(scene, hits)
    check(sess.state.transfer_im is not None
          and tuple(sess.state.transfer.shape) == (2, O, M),
          "the binaural ITD rows")
    reset_launches()
    per_block, full_ms = synced_blocks(sess, SPATIAL_BLOCKS)
    check(read_launches() == dict.fromkeys(KERNELS, 0),
          f"complex listener rows launched {read_launches()} per block")
    sess = scene_setup(scene, hits)
    t = time.perf_counter()
    sess.span_tables_for(SPAN_DISPATCH)
    table_s = time.perf_counter() - t
    with capture_span_kernel_inputs() as captured:
        reset_launches()
        span_mix = scene.render_multi(SPATIAL_BLOCKS,
                                      blocks_per_dispatch=SPAN_DISPATCH)
        counts = read_launches()
    # block 0 is the pending ramp, flushed as one blocked step; then spans
    starts = list(range(1, SPATIAL_BLOCKS, SPAN_DISPATCH))
    busy = sum(1 for b in starts if b * S < expiry)
    check(0 < busy < len(starts), f"{busy} of {len(starts)} spans busy")
    want = span_want(busy, len(starts) - busy)
    check(counts == want, f"binaural span launches {counts} != {want}")
    for label, mix in (("per-block", per_block), ("span", span_mix)):
        check(mix.shape == (SPATIAL_BLOCKS * S, 2)
              and bool(np.isfinite(mix).all())
              and float(np.abs(mix).max()) > 0,
              f"binaural {label} render not finite or silent")
    db = db_error(span_mix, per_block)
    check(db <= -90.0, f"binaural span {db} dB vs per block")
    g = captured[("toeplitz_conv", "busy")][0]
    check(g.shape[1] == 2, f"the span's conv saw {g.shape[1]} listener rows")
    kernels = check_dispatch_inputs(captured)
    keep_contraction_inputs("phase 8c, L = 2 complex rows", captured)
    for kind in ("busy", "decay"):
        args = captured[("chunk_scan", kind)]
        got, plain = k1.chunk_scan(*args), k1.chunk_scan_reference(*args)
        check(all(torch.equal(a, b) for a, b in zip(got, plain)),
              f"chunk_scan ({kind} dispatch) not bitwise its twin")
        kernels[f"chunk_scan_{kind}"]["bitwise"] = True

    # synced span dispatches
    sess = scene_setup(scene, hits)
    sess.step()
    span_ms = []
    for b in starts:
        torch.cuda.synchronize()
        t = time.perf_counter()
        sess._step_span(min(SPAN_DISPATCH, SPATIAL_BLOCKS - b)).cpu()
        span_ms.append(1e3 * (time.perf_counter() - t))
    out = {"blocks": SPATIAL_BLOCKS, "db_span_vs_per_block": db,
           "launches": counts, "kernels_on_dispatch_inputs": kernels,
           "table_build_s": table_s,
           "per_block_full_ms_median": statistics.median(full_ms),
           "span_ms": span_ms, "busy_span_ms": span_ms[0],
           "span_rtf": (SPATIAL_BLOCKS - 1) * S / SAMPLE_RATE
           / (1e-3 * sum(span_ms))}
    print("binaural per block vs span:", json.dumps(out), flush=True)
    return out, counts


def phase_spatial_moving(scene, held, hits) -> dict:
    """Phase 8d: Scene.render_moving along a world path, held (``held``: a
    binaural Scene without smooth_transfer) and ramped (``scene``: with
    it), against the per-move loop; render_doppler on the same path."""
    from openpbso_tpu_torch.config import SAMPLE_RATE, SOUND_SPEED
    ang = 0.15 * np.arange(MOVING_BLOCKS)
    path = SCENE_LISTENER + 1.5 * np.stack(
        [np.cos(ang) - 1.0, np.sin(ang), 0.2 * np.sin(2 * ang)], axis=1)
    out = {"blocks": MOVING_BLOCKS}
    # render_moving is a magnitude-FFAT path, as in the JAX package: the
    # per-move loop it is held against runs on Scenes without ITD too
    for label, sc in (("held", held), ("ramped", scene)):
        smooth = sc.session.config.smooth_transfer
        check(smooth == (label == "ramped") and not sc.session.auto_itd,
              f"the {label} Scene's session")
        scene_setup(sc, hits, world=path[0])
        reset_launches()
        t = time.perf_counter()
        got = sc.render_moving(path, smooth=smooth)
        seconds = time.perf_counter() - t
        counts = read_launches()
        check(counts == dict.fromkeys(KERNELS, 0),
              f"render_moving ({label}) launched {counts}")
        scene_setup(sc, hits, world=path[0])
        ref = []
        for p in path:
            sc.set_listener(p)
            ref.append(sc.step()[1].cpu().numpy())
        ref = np.concatenate(ref)
        check(got.shape == (MOVING_BLOCKS * S, 2)
              and bool(np.isfinite(got).all())
              and float(np.abs(got).max()) > 0,
              f"render_moving ({label}) not finite or silent")
        db = db_error(got, ref)
        check(db <= -90.0, f"render_moving ({label}) {db} dB vs per move")
        out[label] = {"db_vs_per_move": db,
                      "ms_per_block": 1e3 * seconds / MOVING_BLOCKS}
    ramped = got
    scene_setup(scene, hits, world=path[0])
    t = time.perf_counter()
    dop = scene.render_doppler(path)
    seconds = time.perf_counter() - t
    check(dop.shape == ramped.shape and bool(np.isfinite(dop).all())
          and float(np.abs(dop).max()) > 0,
          "render_doppler not finite or silent")
    # nothing arrives before the nearest ear's wavefront (the last sample
    # before it interpolates toward the first emitted one)
    # (per-sample distances interpolate between block starts)
    r_min = min(np.linalg.norm(scene._relative_rows(p), axis=-1).min()
                for p in path[:2])
    first = int(np.floor(r_min * SAMPLE_RATE / SOUND_SPEED))
    check(first > 1 and not np.any(dop[:first - 1]),
          f"render_doppler sounds before the first wavefront ({first})")
    # with a propagation delay of ~0 samples it is render_moving's render
    scene_setup(scene, hits, world=path[0])
    instant = scene.render_doppler(path, c=1e12)
    db = db_error(instant, ramped)
    check(db <= -90.0, f"render_doppler at c = 1e12: {db} dB vs moving")
    out["doppler"] = {"first_arrival_sample": first,
                      "db_instant_vs_render_moving": db,
                      "db_vs_render_moving": db_error(dop, ramped),
                      "ms_per_block": 1e3 * seconds / MOVING_BLOCKS}
    print("spatial moving listener:", json.dumps(out), flush=True)
    return out


def spatial_stream(label, scene, sess, post_mix, lookahead, hits, seed, *,
                   paced=False) -> dict:
    """One engine stream of phase 8e over a Scene's session through a
    post-mix: ``hits`` before start(), a world listener move every 20
    blocks and 4 drags arriving live, qnorm every 8 blocks; unpaced into a
    collector (~ENGINE_BLOCKS blocks, the launches from start() to stop()
    against the session's dispatch log and the recorded events), or
    paced for PACED_SECONDS (reported, not gated)."""
    import torch
    from openpbso_tpu_torch.runtime.audio import (RawCollectorSink,
                                                  RealTimePacerSink)
    from openpbso_tpu_torch.runtime.engine import StreamingEngine
    log = dispatch_log(sess)
    warmed = {}
    warmup = sess.warmup

    def counted_warmup(**kw):
        warmup(**kw)
        warmed.update(launches=read_launches(), dispatches=len(log))

    sess.warmup = counted_warmup
    sink = RealTimePacerSink() if paced else RawCollectorSink()
    engine = StreamingEngine(sess, sink, qnorm_every=QNORM_EVERY,
                             lookahead=lookahead, record=True,
                             post_mix=post_mix)
    produced, pairs, sizes = tap_dispatches(engine, events=paced)
    for h in hits:
        space = scene.instances[h["index"]].model.modal_force_vertex(
            h["vertex"])
        check(engine.hit(h["index"], space, kind=h["kind"],
                         width_us=h["width_us"], amp=h["amp"]),
              "the engine dropped a hit")
    dragged = list(range(2, O, O // ENGINE_DRAGGED))[:ENGINE_DRAGGED]
    spaces = np.random.default_rng(seed).standard_normal(
        (2, ENGINE_DRAGGED, M))
    first = ENGINE_COMPARED + 4
    schedule = [(first, lambda: [engine.sustained_start(o, v)
                                 for o, v in zip(dragged, spaces[0])])]
    schedule += [(b, lambda b=b: engine.set_listener(
        SCENE_LISTENER + 0.5 * np.array([np.sin(0.1 * b), 0.0, 0.0])))
        for b in range(first + 6, ENGINE_BLOCKS, 20)]
    schedule += [
        (80, lambda: engine.set_ar_params(dragged[0], sigma=0.003, mu=0.1)),
        (150, lambda: [engine.sustained_end(o) for o in dragged])]
    schedule.sort(key=lambda e: e[0])

    reset_launches()
    t = time.perf_counter()
    engine.start()
    start_s = time.perf_counter() - t
    if paced:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < PACED_SECONDS:
            check(engine.healthy, f"{label}: engine died: {engine.error!r}")
            while schedule and schedule[0][0] <= engine._blocks_done:
                schedule.pop(0)[1]()
            time.sleep(0.002)
        wall = time.perf_counter() - t0
        health = dict(missed=engine.health.missed,
                      late_blocks=sink.late_blocks,
                      paced_blocks=sink.total_blocks, seconds=wall)
    else:
        drive(engine, ENGINE_BLOCKS, schedule)
        health = dict(missed=engine.health.missed)
    engine.stop()
    counts = read_launches()
    run_log = list(log)
    sess.warmup = warmup
    torch.cuda.synchronize()
    check(engine.error is None, f"{label}: engine error {engine.error!r}")
    out = {"lookahead": lookahead, "blocks": len(produced),
           "launches": counts, "health_before_stop": health,
           "start_s_first": start_s, "stats": stats_dict(engine)}
    if paced:
        busy_ms = sum(a.elapsed_time(b) for a, b in pairs)
        out.update(dispatch_event_ms_sum=busy_ms,
                   idle_share_by_events=1.0 - busy_ms / (1e3 * wall))
    else:
        want = expected_launches(run_log)
        check(counts == want, f"{label}: launches {counts} != {want} "
              "reckoned from the dispatch log")
        streamed = {k: counts[k] - warmed["launches"][k] for k in KERNELS}
        reckoned, kinds = reckon_launches(
            engine.recorded, sizes, sess.span_tables_for(1) is not None,
            moved=True, fused=fused_rows(sess))
        check(streamed == reckoned, f"{label}: the stream launched "
              f"{streamed}, its events and block counts give {reckoned} "
              f"({kinds})")
        moves = sum(1 for _, ev in engine.recorded
                    if type(ev).__name__ == "TransferEvent")
        check(moves >= 3, f"{label}: {moves} listener moves")
        audio = np.concatenate(produced)
        check(bool(np.isfinite(audio).all())
              and float(np.abs(audio).max()) > 0,
              f"{label}: stream not finite or silent")
        out.update(dispatches=kinds, launches_of_stream=streamed,
                   listener_moves=moves)
        out["audio"] = audio[:ENGINE_COMPARED * S]
    print(f"spatial engine {label}:", json.dumps(
        {k: v for k, v in out.items() if k != "audio"}), flush=True)
    return out


def offline_post_mix(scene, post_mix, hits, n_blocks) -> np.ndarray:
    """A stream's first blocks offline: the same listener and hits on a
    fresh session, stepped per block through a fresh post-mix."""
    post_mix.on_listener(SCENE_LISTENER)
    post_mix.reset()
    sess = scene.session
    for h in hits:
        sess.hit(h["index"], scene.instances[h["index"]].model
                 .modal_force_vertex(h["vertex"]), kind=h["kind"],
                 width_us=h["width_us"], amp=h["amp"])
    out = []
    for _ in range(n_blocks):
        sound, mix, _ = sess.step()
        out.append(post_mix(sound, mix).cpu().numpy())
    return np.concatenate(out)


def phase_spatial_engine(scene, mono, seed) -> tuple:
    """Phase 8e: (i) the binaural ITD Scene through DopplerPostMix at
    lookahead 1 and 4, (ii) a single-listener Scene through HRTFPostMix on
    the fused path, then (i) paced."""
    import torch
    from openpbso_tpu_torch.ops.doppler import DopplerPostMix
    from openpbso_tpu_torch.ops.hrtf import HRTFPostMix
    hits = scene_hits(np.random.default_rng(seed), scene.instances,
                      future=False)[:ENGINE_HITS]

    def doppler(sess):
        pm = DopplerPostMix(scene.positions, num_listeners=2,
                            gains=sess.gains)
        pm.on_listener(SCENE_LISTENER)
        return pm

    def hrtf():
        pm = HRTFPostMix(mono.positions, block_size=S)
        pm.on_listener(SCENE_LISTENER)
        return pm

    out, launches = {}, dict.fromkeys(KERNELS, 0)
    for lookahead in (1, 4):
        sess = scene_setup(scene, [])
        k = spatial_stream(f"(i) Doppler, lookahead {lookahead}", scene,
                           sess, doppler(sess), lookahead, hits, seed + 1)
        sess = scene_setup(scene, [])
        ref = offline_post_mix(scene, doppler(sess), hits, ENGINE_COMPARED)
        k["db_first_blocks_vs_offline"] = db_error(k.pop("audio"), ref)
        check(k["db_first_blocks_vs_offline"] <= -90.0,
              f"Doppler stream {k['db_first_blocks_vs_offline']} dB")
        out[f"doppler_lookahead_{lookahead}"] = k
        for name in KERNELS:
            launches[name] += k["launches"][name]
    for name in ("chunk_scan", "toeplitz_conv", "span_inject", "span_reduce",
                 "ar_noise"):
        check(out["doppler_lookahead_1"]["launches"][name] > 0,
              f"the Doppler stream never launched {name}")

    sess = scene_setup(mono, [])
    k = spatial_stream("(ii) HRTF, fused per block", mono, sess, hrtf(), 1,
                       hits, seed + 1)
    scene_setup(mono, [])
    ref = offline_post_mix(mono, hrtf(), hits, ENGINE_COMPARED)
    k["db_first_blocks_vs_offline"] = db_error(k.pop("audio"), ref)
    check(k["db_first_blocks_vs_offline"] <= -90.0,
          f"HRTF stream {k['db_first_blocks_vs_offline']} dB")
    check(k["launches"]["fused_block"] > 0,
          "the HRTF stream never launched fused_block")
    for name in KERNELS:
        launches[name] += k["launches"][name]
    # process_span against per-block processing on the same sound
    sess = scene_setup(mono, scene_hits(np.random.default_rng(seed + 2),
                                        mono.instances))
    sound = [sess.step()[0] for _ in range(SPAN_DISPATCH)]
    blocks, span = hrtf(), hrtf()
    per_block = np.concatenate([blocks(s, None).cpu().numpy()
                                for s in sound])
    spanned = span.process_span(torch.cat(sound, dim=-1)).cpu().numpy()
    k["db_process_span_vs_per_block"] = db_error(spanned, per_block)
    check(k["db_process_span_vs_per_block"] <= -90.0,
          f"HRTF process_span {k['db_process_span_vs_per_block']} dB")
    out["hrtf"] = k

    print("spatial engine, against the offline renders:", json.dumps({
        name: {key: k[key] for key in ("db_first_blocks_vs_offline",
                                       "db_process_span_vs_per_block")
               if key in k} for name, k in out.items()}), flush=True)
    sess = scene_setup(scene, [])
    out["doppler_paced"] = spatial_stream(
        "(i) Doppler, paced", scene, sess, doppler(sess), 1, hits,
        seed + 1, paced=True)
    return out, launches


def phase_per_client(instances, seed) -> tuple:
    """Phase 8f: per-client serving, a listener_offsets Scene of
    PER_CLIENT listeners (its own mixdown), then the same Scene with
    [L, 3] world rows through DopplerPostMix(num_listeners=L); each per
    block and by span."""
    import torch
    from openpbso_tpu_torch.ops.doppler import DopplerPostMix
    nl = PER_CLIENT
    ang = 2 * np.pi * np.arange(nl) / nl
    offsets = 0.6 * np.stack([np.cos(ang), np.sin(ang), np.zeros(nl)], 1)
    scene = build_scene(instances, listener_offsets=offsets)
    hits = scene_hits(np.random.default_rng(seed), instances, future=False)
    n = PER_CLIENT_BLOCKS
    reset_launches()
    out = {}
    scene_setup(scene, hits)
    per_block = scene.render(n)
    scene_setup(scene, hits)
    span = scene.render_multi(n, blocks_per_dispatch=n)
    check(per_block.shape == (n * S, nl) and float(np.abs(per_block).max())
          > 0, f"per-client render {per_block.shape}")
    out["offsets_db_span_vs_per_block"] = db_error(span, per_block)

    world = SCENE_LISTENER + offsets * 5.0                     # [L, 3]

    def clients():
        sess = as_built(scene)
        sess.set_listener(world)
        apply_hits(scene, hits)
        pm = DopplerPostMix(scene.positions, num_listeners=nl,
                            gains=sess.gains)
        pm.on_listener(world)
        pm.reset()
        return sess, pm
    sess, pm = clients()
    check(tuple(sess.state.transfer.shape) == (nl, O, M),
          f"per-client rows {tuple(sess.state.transfer.shape)}")
    blocks = []
    for _ in range(n):
        sound, mix, _ = sess.step()
        blocks.append(pm(sound, mix).cpu().numpy())
    blocks = np.concatenate(blocks)
    sess, pm = clients()
    spanned = pm.process_span(sess._step_span_sound(n)).cpu().numpy()
    check(blocks.shape == (n * S, nl) and float(np.abs(blocks).max()) > 0,
          f"per-client Doppler mix {blocks.shape}")
    out["world_rows_doppler_db_span_vs_per_block"] = db_error(spanned,
                                                              blocks)
    counts = read_launches()
    check(all(counts[k] == n for k, n in span_want(2, 0).items()
              if k not in ("fused_block", "ar_block")),
          f"per-client spans launched {counts}")
    for key in ("offsets_db_span_vs_per_block",
                "world_rows_doppler_db_span_vs_per_block"):
        check(out[key] <= -90.0, f"per-client {key} {out[key]} dB")
    out["launches"] = counts
    del scene
    torch.cuda.empty_cache()
    print("per-client serving:", json.dumps(out), flush=True)
    return out, counts


def phase_spatial(dirs, seed) -> dict:
    """Phase 8; returns its launches per kernel."""
    import torch
    instances, compressed = scene_instances(dirs)
    scene = build_scene(instances, compressed, binaural=True, itd=True,
                        smooth_transfer=True)
    plain = build_scene(instances, binaural=True, smooth_transfer=True)
    hits = scene_hits(np.random.default_rng(seed), instances)
    launches = dict.fromkeys(KERNELS, 0)
    timings = {"compressed": phase_compressed(scene, plain)}
    _, counts = phase_replicated(plain, instances, hits)
    for name in KERNELS:
        launches[name] += counts[name]
    timings["span"], counts = phase_binaural_span(scene, hits)
    for name in KERNELS:
        launches[name] += counts[name]
    held = build_scene(instances, binaural=True)
    phase_spatial_moving(plain, held, hits)
    del plain, held
    torch.cuda.empty_cache()
    mono = build_scene(instances, smooth_transfer=True)
    # the one session a Scene did not configure: see without_span_tables
    without_span_tables(mono)
    engines, counts = phase_spatial_engine(scene, mono, seed + 1)
    for name in KERNELS:
        launches[name] += counts[name]
    del mono
    torch.cuda.empty_cache()
    _, counts = phase_per_client(instances, seed + 4)
    for name in KERNELS:
        launches[name] += counts[name]
    check(all(launches[k] > 0 for k in ("fused_block", "chunk_scan",
                                        "toeplitz_conv", "span_inject",
                                        "span_reduce")),
          f"phase 8 launched {launches}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    paced = engines["doppler_paced"]
    print("spatial timings:", json.dumps({
        "card": smi,
        "binaural_per_block_full_ms_median":
            timings["span"]["per_block_full_ms_median"],
        "binaural_busy_span_ms": timings["span"]["busy_span_ms"],
        "binaural_span_rtf": timings["span"]["span_rtf"],
        **{k: timings["compressed"][k] for k in (
            "set_listener_itd_ms_median", "set_listener_lookups_ms_median",
            "set_listener_no_itd_ms_median")},
        "compressed_transfer_ms":
            timings["compressed"]["compressed_transfer_ms"],
        "doppler_paced": {"missed": paced["health_before_stop"]["missed"],
                          "late_blocks":
                              paced["health_before_stop"]["late_blocks"],
                          "p99_ms": paced["stats"]["p99_ms"],
                          "idle_share_by_events":
                              paced["idle_share_by_events"]},
        "launches": launches}), flush=True)
    return launches


def write_served_scene(root, dirs, name, **extra):
    """A scene JSON as apps/serve.py reads it: one .meta per phase-8 model
    directory and O instances on phase 8's grid cycling through them.
    Returns (its path, the metas)."""
    from openpbso_tpu_torch.io.meta import resolve_model_dir, write_meta
    metas = []
    for i, d in enumerate(dirs):
        meta = os.path.join(root, f"m{i}.meta")
        write_meta(meta, resolve_model_dir(d, "m"))
        metas.append(meta)
    side = math.isqrt(O)
    ij = np.stack(np.meshgrid(np.arange(side), np.arange(side),
                              indexing="ij"), -1).reshape(-1, 2)
    xy = (ij - (side - 1) / 2.0) * SCENE_SPACING
    desc = dict(instances=[
        {"meta": metas[i % len(metas)],
         "position": [float(xy[i, 0]), float(xy[i, 1]), 0.0],
         "gain": 1.0 + 0.1 * (i % 3)} for i in range(O)], **extra)
    path = os.path.join(root, name)
    with open(path, "w") as f:
        json.dump(desc, f)
    return path, metas


@contextlib.contextmanager
def served_engines():
    """Make every StreamingEngine a server builds in this block a recording
    one: it keeps the events it applies (record=True), the blocks of each
    dispatch with its session, host start and end and a CUDA-event pair
    (``dispatches``), the session as its stream starts (start() restores
    it after warmup), its post-mix's start and the launches of each
    start() (``start_launches``: its warmup and probe, read at the
    stream's first dispatch; start() runs while no stream does). Yields
    the engines made."""
    import torch
    from openpbso_tpu_torch.runtime import engine as engine_mod
    base = engine_mod.StreamingEngine
    made = []

    class Served(base):
        def __init__(self, session, sink, **kw):
            kw["record"] = True
            super().__init__(session, sink, **kw)
            self.dispatches = []
            self.first_session = session
            self.start_vars = copied(vars(session))
            pm = kw.get("post_mix")
            self.pm_start = (None if pm is None else
                             (np.array(pm.positions), pm.gains.clone(),
                              pm._nl))
            self.start_launches, self._start_mark = [], None
            made.append(self)

        def start(self):
            self._start_mark = read_launches()
            super().start()

        def _synth_once(self):
            if self._start_mark is not None:
                self.start_launches.append(launch_delta(self._start_mark))
                self._start_mark = None
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            sess = self.session
            t = time.perf_counter()
            a.record()
            blocks = super()._synth_once()
            b.record()
            self.dispatches.append((sess, blocks, t, time.perf_counter(),
                                    a, b))
            return blocks

    engine_mod.StreamingEngine = Served
    try:
        yield made
    finally:
        engine_mod.StreamingEngine = base


class WSClient:
    """A browser's side of the port's WebSocket bridge: the handshake, then
    the bridge's own frame codec (wsbridge.encode_frame with the client's
    mask spliced in, wsbridge._FrameReader for the server's frames)."""

    def __init__(self, host, port):
        import base64
        import socket
        from openpbso_tpu_torch.runtime.wsbridge import (_FrameReader,
                                                         ws_accept_key)
        self.sock = socket.create_connection((host, port), timeout=300)
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall(
            f"GET /ws HTTP/1.1\r\nHost: {host}\r\nUpgrade: websocket\r\n"
            f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
            f"Sec-WebSocket-Version: 13\r\n\r\n".encode())
        resp = b""
        while b"\r\n\r\n" not in resp:
            chunk = self.sock.recv(4096)
            check(bool(chunk), "the bridge closed during the handshake")
            resp += chunk
        head, rest = resp.split(b"\r\n\r\n", 1)
        check(b" 101 " in head.split(b"\r\n")[0] and
              ws_accept_key(key).encode() in head,
              f"bad WebSocket handshake: {head[:80]!r}")
        self.reader = _FrameReader(self.sock, max_len=1 << 24)
        self.reader._buf = rest
        self.messages = []

    def read_block(self):
        from openpbso_tpu_torch.runtime.wsbridge import OP_BINARY, OP_TEXT
        while True:
            op, payload = self.reader.read_frame()
            if op == OP_TEXT:
                self.messages.append(json.loads(payload))
            elif op == OP_BINARY:
                return np.frombuffer(payload, "<f4").reshape(-1, 2)
            else:
                raise ConnectionError(f"websocket opcode {op}")

    def _send_frame(self, opcode, payload):
        # a client frame is the server's framing with the mask bit set and
        # the masking key after the length
        from openpbso_tpu_torch.runtime.wsbridge import encode_frame
        mask = os.urandom(4)
        masked = (np.frombuffer(payload, np.uint8)
                  ^ np.resize(np.frombuffer(mask, np.uint8),
                              len(payload))).tobytes()
        frame = encode_frame(opcode, masked)
        n_head = len(frame) - len(masked)
        self.sock.sendall(frame[:1] + bytes([frame[1] | 0x80])
                          + frame[2:n_head] + mask + masked)

    def send(self, **msg):
        from openpbso_tpu_torch.runtime.wsbridge import OP_TEXT
        self._send_frame(OP_TEXT, json.dumps(msg).encode())

    def close(self):
        from openpbso_tpu_torch.runtime.wsbridge import OP_CLOSE
        with contextlib.suppress(OSError):
            self._send_frame(OP_CLOSE, b"")
        self.sock.close()


class ServedClient(threading.Thread):
    """One client of a served stream on its own thread: connects (TCP or
    WebSocket), reads at least ``n_blocks`` and, given ``stop`` (an Event),
    on until it is set, sending the commands of ``schedule`` ({block:
    [command]}) as its count of read blocks passes each, then quits."""

    def __init__(self, address, web, n_blocks, schedule, stop=None):
        super().__init__(daemon=True)
        self.address, self.web = address, web
        self.n_blocks, self.schedule = n_blocks, schedule
        self.stop_evt = stop
        self.blocks, self.error = [], None
        self.connected = threading.Event()

    def run(self):
        from openpbso_tpu_torch.runtime.server import AudioClient
        try:
            c = (WSClient(*self.address) if self.web
                 else AudioClient(*self.address))
            self.client, self.t_connect = c, time.perf_counter()
            self.connected.set()
            k = 0
            while k < self.n_blocks or (self.stop_evt is not None
                                        and not self.stop_evt.is_set()):
                for cmd in self.schedule.get(k, ()):
                    c.send(**cmd)
                self.blocks.append(c.read_block())
                k += 1
            c.send(cmd="quit")
            c.close()
        except BaseException as e:  # noqa: BLE001 — checked by the phase
            self.error = e
            self.connected.set()

    @property
    def slot(self):
        return next((m["listener_slot"] for m in self.client.messages
                     if "listener_slot" in m), None)


def join_clients(clients, seconds=300.0):
    deadline = time.perf_counter() + seconds
    for c in clients:
        c.join(timeout=max(0.0, deadline - time.perf_counter()))
        check(not c.is_alive(), "a served client did not finish in time")
        check(c.error is None, f"a served client failed: {c.error!r}")


def launch_delta(before) -> dict:
    return {k: n - before[k] for k, n in read_launches().items()}


def count_first_step(build, windows):
    """Wrap a session factory (returning a session, or (model, session)):
    the launches from the start of each built session's first step() to
    its return are appended to ``windows``. A server takes that step on a
    client's thread while the live stream runs, so a window holds the
    stream's launches of that time too."""
    def wrapped(*a, **kw):
        out = build(*a, **kw)
        sess = out[1] if isinstance(out, tuple) else out
        step = sess.step

        def first(*sa, **skw):
            del sess.step
            before = read_launches()
            try:
                return step(*sa, **skw)
            finally:
                windows.append(launch_delta(before))
        sess.step = first
        return out
    return wrapped


def stream_launches(total, engine, builds) -> dict:
    """A served stream's own launches: ``total`` (from reset_launches() to
    the stop) less each start()'s and less each window in which a built
    session took its first step. The stream's launches inside those
    windows go too, so this is a lower bound of the stream's count."""
    out = dict(total)
    for d in engine.start_launches + builds:
        for k in out:
            out[k] -= d[k]
    return out


def produced_blocks(engine) -> list:
    """(session, block) of every block the engine's dispatches produced,
    in order."""
    return [(d[0], b) for d in engine.dispatches for b in d[1]]


def match_stream(received, produced, channel, replays, in_flight) -> dict:
    """Hold a client's received blocks against the engine's produced ones
    (its ``channel`` duplicated to stereo; None the whole mix). Silent
    blocks before the client's first sound stand for the silent blocks
    produced before that sound (``silent_lead``; those beyond that run
    count as replays). From there every block must be bitwise the next
    produced one, with two exceptions the engine explains:

    - a replay: the consumer's underrun writes its last block again, or
      silence when a swap cleared it (only with a session's first block
      at most ``in_flight`` blocks ahead); at most ``replays`` (the
      engine's missed blocks) in all;
    - a skip: a swap drops the blocks in flight, at most ``in_flight``
      of one session's last blocks, up to the next session's first.
    """
    cols = [b if channel is None else
            b[:, [channel, channel]] if channel < b.shape[1] else None
            for _, b in produced]   # None: a block before a grow gave it
    n = len(cols)
    first = [k > 0 and produced[k][0] is not produced[k - 1][0]
             for k in range(n)]

    def equal(r, k):
        return cols[k] is not None and np.array_equal(r, cols[k])

    def silent(k):
        return cols[k] is not None and not cols[k].any()
    out = dict(matched=0, replayed=0, dropped=0, silent_lead=0,
               joined_at=None)
    p, last = None, None
    for r in received:
        if p is None:
            if not r.any():
                out["silent_lead"] += 1
                last = r
                continue
            j = next((k for k in range(n) if equal(r, k)), None)
            check(j is not None, f"a client (channel {channel}) received a "
                  "block the engine never produced")
            z = 0
            while z < j and silent(j - 1 - z):
                z += 1
            out["replayed"] += max(0, out["silent_lead"] - z)
            out["joined_at"] = j - min(z, out["silent_lead"])
        elif p < n and equal(r, p):
            j = p
        elif last is not None and np.array_equal(r, last):
            out["replayed"] += 1
            continue
        elif not r.any() and any(first[k] for k in range(
                p, min(n, p + in_flight + 1))):
            out["replayed"] += 1
            last = r
            continue
        else:
            j = next((k for k in range(p + 1, min(n, p + in_flight + 1))
                      if equal(r, k)), None)
            check(j is not None and first[j]
                  and not any(first[k] for k in range(p + 1, j)),
                  f"a client (channel {channel}) received a block out of "
                  f"order or lost more than {in_flight} after block {p}")
            out["dropped"] += j - p
        out["matched"] += 1
        p, last = j + 1, r
    check(out["matched"] > 0, f"channel {channel} never matched a block")
    check(out["replayed"] <= replays, f"channel {channel}: {out['replayed']}"
          f" replays, the engine missed {replays} blocks")
    return out


def replay_engine_events(sess, post_mix, recorded, n_blocks):
    """The engine's first n_blocks offline: its session put back as its
    stream started, each recorded event applied at the block where the
    engine applied it (in the engine's order), stepped per block through
    ``post_mix``."""
    events = {}
    for clock, ev in recorded:
        events.setdefault(clock, []).append(ev)
    out = []
    for _ in range(n_blocks):
        for ev in events.pop(sess.sample_clock, ()):
            kind = type(ev).__name__
            if kind == "HitEvent":
                sess.hit(ev.obj, ev.space, kind=ev.kind,
                         width_us=ev.width_us, amp=ev.amp)
            elif kind == "SustainedEvent":
                if ev.action == "start":
                    sess.sustained_start(ev.obj, ev.space)
                elif ev.action == "update":
                    sess.sustained_update(ev.obj, ev.space)
                else:
                    sess.sustained_end(ev.obj)
            elif kind == "TransferEvent":
                sess.set_listener(ev.listener)
                if post_mix is not None:
                    post_mix.on_listener(ev.listener)
            elif kind == "ArParamEvent":
                sess.set_ar_params(ev.obj, ev.a, ev.sigma, ev.mu)
            else:
                check(False, f"no offline replay for {kind}")
        sound, mix, _ = sess.step()
        out.append((mix if post_mix is None else post_mix(sound, mix))
                   .cpu().numpy())
    return np.concatenate(out)


def post_mix_copy(pm):
    """A DopplerPostMix with its own copy of the state a dispatch moves."""
    import copy
    out = copy.copy(pm)
    out._hist = pm._hist.clone()
    for k in ("positions", "velocities", "_d_cur", "_d_tgt",
              "_last_listener"):
        setattr(out, k, np.array(getattr(pm, k)))
    return out


def grow_probe(srv, log):
    """Wrap the server's state carry (it runs while the stream is parked):
    record the old session's final state and post-mix, its profiler's
    statistics and the engine's event count; then, as the grown stream
    starts (after start()'s warmup), the grown session's state, all its
    attributes and the post-mix it starts with."""
    import dataclasses
    carry = srv._carry_state_across_grow

    def probe(old, new):
        engine = srv._engine
        st = engine.profiler.stats()
        entry = dict(old=[x.clone() for x in (old.state.z_re, old.state.z_im,
                                              old.state.slots.t0)],
                     old_clock=old._clock, events=len(engine.recorded),
                     old_pm=post_mix_copy(engine._post_mix),
                     stats_before=dataclasses.asdict(st) if st else None,
                     t_swap=time.perf_counter())
        log.append(entry)
        ok = carry(old, new)
        warmup = new.warmup

        def after(**kw):
            warmup(**kw)
            new.warmup = warmup
            entry["new"] = [x.clone() for x in (new.state.z_re,
                                                new.state.z_im,
                                                new.state.slots.t0)]
            entry["new_clock"] = new._clock
            entry["new_session"] = new
            entry["new_vars"] = copied(vars(new))
            entry["new_pm"] = post_mix_copy(engine._post_mix)
        new.warmup = after
        return ok
    srv._carry_state_across_grow = probe


def first_block_after(engine, t) -> float | None:
    """Host ms of the first dispatch that started after time ``t``."""
    return next((1e3 * (d[3] - d[2]) for d in engine.dispatches
                 if d[2] >= t), None)


HUD_PAGE = 86     # blocks between the demo page's transfer_hist requests
                  # (wsbridge.py's page: one a second, stats every two)


def served_schedule(i, n_blocks, hud=0, drag=False):
    """Client i's commands: a move of its own listener every 20 blocks,
    hits on objects of its own, with ``drag`` a sustain at block 30
    released at block 120, with ``hud`` > 0 the transfer histogram of its
    row every ``hud`` blocks (and stats every 2 * hud)."""
    sched = {}

    def add(b, cmd):
        sched.setdefault(b, []).append(cmd)
    for b in range(0, n_blocks, 20):
        add(b, {"cmd": "listener", "pos": (
            SCENE_LISTENER + np.array([0.6 * i - 0.9 + 0.1 * np.sin(b),
                                       0.3 * np.cos(0.1 * b), 0.0])).tolist()})
    for k, b in enumerate(range(3 + i, n_blocks - 10, 13)):
        add(b, {"cmd": "hit", "obj": (61 * i + 17 * k) % O,
                "vertex": (5 * k + i) % 12,
                "kind": ("point", "gaussian", "hertz")[k % 3],
                "width_us": 300.0 + 100.0 * (k % 5), "amp": 1.0})
    if drag:
        add(30, {"cmd": "sustain", "obj": 10, "vertex": 4})
        add(120, {"cmd": "release", "obj": 10})
    if hud:
        for b in range(5, n_blocks, hud):
            add(b, {"cmd": "transfer_hist", "obj": (7 * b) % O,
                    "listener": i})
        for b in range(7, n_blocks, 2 * hud):
            add(b, {"cmd": "stats"})
    return sched


def served_window(srv, engine, seconds, hud, n_clients) -> dict:
    """The running server paced at the audio rate for ``seconds`` with
    n_clients fresh WebSocket clients (hits and listener moves; with
    ``hud`` each also asks for its transfer histogram every ``hud``
    blocks):
    the profiler's statistics, missed blocks, the card's idle share by the
    dispatches' CUDA events, and the host ms the histogram replies took
    on the clients' threads (the payload, then its JSON frame)."""
    import gc

    import torch
    from openpbso_tpu_torch.config import SAMPLE_RATE
    from openpbso_tpu_torch.runtime import wsbridge
    from openpbso_tpu_torch.runtime.profiling import BlockProfiler
    from openpbso_tpu_torch.runtime.server import RealTimePacer
    srv._fanout._pacer = RealTimePacer(0.05)
    hud_ms = {"payload": [], "send": []}
    payload, send = srv._transfer_hist_payload, wsbridge._WSSink.send_json

    def timed_payload(*a, **kw):
        t = time.perf_counter()
        out = payload(*a, **kw)
        hud_ms["payload"].append(1e3 * (time.perf_counter() - t))
        return out

    def timed_send(sink, obj):
        t = time.perf_counter()
        send(sink, obj)
        if "transfer_hist" in obj:
            hud_ms["send"].append(1e3 * (time.perf_counter() - t))
    srv._transfer_hist_payload = timed_payload
    wsbridge._WSSink.send_json = timed_send
    gc.collect()
    engine.profiler = BlockProfiler(S, SAMPLE_RATE)
    missed0, n0 = engine.health.missed, len(engine.dispatches)
    stop = threading.Event()
    clients = [ServedClient(srv.address, True, 0,
                            served_schedule(i, 2000, hud), stop)
               for i in range(n_clients)]
    for c in clients:
        c.start()
    t0 = time.perf_counter()
    time.sleep(seconds)
    stop.set()
    wall = time.perf_counter() - t0
    st = engine.profiler.stats()
    missed = engine.health.missed - missed0
    join_clients(clients)
    srv._transfer_hist_payload = payload
    wsbridge._WSSink.send_json = send
    torch.cuda.synchronize()
    window = [d for d in engine.dispatches[n0:]
              if t0 <= d[2] and d[3] <= t0 + wall]
    busy_ms = sum(d[4].elapsed_time(d[5]) for d in window)
    return dict(seconds=wall, blocks=sum(len(d[1]) for d in window),
                missed=missed, p50_ms=st.p50_ms, p95_ms=st.p95_ms,
                p99_ms=st.p99_ms, max_ms=st.max_ms,
                dispatch_event_ms_sum=busy_ms,
                idle_share_by_events=1.0 - busy_ms / (1e3 * wall),
                hud=hud, hud_replies=len(hud_ms["payload"]),
                **{f"hud_{k}_ms_{f.__name__}": float(f(v)) if v else None
                   for k, v in hud_ms.items() for f in (np.median, max)})


def phase_served_web(scene_json) -> tuple:
    """Phase 9a: apps/serve.py's WebSocket broadcast of the Scene with
    per-client listeners in buckets 4, 8 and live Doppler."""
    import torch
    from openpbso_tpu_torch.apps import serve
    from openpbso_tpu_torch.ops.doppler import DopplerPostMix
    from openpbso_tpu_torch.runtime.server import RealTimePacer
    args = serve.parse_args([
        "--scene", scene_json, "--web", "--multi-client",
        "--per-client-listeners", "4,8", "--live-doppler", "--lookahead",
        "1", "--port", "0", "--block", str(S)])
    out = {}
    with served_engines() as engines:
        t = time.perf_counter()
        srv = serve.build_server(args)
        out["build_s"] = time.perf_counter() - t
        check(type(srv).__name__ == "BroadcastWebSocketAudioServer"
              and srv._qnorm_every == QNORM_EVERY,
              f"serve built {type(srv).__name__}, qnorm {srv._qnorm_every}")
        srv._client_depth = 1 << 16    # the bitwise check wants every block
        srv._fanout._pacer = RealTimePacer(None)          # unpaced first
        grows = []
        grow_probe(srv, grows)
        reset_launches()
        server = threading.Thread(target=srv.serve_forever, daemon=True)
        t = time.perf_counter()
        server.start()
        try:
            check(poll(lambda: srv._engine is not None and engines), "no "
                  "engine started")
            engine = engines[0]
            out["start_s"] = time.perf_counter() - t
            builds = []     # the grow's first step, beside the stream
            srv._make_session = count_first_step(srv._make_session, builds)
            # the first clients read on until the fifth has finished, so
            # that they hold slots 0-3 across the grow
            held = threading.Event()
            first = [ServedClient(srv.address, True, SERVED_BLOCKS,
                                  served_schedule(i, SERVED_BLOCKS,
                                                  hud=10 * (i == 1),
                                                  drag=(i == 0)), held)
                     for i in range(SERVED_CLIENTS)]
            for c in first:
                c.start()
                c.connected.wait(300)
            check(poll(lambda: len(first[0].blocks) >= SERVED_GROW_AT),
                  "the first client stalled")
            late = ServedClient(srv.address, True, SERVED_LATE_BLOCKS, {
                2: [{"cmd": "hit", "obj": 3, "vertex": 2,
                     "kind": "gaussian", "width_us": 800.0}]})
            late.start()
            join_clients([late])
            held.set()
            join_clients(first)
            out["grow"] = srv.grows[:]
            check(len(srv.grows) == 1 and srv.grows[0]["carried"]
                  and srv._pcl == 8, f"grows {srv.grows}, L {srv._pcl}")
            g = grows[0]
            check(all(torch.equal(a, b) for a, b in zip(g["old"], g["new"]))
                  and g["old_clock"] == g["new_clock"],
                  "the grow did not carry the ring-down bitwise")
            check(float(g["old"][0].abs().max()) > 0,
                  "nothing rang at the grow")
            # the Doppler delay lines of the four old columns carried too
            old_pm, new_pm = g["old_pm"], g["new_pm"]
            check(new_pm._nl == 8 and torch.equal(new_pm._hist[:, :4],
                                                   old_pm._hist)
                  and np.array_equal(new_pm._d_cur[:, :4], old_pm._d_cur)
                  and np.array_equal(new_pm._d_tgt[:, :4], old_pm._d_tgt)
                  and float(old_pm._hist.abs().max()) > 0
                  and not new_pm._hist[:, 4:].any(),
                  "the grow did not carry the delay lines bitwise")
            out["grow"][0]["stats_before"] = g["stats_before"]
            # the blocks dispatched while the grow built its Scene on a
            # client's thread, and the second after the swap
            t1 = g["t_swap"]
            t0 = t1 - srv.grows[0]["seconds"]
            for key, lo, hi in (("during", t0, t1),
                                ("after", t1, t1 + 1.0)):
                ms = [1e3 * (d[3] - d[2]) for d in engine.dispatches
                      if lo <= d[2] < hi]
                out["grow"][0][f"blocks_{key}"] = dict(
                    n=len(ms), p50_ms=float(np.percentile(ms, 50)),
                    p99_ms=float(np.percentile(ms, 99)),
                    max_ms=max(ms)) if ms else None
            produced = produced_blocks(engine)
            out["clients"] = []
            missed = engine.health.missed
            in_flight = engine._sound.maxsize + engine.lookahead
            for c in first + [late]:
                m = match_stream(c.blocks, produced, c.slot, missed,
                                 in_flight)
                out["clients"].append(dict(
                    m, slot=c.slot, received=len(c.blocks),
                    first_block_ms=first_block_after(engine, c.t_connect)))
            check(sorted(c["slot"] for c in out["clients"]) == [0, 1, 2, 3,
                                                                  4],
                  f"slots {[c['slot'] for c in out['clients']]}")
            check(any(h for c in first for h in c.client.messages
                      if "transfer_hist" in h), "no transfer_hist reply")
            # the first session's blocks against its offline replay
            sess = engine.first_session
            n_first = sum(1 for s, _ in produced if s is sess)
            recorded = engine.recorded[:g["events"]]
            clocks = [clock for clock, ev in recorded
                      if type(ev).__name__ == "HitEvent"]
            drags = [clock for clock, ev in recorded
                     if type(ev).__name__ == "SustainedEvent"]
            check(bool(clocks) and bool(drags), "no hit or drag before the "
                  "grow")
            c0 = engine.start_vars["_clock"]
            n_pre = (min(drags) - c0) // S
            n_cmp = min(n_first, max(SERVED_COMPARED, n_pre + 40))
            check(n_pre > (min(clocks) - c0) // S and n_pre <= n_cmp,
                  f"hits from block {(min(clocks) - c0) // S}, drag from "
                  f"{n_pre}, {n_cmp} compared")
        finally:
            srv._fanout._pacer = RealTimePacer(None)
        out["unpaced_stats"] = stats_dict(engine)
        out["unpaced_missed"] = engine.health.missed
        # the HUD (the colour pusher runs throughout): off, at the demo
        # page's rate (a histogram a second, stats every two), at ten
        # times that, off
        out["paced_hud_off_before"] = served_window(
            srv, engine, SERVED_PACED_SECONDS / 2, 0, SERVED_CLIENTS)
        out["paced_hud_on"] = served_window(srv, engine, SERVED_PACED_SECONDS,
                                            HUD_PAGE, SERVED_CLIENTS)
        out["paced_hud_x10"] = served_window(
            srv, engine, SERVED_PACED_SECONDS / 2, 10, SERVED_CLIENTS)
        out["paced_hud_off"] = served_window(
            srv, engine, SERVED_PACED_SECONDS / 2, 0, SERVED_CLIENTS)
        srv.close()
        server.join(timeout=60)
        torch.cuda.synchronize()
        out["launches_total"] = total = read_launches()
        out["launches_of_starts"] = engine.start_launches
        out["launches_of_builds"] = builds
        out["launches"] = counts = stream_launches(total, engine, builds)
        check(engine.error is None, f"served engine error {engine.error!r}")
        check(len(engine.start_launches) == 2 and len(builds) == 1,
              f"{len(engine.start_launches)} starts, {len(builds)} builds")
    vars(sess).clear()
    vars(sess).update(copied(engine.start_vars))
    pos, gains, nl = engine.pm_start
    pm = DopplerPostMix(pos, num_listeners=nl, gains=gains)
    pm.reset()
    ref = replay_engine_events(sess, pm, recorded, n_cmp)
    got = np.concatenate([b for s, b in produced[:n_cmp]])
    check(float(np.abs(ref[:n_pre * S]).max()) > 0, "offline replay silent")
    out["db_first_blocks_vs_offline"] = db_error(got[:n_pre * S],
                                                 ref[:n_pre * S])
    out["db_with_drags_vs_offline"] = db_error(got, ref)
    out.update(compared_blocks=n_cmp, blocks_before_drag=n_pre)
    check(out["db_first_blocks_vs_offline"] <= -90.0
          and out["db_with_drags_vs_offline"] <= -60.0,
          f"served stream vs offline {out['db_first_blocks_vs_offline']} / "
          f"{out['db_with_drags_vs_offline']} dB")
    # the grown session's blocks against the same replay from the state
    # and post-mix its stream started with (carried, then warmed up)
    grown = g["new_session"]
    vars(grown).clear()
    vars(grown).update(copied(g["new_vars"]))
    n_grown = min(SERVED_COMPARED,
                  sum(1 for s, _ in produced if s is grown))
    later = engine.recorded[g["events"]:]
    starts = [clock for clock, ev in later
              if type(ev).__name__ == "SustainedEvent"
              and ev.action == "start"]
    n_quiet = (0 if g["new_vars"]["_sus_active"].any() else
               min([n_grown] + [(c - g["new_clock"]) // S for c in starts]))
    ref = replay_engine_events(grown, g["new_pm"], later, n_grown)
    got = np.concatenate([b for s, b in produced if s is grown][:n_grown])
    check(n_grown >= 20 and float(np.abs(ref).max()) > 0,
          f"{n_grown} blocks after the grow, replay peak "
          f"{float(np.abs(ref).max())}")
    out["grown"] = dict(
        compared_blocks=n_grown, blocks_before_drag=n_quiet,
        db_vs_offline=db_error(got, ref),
        db_before_drag_vs_offline=(db_error(got[:n_quiet * S],
                                            ref[:n_quiet * S])
                                   if n_quiet else None))
    check(out["grown"]["db_vs_offline"] <= -60.0
          and (not n_quiet
               or out["grown"]["db_before_drag_vs_offline"] <= -90.0),
          f"the grown stream vs offline {out['grown']}")
    for name in ("chunk_scan", "toeplitz_conv", "span_inject", "span_reduce",
                 "ar_noise"):
        check(counts[name] > 0, f"9a's stream never launched {name}: "
              f"{counts}")
    print("served web:", json.dumps(out, default=float), flush=True)
    return out, counts


def phase_served_mono(scene_json, metas) -> tuple:
    """Phase 9b: the TCP broadcast of a single-listener Scene, a retuned
    drag meeting live impacts (per-block steps through fused_block and
    ar_block), then stats and a load_model hot swap."""
    import torch
    from openpbso_tpu_torch.apps import serve
    from openpbso_tpu_torch.apps.real_time_modal_sound import \
        session_from_meta
    from openpbso_tpu_torch.runtime.server import RealTimePacer
    args = serve.parse_args(["--scene", scene_json, "--multi-client",
                             "--port", "0", "--block", str(S)])
    out = {}
    with served_engines() as engines:
        t = time.perf_counter()
        srv = serve.build_server(args)
        out["build_s"] = time.perf_counter() - t
        args.instances = O
        builds = []     # load_model's first step, beside the stream
        srv._session_loader = count_first_step(
            lambda meta: session_from_meta(args, meta), builds)
        srv._client_depth = 1 << 16
        srv._fanout._pacer = RealTimePacer(None)
        reset_launches()
        server = threading.Thread(target=srv.serve_forever, daemon=True)
        server.start()
        check(poll(lambda: srv._engine is not None and engines),
              "no engine started")
        engine = engines[0]
        hits = {b: [{"cmd": "hit", "obj": 5, "vertex": b % 12,
                     "kind": "gaussian", "width_us": 2000.0}]
                for b in range(20, 60, 2)}
        hits[3] = [{"cmd": "hit", "obj": 100, "vertex": 1}]
        drags = {10: [{"cmd": "sustain", "obj": 9, "vertex": 3}],
                 15: [{"cmd": "arparam", "obj": 9, "a": [0.6, 0.2],
                       "sigma": 0.003, "mu": 0.1}],
                 80: [{"cmd": "release", "obj": 9}]}
        clients = [ServedClient(srv.address, False, MONO_BLOCKS, sched)
                   for sched in (hits, drags)]
        for c in clients:
            c.start()
            c.connected.wait(300)
        join_clients(clients)
        stream_counts = stream_launches(read_launches(), engine, [])
        produced = produced_blocks(engine)
        out["clients"] = [match_stream(c.blocks, produced, None,
                                       engine.health.missed, 0)
                          for c in clients]
        out["stream_stats"] = stats_dict(engine)
        out["stream_launches"] = stream_counts
        out["launches_of_start"] = engine.start_launches[0]
        for name in ("fused_block", "ar_block"):
            check(stream_counts[name] > 0, f"9b's stream never launched "
                  f"{name}: {stream_counts}")
        from openpbso_tpu_torch.runtime.server import AudioClient
        c = AudioClient(*srv.address)
        read = []
        c.send(cmd="stats")
        check(poll_client(c, read, lambda: any("health" in m
                                               for m in c.messages)),
              "no stats reply")
        out["stats_reply"] = next(m for m in c.messages if "health" in m)
        t = time.perf_counter()
        c.send(cmd="load_model", meta=metas[1])
        check(poll_client(c, read, lambda: any("loaded" in m or "error" in m
                                               for m in c.messages)),
              "no load_model reply")
        reply = next(m for m in c.messages if "loaded" in m or "error" in m)
        out["load_model_s"] = time.perf_counter() - t
        out["load_model_reply"] = reply
        check(reply.get("loaded") == metas[1] and reply["objects"] == O
              and reply["modes"] >= M, f"load_model: {reply}")
        c.send(cmd="hit", obj=7, vertex=2, kind="gaussian", width_us=900.0)
        n_read = len(read)
        check(poll_client(c, read, lambda: any(
            float(np.abs(b).max()) > 0 for b in read[n_read:])),
              "the swapped model is silent")
        c.send(cmd="quit")
        c.close()
        srv.close()
        server.join(timeout=60)
        torch.cuda.synchronize()
        check(engine.error is None, f"9b engine error {engine.error!r}")
        check(len(engine.start_launches) == 2 and len(builds) == 1,
              f"{len(engine.start_launches)} starts, {len(builds)} builds")
        out["launches_of_load_model"] = dict(start=engine.start_launches[1],
                                             first_step=builds[0])
        out["launches"] = counts = stream_launches(read_launches(), engine,
                                                   builds)
    print("served mono:", json.dumps(out, default=float), flush=True)
    return out, counts


def poll(cond, seconds=300.0) -> bool:
    deadline = time.perf_counter() + seconds
    while time.perf_counter() < deadline:
        if cond():
            return True
        time.sleep(0.005)
    return bool(cond())


def poll_client(c, read, cond, blocks=20000) -> bool:
    """Read blocks from an AudioClient into ``read`` until ``cond``."""
    for _ in range(blocks):
        if cond():
            return True
        read.append(c.read_block())
    return bool(cond())


def bake_timeline(n_blocks, seed) -> dict:
    """9c's timeline: 40 hits on object 7 two blocks apart from block 8
    (more than its 16 slots: waves at blocks 0, 40 and 72) and 24 on other
    objects, three listener keyframes, one drag with a sigma/mu retune
    (blocks 16, 24, 56), per-block listener rows (no ramp). Every action
    falls on a multiple of 8 blocks, so each span of the render without
    keyframes is 8k blocks and takes the one chunk size C = 512."""
    rng = np.random.default_rng(seed)
    blk = S / 44100.0
    events = [{"t": (8 + 2 * k) * blk, "obj": 7,
               "space": rng.standard_normal(M).tolist(),
               "kind": ("point", "gaussian")[k % 2], "width_us": 500.0}
              for k in range(40)]
    events += [{"t": float(rng.integers(0, n_blocks - 4)) * blk,
                "obj": int(rng.integers(8, O)),
                "space": rng.standard_normal(M).tolist(),
                "kind": "hertz", "width_us": 800.0} for _ in range(24)]
    space = rng.standard_normal(M).tolist()
    return {"duration_s": n_blocks * blk, "events": events, "smooth": False,
            "listener": [{"t": 0.0, "pos": [0.4, 0.2, 1.2]},
                         {"t": 0.5 * n_blocks * blk, "pos": [1.5, 0.1, 0.4]},
                         {"t": n_blocks * blk, "pos": [-0.6, 0.8, 1.0]}],
            "sustained": [{"t": 16 * blk, "obj": 11, "action": "start",
                           "space": space},
                          {"t": 24 * blk, "obj": 11, "action": "arparam",
                           "a": [0.783, 0.116], "sigma": 0.003, "mu": 0.1},
                          {"t": 56 * blk, "obj": 11, "action": "end"}],
            "seed": 3}


def per_block_timeline(sess, timeline):
    """The same timeline stepped per block: each event applied at its
    block and, with listener keyframes, each block's listener row set
    before it steps."""
    from openpbso_tpu_torch.apps import render_timeline
    n = int(np.ceil(timeline["duration_s"] * 44100 / S))
    rows = (render_timeline.listener_blocks(timeline["listener"], n, S)
            if "listener" in timeline else None)
    at = {}
    for ev in timeline["events"]:
        at.setdefault(int(round(ev["t"] * 44100 / S)), []).append(
            lambda s, ev=ev: s.hit(ev["obj"], np.asarray(ev["space"]),
                                   kind=ev["kind"],
                                   width_us=ev["width_us"]))
    for ev in timeline["sustained"]:
        at.setdefault(int(round(ev["t"] * 44100 / S)), []).append(
            lambda s, ev=ev: render_timeline._apply_sustained(s, ev))
    out = []
    for b in range(n):
        for fn in at.get(b, ()):
            fn(sess)
        if rows is not None:
            sess.set_listener(rows[b])
        out.append(sess.step()[1].cpu().numpy())
    return np.concatenate(out)


def phase_offline_apps(scene, modes, seed) -> tuple:
    """Phase 9c: render_timeline.bake at O x M against the per-block
    render of the same script, with listener keyframes (render_moving:
    fused_block, ar_block) and without (render_multi: the span kernels),
    then render_offline's configs 1-5. The bank is heterogeneous with four
    distinct mode sets (phase 4's first four, repeated as a Scene of four
    models repeats them), so its span tables take seconds, not minutes;
    the maps and listeners are phase 4's."""
    import torch
    from openpbso_tpu_torch.apps import render_offline, render_timeline
    four = tuple(np.tile(x[:4], (O // 4, 1)) for x in modes)
    scene = dict(scene, bank=hetero_bank(O, M, S, scene["bank"].device,
                                         four))
    lam64 = four[0]
    out = {}
    counts = dict.fromkeys(KERNELS, 0)
    moving = bake_timeline(BAKE_BLOCKS, seed)
    fixed = {k: v for k, v in moving.items() if k != "listener"}
    for label, timeline, kernels in (
            ("keyframes", moving, ("fused_block", "ar_block")),
            ("fixed", fixed, ("chunk_scan", "toeplitz_conv", "span_inject",
                              "span_reduce", "ar_noise"))):
        reset_launches()
        sess = live_session(scene, lam64, smooth=False)
        waves = render_timeline._hit_waves(sess, timeline["events"],
                                           BAKE_BLOCKS)
        check(len(waves) >= 3, f"{len(waves)} hit waves")
        torch.cuda.synchronize()
        t = time.perf_counter()
        baked = render_timeline.bake(sess, timeline)
        bake_s = time.perf_counter() - t
        bake_counts = read_launches()
        for name, n in bake_counts.items():
            counts[name] += n
        ref_sess = live_session(scene, smooth=False)
        render_timeline._reseed_sustained(ref_sess, timeline["seed"])
        ref = per_block_timeline(ref_sess, timeline)
        n_pre = 20 * S
        k = dict(bake_s=bake_s, waves=len(waves), launches=bake_counts,
                 db_before_drag=db_error(baked[:n_pre], ref[:n_pre]),
                 db=db_error(baked, ref))
        out[label] = k
        check(baked.shape == ref.shape and float(np.abs(ref).max()) > 0,
              f"bake {label} {baked.shape} vs {ref.shape}")
        check(k["db_before_drag"] <= -90.0 and k["db"] <= -60.0,
              f"bake {label} vs per block {k['db_before_drag']} / "
              f"{k['db']} dB")
        for name in kernels:
            check(bake_counts[name] > 0, f"bake {label} never launched "
                  f"{name}: {bake_counts}")
    report = []
    with tempfile.TemporaryDirectory() as tmp:
        for n in (1, 2, 3, 4, 5):
            r = render_offline.run_config(n, "blocked", tmp)
            check(r["peak"] > 0 and np.isfinite(r["peak"])
                  and os.path.getsize(r["wav"]) > 44, f"config {n}: {r}")
            r.pop("wav")
            report.append(r)
    out["render_offline"] = report
    print("offline apps:", json.dumps(out, default=float), flush=True)
    return out, counts


def phase_served(dirs, scene, modes, seed) -> dict:
    """Phase 9; returns its launches per kernel."""
    import torch
    launches = dict.fromkeys(KERNELS, 0)
    with tempfile.TemporaryDirectory() as root:
        web_json, metas = write_served_scene(root, dirs, "web.json")
        mono_json, _ = write_served_scene(root, dirs, "mono.json")
        web, counts = phase_served_web(web_json)
        for name in KERNELS:
            launches[name] += counts[name]
        torch.cuda.empty_cache()
        mono, counts = phase_served_mono(mono_json, metas)
        for name in KERNELS:
            launches[name] += counts[name]
        torch.cuda.empty_cache()
    offline, counts = phase_offline_apps(scene, modes, seed)
    for name in KERNELS:
        launches[name] += counts[name]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print("served timings:", json.dumps({
        "card": smi,
        "web_unpaced": {k: web["unpaced_stats"][k] for k in (
            "p50_ms", "p95_ms", "p99_ms", "max_ms")},
        "web_missed_unpaced": web["unpaced_missed"],
        "grow_s": web["grow"][0]["seconds"],
        "first_block_ms_after_connect": [c["first_block_ms"]
                                         for c in web["clients"]],
        "grow_blocks": {k: web["grow"][0][f"blocks_{k}"]
                        for k in ("during", "after")},
        "web_paced_hud_off_before": web["paced_hud_off_before"],
        "web_paced_hud_on": web["paced_hud_on"],
        "web_paced_hud_x10": web["paced_hud_x10"],
        "web_paced_hud_off": web["paced_hud_off"],
        "mono": {k: mono["stream_stats"][k] for k in (
            "p50_ms", "p95_ms", "p99_ms", "max_ms")},
        "load_model_s": mono["load_model_s"],
        "bake_s": {k: offline[k]["bake_s"] for k in ("keyframes",
                                                      "fixed")},
        "launches": launches}, default=float), flush=True)
    return launches


def mesh_of(shape, one_card=False):
    """A mesh of the given shape: distinct cards where the machine has as
    many as it needs (and ``one_card`` is not asked), else every cell on
    cuda:0 (printed either way)."""
    import torch
    from openpbso_tpu_torch.parallel import make_mesh
    n = shape[0] * shape[1]
    cards = torch.cuda.device_count()
    distinct = cards >= n and not one_card
    print(f"mesh {shape}: " + ("distinct cards" if distinct else
                               f"every cell on cuda:0 ({cards} card(s))"),
          flush=True)
    return make_mesh(*shape, devices=[f"cuda:{k}" for k in range(n)]
                     if distinct else ["cuda:0"] * n)


def sync_cards():
    import torch
    for k in range(torch.cuda.device_count()):
        torch.cuda.synchronize(k)


def mesh_session(bank, shape, ffat=None, lam64=None, smooth=False,
                 tables_from=None, one_card=False):
    """A ShardedSession on mesh_of(shape, one_card). ``tables_from``: a
    session whose span tables this one shards instead of building its own
    (a hetero bank's host float64 build takes seconds)."""
    from openpbso_tpu_torch.parallel import ShardedSession
    from openpbso_tpu_torch.runtime.solver import SolverConfig
    sess = ShardedSession(bank, mesh_of(shape, one_card), ffat=ffat,
                          config=SolverConfig(block_size=S,
                                              backend="blocked",
                                              smooth_transfer=smooth),
                          lam64=lam64)
    if tables_from is not None:
        sess._span_cache.update(tables_from._span_cache)
    return sess


def mesh_per_block(sess, scene, spaces):
    """10a's script on ``sess`` block by block: phase 4's hits up to
    MESH_HIT_LAST, four drags, one listener move, then the ring-down.
    Returns the mix."""
    dragged = list(range(3, O, O // 4))[:4]
    sess.set_listener(scene["listeners"])
    for h in scene["hits"]:
        if h["when"] is None or h["when"] <= MESH_HIT_LAST * S:
            sess.hit(h["obj"], h["space"], kind=h["kind"],
                     width_us=h["width_us"], amp=h["amp"], when=h["when"])
    out = []
    for b in range(MESH_BLOCKS + MESH_RINGDOWN):
        if b == MESH_DRAGS[0]:
            for o, v in zip(dragged, spaces):
                sess.sustained_start(o, v)
        if b == MESH_MOVE:
            sess.set_listener(scene["listeners"] * 1.1 + 0.2)
        if b == MESH_DRAGS[1]:
            for o in dragged:
                sess.sustained_end(o)
        out.append(sess.step()[1].cpu().numpy())
    return np.concatenate(out)


def nbytes(tree) -> int:
    """Bytes of every tensor in a dataclass tree or a grid of them."""
    import dataclasses
    import torch
    if isinstance(tree, list):
        return sum(nbytes(x) for x in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if dataclasses.is_dataclass(tree):
        return sum(nbytes(getattr(tree, f.name))
                   for f in dataclasses.fields(tree) if f.init)
    return 0


def card_bytes(peak=False) -> list:
    import torch
    read = (torch.cuda.max_memory_allocated if peak
            else torch.cuda.memory_allocated)
    return [read(k) for k in range(torch.cuda.device_count())]


def check_ar_block_on_shard(args) -> dict:
    """ar_block against its twin on one shard's captured inputs: bitwise
    given the kernel's own normals."""
    import torch
    from openpbso_tpu_torch.ops import ar_block as kb
    from openpbso_tpu_torch.ops import ar_noise as ka
    check(args[0].shape[0] == O // 2,
          f"captured ar_block on {args[0].shape[0]} objects, not a shard's")
    idx, _ = ka.block_counter(args[6], S)
    got = kb.ar_block(*args)
    given = kb.ar_block_reference(*args[:6], idx, S, noise=ka.ar_noise(
        args[0], args[6], 1, S)[:, 0])
    torch.cuda.synchronize()
    check(all(torch.equal(k, g) for k, g in zip(got, given)),
          "10a: ar_block differs from its twin on a shard's inputs")
    return {"objects": args[0].shape[0], "active": int(args[5].sum()),
            "block_start": args[6], "bitwise_vs_plain": True}


def phase_mesh_blocks(scene, shapes) -> dict:
    """10a: the per-block path on each mesh against the unsharded session
    (the blocked form, smooth listener moves); the memory each session
    holds on each card; on (2, 2) ar_block against its twin on one
    shard's inputs."""
    import gc
    import torch
    from openpbso_tpu_torch.runtime.session import ModalSession
    from openpbso_tpu_torch.runtime.solver import SolverConfig
    spaces = np.random.default_rng(10).standard_normal((4, M))
    bank_bytes = nbytes(scene["bank"])
    ref = mesh_per_block(ModalSession(scene["bank"], scene["ffat"],
                                      SolverConfig(block_size=S,
                                                   backend="blocked",
                                                   smooth_transfer=True)),
                         scene, spaces)
    cut = MESH_DRAGS[0] * S
    out, launches = {}, dict.fromkeys(KERNELS, 0)
    for shape in shapes:
        shards = shape[0] * shape[1]
        gc.collect()    # the last mesh's session (dispatch_log's cycle)
        sync_cards()
        before = card_bytes()
        for k in range(len(before)):
            torch.cuda.reset_peak_memory_stats(k)
        sess = mesh_session(scene["bank"], shape, ffat=scene["ffat"],
                            smooth=True)
        sync_cards()
        held = [a - b for a, b in zip(card_bytes(), before)]
        shard_bytes = nbytes(sess._banks) + nbytes(sess._shards)
        # the session holds the bank's shards and the state, not a second
        # whole bank (allocator rounding and small tensors within 16 MiB)
        check(sum(held) <= shard_bytes + (16 << 20),
              f"10a {shape}: the session holds {sum(held)} bytes on the "
              f"cards, its shards {shard_bytes} (bank {bank_bytes})")
        log = dispatch_log(sess)
        capture = shape == (2, 2)
        with (capture_ar_kernel_inputs() if capture
              else contextlib.nullcontext({})) as captured:
            reset_launches()
            t = time.perf_counter()
            mix = mesh_per_block(sess, scene, spaces)
            seconds = time.perf_counter() - t
            counts = read_launches()
        sync_cards()
        peak = [a - b for a, b in zip(card_bytes(peak=True), before)]
        kinds = [k for k, *_ in log]
        drag_blocks = MESH_DRAGS[1] - MESH_DRAGS[0]
        want = dict.fromkeys(KERNELS, 0)
        want["ar_block"] = shards * drag_blocks
        check(counts == want, f"10a {shape}: launches {counts} != {want}")
        check(kinds[-MESH_RINGDOWN:] == ["decay"] * MESH_RINGDOWN
              and kinds.count("xfade") == 2,
              f"10a {shape}: dispatches {kinds}")
        check(bool(np.isfinite(mix).all()) and float(np.abs(mix).max()) > 0,
              f"10a {shape}: mix not finite or silent")
        res = {"db_before_drags": db_error(mix[:cut], ref[:cut]),
               "db_with_drags": db_error(mix[cut:], ref[cut:]),
               "ms_per_block_mean": 1e3 * seconds / len(kinds),
               "launches": counts, "bank_bytes": bank_bytes,
               "shard_bytes": shard_bytes, "held_bytes_per_card": held,
               "peak_bytes_per_card": peak}
        if capture:
            res["ar_block_on_shard_inputs"] = check_ar_block_on_shard(
                captured["ar_block"])
        check(res["db_before_drags"] <= -90.0 and res["db_with_drags"]
              <= -60.0, f"10a {shape}: {res}")
        out[str(shape)] = res
        for k in KERNELS:
            launches[k] += counts[k]
        del sess, log
    print("mesh per block:", json.dumps(out), flush=True)
    return launches


def span_ab(ref_sess, sess, bank, solo=None) -> dict:
    """One full 16-block span dispatch on the same inputs, unsharded (A)
    and sharded (B), in the order A B B A, or with ``solo`` (the same
    mesh with every cell on cuda:0, C) A B C C B A: a gaussian hit
    planted on every object, the one-slot bucket. Host clock around each
    dispatch, every card synchronised; median of 7 after 2 warm calls."""
    from openpbso_tpu_torch.ops.forces import FORCE_GAUSSIAN
    from openpbso_tpu_torch.parallel.sharding import shard_state
    from openpbso_tpu_torch.runtime.solver import default_gains, step_span
    from openpbso_tpu_torch.runtime.state import make_solver_state
    import torch
    m = bank.num_modes
    state = make_solver_state(O, m, num_slots=8, device=bank.device)
    state.slots.ftype[:, 0] = FORCE_GAUSSIAN
    state.slots.width[:, 0] = 40.0
    state.slots.space[:, 0] = torch.randn(
        (O, m), generator=torch.Generator(device=bank.device).manual_seed(5),
        device=bank.device)
    gains = default_gains(O, device=bank.device)
    tables = ref_sess.span_tables_for(SPAN_DISPATCH)

    def unsharded():
        return step_span(state, bank, tables, gains, n_blocks=SPAN_DISPATCH,
                         block_size=S, num_slots=1)[1]

    def dispatch(s):
        grid = s._span_tables_sharded(SPAN_DISPATCH)
        shards = shard_state(s.mesh, state)
        fn = s._fn("span", n_blocks=SPAN_DISPATCH, num_slots=1, decay=False)
        return lambda: fn(shards, s._banks, grid, gains)[1]
    sharded = dispatch(sess)

    def wall(f, runs=7):
        times = []
        for i in range(runs + 2):
            sync_cards()
            t = time.perf_counter()
            f()
            sync_cards()
            if i >= 2:
                times.append(1e3 * (time.perf_counter() - t))
        return statistics.median(times)
    want = unsharded().cpu().numpy()
    check(db_error(sharded().cpu().numpy(), want) <= -90.0,
          "the timed span dispatches disagree")
    if solo is None:
        a1, b1, b2, a2 = wall(unsharded), wall(sharded), wall(sharded), \
            wall(unsharded)
        return {"unsharded_ms": [a1, a2], "sharded_ms": [b1, b2]}
    one_card = dispatch(solo)
    check(db_error(one_card().cpu().numpy(), want) <= -90.0,
          "the timed one-card span dispatch disagrees")
    a1, b1, c1, c2, b2, a2 = (wall(f) for f in (
        unsharded, sharded, one_card, one_card, sharded, unsharded))
    return {"unsharded_ms": [a1, a2], "sharded_ms": [b1, b2],
            "one_card_ms": [c1, c2]}


def phase_mesh_spans(scene, lam64, shared, shared_lam, shapes,
                     tables) -> dict:
    """10b: render_multi (16-block spans, C = 512) on each mesh against the
    unsharded render, hetero (phase 4's scene) and shared; launches
    shards x dispatches, one reduction a dispatch; on (2, 2) the span
    kernels against their twins on one shard's inputs of the first busy
    dispatch; one span dispatch timed A B B A. ``tables``: the hetero
    bank's span tables by chunk, shared with 10c (filled here)."""
    import torch
    from openpbso_tpu_torch.ops import chunk_scan as k1
    from openpbso_tpu_torch.parallel import sharding
    rng = np.random.default_rng(11)
    cases = {
        "hetero": (scene["bank"], lam64, scene["ffat"], scene["hits"]),
        "shared": (shared, shared_lam, None, hit_script(rng, O, M, S))}
    n_dispatch = math.ceil(RENDER_BLOCKS / SPAN_DISPATCH)
    out, launches = {}, dict.fromkeys(KERNELS, 0)
    for label, (bank, lam, ffat, hits) in cases.items():
        ref_sess = new_session(bank, ffat, scene["listeners"], hits,
                               "blocked", lam64=lam)
        if label == "hetero":
            ref_sess._span_cache = tables
        reset_launches()
        ref = ref_sess.render_multi(RENDER_BLOCKS,
                                    blocks_per_dispatch=SPAN_DISPATCH)
        ref_counts = read_launches()
        check(ref_counts["chunk_scan"] == n_dispatch
              and 0 < ref_counts["toeplitz_conv"] < n_dispatch,
              f"10b {label}: unsharded launches {ref_counts}")
        for shape in shapes:
            shards = shape[0] * shape[1]
            sess = mesh_session(bank, shape, ffat=ffat, lam64=lam,
                                tables_from=ref_sess)
            sess.set_listener(scene["listeners"])
            for h in hits:
                sess.hit(h["obj"], h["space"], kind=h["kind"],
                         width_us=h["width_us"], amp=h["amp"],
                         when=h["when"])
            capture = label == "hetero" and shape == (2, 2)
            with (capture_span_kernel_inputs() if capture
                  else contextlib.nullcontext({})) as captured:
                reset_launches()
                sharding.REDUCTIONS = 0
                mix = sess.render_multi(RENDER_BLOCKS,
                                        blocks_per_dispatch=SPAN_DISPATCH)
                counts = read_launches()
                reductions = sharding.REDUCTIONS
            want = {k: shards * ref_counts[k] for k in KERNELS}
            check(counts == want, f"10b {label} {shape}: launches {counts} "
                  f"!= {want}")
            check(reductions == n_dispatch, f"10b {label} {shape}: "
                  f"{reductions} reductions in {n_dispatch} dispatches")
            res = {"db_vs_unsharded": db_error(mix, ref), "launches": counts,
                   "reductions": reductions, "dispatches": n_dispatch}
            check(res["db_vs_unsharded"] <= -90.0,
                  f"10b {label} {shape}: {res['db_vs_unsharded']} dB")
            if capture:
                kern = {}
                for kind in ("busy", "decay"):
                    args = captured[("chunk_scan", kind)]
                    check(args[0].shape == (O // 2, M // 2),
                          f"captured a {tuple(args[0].shape)} shard")
                    got, plain = (k1.chunk_scan(*args),
                                  k1.chunk_scan_reference(*args))
                    check(all(torch.equal(a, b) for a, b in zip(got, plain)),
                          f"10b: chunk_scan ({kind}) not bitwise its twin")
                    kern[f"chunk_scan_{kind}"] = "bitwise"
                kern["toeplitz_conv_busy"] = toeplitz_case(
                    "(2, 2) shard, first busy dispatch",
                    *captured[("toeplitz_conv", "busy")], timed=False)
                for (name, kind), args in sorted(captured.items()):
                    if name in ("span_inject", "span_reduce"):
                        kern[f"{name}_{kind}"] = contraction_case(
                            f"(2, 2) shard, {kind}", name, args)
                keep_contraction_inputs("(2, 2) shard", captured)
                res["kernels_on_shard_inputs"] = kern
                solo = (mesh_session(bank, shape, ffat=ffat, lam64=lam,
                                     tables_from=ref_sess, one_card=True)
                        if len(sess.devices) > 1 else None)
                res["span_dispatch_ab"] = span_ab(ref_sess, sess, bank, solo)
                del solo
            out[f"{label} {shape}"] = res
            for k in KERNELS:
                launches[k] += counts[k]
            del sess
        del ref_sess
        torch.cuda.empty_cache()
    print("mesh spans:", json.dumps(out), flush=True)
    return launches


@contextlib.contextmanager
def record_noise():
    """While open, the arguments of every ar_noise call the forces module
    makes, in order."""
    from openpbso_tpu_torch.ops import forces as forces_mod
    calls = []
    original = forces_mod.ar_noise

    def call(key, block_start, n_blocks, s):
        calls.append((key.clone(), block_start, n_blocks, s))
        return original(key, block_start, n_blocks, s)
    forces_mod.ar_noise = call
    try:
        yield calls
    finally:
        forces_mod.ar_noise = original


def phase_mesh_sustained(scene, lam64, tables) -> dict:
    """10c: drags on 32 objects rendered by span on (2, 2): each shard's
    ar_noise bits bitwise the unsharded session's rows for its objects,
    the mix <= -60 dB against the unsharded render."""
    import torch
    from openpbso_tpu_torch.ops import ar_noise as ka
    rng = np.random.default_rng(12)
    dragged = list(range(1, O, O // DRAGGED))[:DRAGGED]
    spaces = rng.standard_normal((DRAGGED, M))

    def script(sess):
        sess.set_listener(scene["listeners"])
        for o, v in zip(dragged, spaces):
            sess.sustained_start(o, v)
        with record_noise() as calls:
            mix = sess.render_multi(MESH_SUSTAINED_BLOCKS,
                                    blocks_per_dispatch=SPAN_DISPATCH)
        return mix, calls
    ref_sess = new_session(scene["bank"], scene["ffat"], scene["listeners"],
                           (), "blocked", lam64=lam64)
    ref_sess._span_cache = tables
    ref, ref_calls = script(ref_sess)
    sess = mesh_session(scene["bank"], (2, 2), ffat=scene["ffat"],
                        lam64=lam64, tables_from=ref_sess)
    reset_launches()
    mix, calls = script(sess)
    counts = read_launches()
    n_dispatch = MESH_SUSTAINED_BLOCKS // SPAN_DISPATCH
    check(len(ref_calls) == n_dispatch and len(calls) == 4 * n_dispatch
          and counts["ar_noise"] == 4 * n_dispatch,
          f"10c: {len(calls)} sharded, {len(ref_calls)} unsharded ar_noise "
          f"calls, launches {counts}")
    per = O // 2
    for d, (key, start, n, s) in enumerate(ref_calls):
        whole = ka.ar_noise(key, start, n, s, bits=True)
        for cell in range(4):
            i = cell // 2
            skey, sstart, sn, _ = calls[d * 4 + cell]
            check(sstart == start and sn == n, "10c: a shard's noise window")
            part = ka.ar_noise(skey, sstart, sn, s, bits=True)
            check(torch.equal(part.to(whole.device),
                              whole[i * per:(i + 1) * per]),
                  f"10c: shard {cell} of dispatch {d}: bits differ")
    # the kernel against its threefry twin on the first shard's inputs
    skey, sstart, sn, _ = calls[0]
    check(skey.shape[0] == per, f"10c: ar_noise on {skey.shape[0]} objects")
    shard_case = noise_case(skey, sstart, sn)
    db = db_error(mix, ref)
    check(db <= -60.0 and float(np.abs(ref).max()) > 0,
          f"10c: sustained span {db} dB vs unsharded")
    out = {"dragged": DRAGGED, "blocks": MESH_SUSTAINED_BLOCKS,
           "db_vs_unsharded": db, "noise_bits_bitwise_per_shard": True,
           "ar_noise_on_shard_inputs": shard_case, "launches": counts}
    print("mesh sustained span:", json.dumps(out), flush=True)
    return counts


def phase_mesh_engine(scene, lam64, rng) -> dict:
    """10d: StreamingEngine over the (2, 2) ShardedSession at lookahead=2,
    ~200 unpaced blocks of phase 7's event script; its first blocks
    against an offline render, its launches against its recorded
    events."""
    scene = dict(scene, engine_hits=[dict(h, when=None)
                                     for h in scene["hits"][:ENGINE_HITS]])
    sess = mesh_session(scene["bank"], (2, 2), ffat=scene["ffat"],
                        lam64=lam64, smooth=True)
    sess.set_listener(scene["listeners"])
    res = engine_stream("(10d) (2, 2) mesh, two-block spans", scene, lam64,
                        2, rng, session=sess, shards=4)
    offline = live_session(scene, hits=scene["engine_hits"]).render(
        ENGINE_COMPARED)
    db = db_error(res["audio"], offline)
    check(db <= -90.0, f"10d: the mesh stream {db} dB vs offline")
    print("mesh engine:", json.dumps({
        "db_first_blocks_vs_offline": db, "health": res["health_before_stop"],
        **{k: res["stats"][k] for k in ("p50_ms", "p95_ms", "p99_ms",
                                        "max_ms")}}), flush=True)
    return res["launches"]


def phase_mesh_scene(dirs, seed) -> dict:
    """10e: Scene(mesh=...) on (2, 2), binaural with ITD on phase 8's
    models, against the same Scene without a mesh, per block and by
    render_multi."""
    import torch
    from openpbso_tpu_torch.models import Scene
    from openpbso_tpu_torch.parallel import ShardedSession
    instances, _ = scene_instances(dirs, compress=False)
    kw = dict(block_size=S, binaural=True, itd=True, smooth_transfer=True)
    t = time.perf_counter()
    meshed = Scene(instances, mesh=mesh_of((2, 2)), **kw)
    build_s = time.perf_counter() - t
    plain = Scene(instances, **kw)
    check(isinstance(meshed.session, ShardedSession),
          "Scene(mesh=) built no ShardedSession")
    hits = scene_hits(np.random.default_rng(seed), instances)
    later = scene_hits(np.random.default_rng(seed + 1), instances,
                       future=False)
    out, counts = [], {}
    for name, sc in (("plain", plain), ("mesh", meshed)):
        sc.set_listener(SCENE_LISTENER)
        apply_hits(sc, hits)
        blocks = np.concatenate([sc.session.step()[1].cpu().numpy()
                                 for _ in range(SPATIAL_BLOCKS)])
        apply_hits(sc, later)
        reset_launches()
        span = sc.render_multi(SPATIAL_BLOCKS,
                               blocks_per_dispatch=SPAN_DISPATCH)
        counts[name] = read_launches()
        out.append((blocks, span))
    check(counts["mesh"] == {k: 4 * v for k, v in counts["plain"].items()}
          and counts["mesh"]["toeplitz_conv"] > 0,
          f"10e: launches {counts}")
    res = {"db_per_block": db_error(out[1][0], out[0][0]),
           "db_render_multi": db_error(out[1][1], out[0][1]),
           "mesh_scene_build_s": build_s, "launches": counts["mesh"]}
    check(float(np.abs(out[0][0]).max()) > 0 and res["db_per_block"] <= -90.0
          and res["db_render_multi"] <= -90.0, f"10e: {res}")
    del meshed, plain
    torch.cuda.empty_cache()
    print("mesh scene:", json.dumps(res), flush=True)
    return counts["mesh"]


def phase_mesh_checkpoint(scene) -> dict:
    """10f: save_session of a (2, 2) ShardedSession mid-drag, load_session
    into a fresh one: the next blocks bitwise."""
    from openpbso_tpu_torch.runtime.checkpoint import (load_session,
                                                       save_session)
    rng = np.random.default_rng(13)
    sess = mesh_session(scene["bank"], (2, 2), ffat=scene["ffat"],
                        smooth=True)
    sess.set_listener(scene["listeners"])
    for h in scene["hits"][:ENGINE_HITS]:
        sess.hit(h["obj"], h["space"], kind=h["kind"],
                 width_us=h["width_us"], amp=h["amp"])
    dragged = list(range(2, O, O // ENGINE_DRAGGED))[:ENGINE_DRAGGED]
    for o in dragged:
        sess.sustained_start(o, rng.standard_normal(M))
    sess.set_ar_params(dragged[0], a=(0.6, 0.2), sigma=0.003, mu=0.1)
    sess.render(8)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mesh.npz")
        save_session(path, sess)
        want = sess.render(CHECKPOINT_BLOCKS)
        del sess
        fresh = mesh_session(scene["bank"], (2, 2), ffat=scene["ffat"],
                             smooth=True)
        load_session(path, fresh)
    got = fresh.render(CHECKPOINT_BLOCKS)
    check(float(np.abs(want).max()) > 0 and np.array_equal(got, want),
          f"10f: restored render differs: {db_error(got, want)} dB")
    print("mesh checkpoint:", json.dumps({
        "blocks": CHECKPOINT_BLOCKS, "bitwise": True,
        "clock": fresh.sample_clock}), flush=True)
    return {}


def phase_mesh(scene, lam64, shared, shared_lam, dirs, seed) -> dict:
    """Phase 10; returns its launches per kernel."""
    import torch
    rng = np.random.default_rng(seed)
    launches = dict.fromkeys(KERNELS, 0)
    tables = {}     # the hetero span tables, built once (host float64)
    for counts in (phase_mesh_blocks(scene, MESHES),
                   phase_mesh_spans(scene, lam64, shared, shared_lam,
                                    MESHES, tables),
                   phase_mesh_sustained(scene, lam64, tables),
                   phase_mesh_engine(scene, lam64, rng),
                   phase_mesh_scene(dirs, seed),
                   phase_mesh_checkpoint(scene)):
        for k in counts:
            launches[k] += counts[k]
        torch.cuda.empty_cache()
    print("mesh launches:", json.dumps(launches), flush=True)
    return launches


def phase_dataset(seed) -> dict:
    """Phase 11: ml/'s synthesize_dataset on the card, six materials of
    DATASET_OBJECTS objects x M modes (a hetero bank each, stepped through
    fused_block), one material against the blocked form, the features of
    every clip, and the study where sklearn is installed."""
    import dataclasses
    from openpbso_tpu_torch.config import SAMPLE_RATE
    from openpbso_tpu_torch.ml import dataset, train
    from openpbso_tpu_torch.ops.forces import FORCE_GAUSSIAN, slot_duration
    kw = dict(objects_per_material=DATASET_OBJECTS,
              hits_per_object=DATASET_HITS, num_modes=M,
              seconds=DATASET_SECONDS, block=S, seed=seed)
    n_blocks = int(DATASET_SECONDS * SAMPLE_RATE) // S
    reset_launches()
    t = time.perf_counter()
    clips = dataset.synthesize_dataset(backend="auto", **kw)
    clips_s = time.perf_counter() - t
    counts = read_launches()
    mats = list(dataset.MATERIALS)
    check(len(clips) == len(mats) * DATASET_HITS * DATASET_OBJECTS
          and all(c.audio.shape == (n_blocks * S,) for c in clips),
          f"phase 11: {len(clips)} clips")
    audio = np.stack([c.audio for c in clips])
    check(bool(np.isfinite(audio).all())
          and bool((np.abs(audio).max(axis=1) > 0).all()),
          "phase 11: a clip is not finite or silent")
    # every hit is a gaussian of at most 300 us, whose slot expires inside
    # the batch's first block: one busy block (fused_block) a batch, the
    # rest ring down through the decay step
    longest = slot_duration(FORCE_GAUSSIAN, int(300e-6 * SAMPLE_RATE), S)
    check(longest <= S, f"a dataset hit lasts {longest} samples")
    want = dict.fromkeys(KERNELS, 0)
    want["fused_block"] = len(mats) * DATASET_HITS
    check(counts == want, f"phase 11: launches {counts} != {want}")
    first = mats[0]
    blocked = dataset.synthesize_dataset(
        materials={first: dataset.MATERIALS[first]}, backend="blocked",
        **kw)
    ours = np.stack([c.audio for c in clips if c.material == first])
    db = db_error(ours, np.stack([c.audio for c in blocked]))
    check(db <= -90.0, f"phase 11: {first} clips {db} dB vs blocked")
    t = time.perf_counter()
    x, y, labels = dataset.features_matrix(clips)
    features_s = time.perf_counter() - t
    check(x.shape[1] == 68 and x.shape[0] >= 0.9 * len(clips)
          and labels == sorted(mats),
          f"phase 11: features {x.shape} of {len(clips)} clips, {labels}")
    try:
        study = [dataclasses.asdict(r) for r in train.run_study(x, y)]
    except RuntimeError as e:
        check("scikit-learn" in str(e), f"phase 11: the study raised {e!r}")
        study = f"not run: {e} (sklearn is not installed here)"
    print(f"phase 11 study: {study}", flush=True)
    out = {"materials": len(mats), "objects": DATASET_OBJECTS,
           "modes": M, "hits": DATASET_HITS, "clips": len(clips),
           "clip_blocks": n_blocks, "clips_s": clips_s,
           "features_s": features_s, "feature_rows": int(x.shape[0]),
           "db_blocked_vs_fused": db,
           "launches": counts}
    print("dataset:", json.dumps(out), flush=True)
    return counts


def busy_state(bank, seed):
    """Phase 5's busy dispatch: a gaussian hit planted on every object in
    slot 0 (the one-slot bucket), a ringing start state."""
    import torch
    from openpbso_tpu_torch.ops.forces import FORCE_GAUSSIAN
    from openpbso_tpu_torch.runtime.state import make_solver_state
    dev, m = bank.device, bank.num_modes
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = make_solver_state(O, m, num_slots=8, device=dev)
    state.slots.ftype[:, 0] = FORCE_GAUSSIAN
    state.slots.width[:, 0] = 40.0
    state.slots.space[:, 0] = torch.randn((O, m), generator=gen, device=dev)
    state.z_re[:] = 1e-3 * torch.randn((O, m), generator=gen,
                                       device=dev) * bank.mask
    return state


@contextlib.contextmanager
def record_scans():
    """While open, a host copy of the arguments of every chunk_scan call
    the span module makes (the two-level scan's passes included; on the
    host, so that the copies add nothing to the card's peak memory)."""
    import torch
    from openpbso_tpu_torch.ops import span as span_mod
    calls = []
    original = span_mod.chunk_scan

    def recording(*args):
        calls.append([a.to("cpu", copy=True) if isinstance(a, torch.Tensor)
                      else a for a in args])
        return original(*args)
    span_mod.chunk_scan = recording
    try:
        yield calls
    finally:
        span_mod.chunk_scan = original


def form_dispatch(bank, tables, state, gains, n_blocks) -> dict:
    """The busy dispatch through ``tables``, and a ring-down span from the
    same start state (so that it holds decay_span alone, not the busy
    dispatch's difference carried on); the kernels' launches of the two
    and the peak memory above what was allocated before them."""
    import torch
    from openpbso_tpu_torch.runtime.solver import decay_span_step, step_span
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    st, mix = step_span(state, bank, tables, gains, n_blocks=n_blocks,
                        block_size=S, num_slots=1)
    dst, dmix = decay_span_step(state, bank, tables, gains,
                                n_blocks=n_blocks, block_size=S)
    torch.cuda.synchronize()
    return {"launches": read_launches(),
            "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
            "out": [t.cpu().numpy() for t in (mix, st.z_re, st.z_im, dmix,
                                              dst.z_re, dst.z_im)]}


def synced_ms(fn, runs=FORM_RUNS) -> float:
    """Median host ms of a synced call, after one warm call."""
    import torch
    times = []
    for i in range(runs + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i:
            times.append(1e3 * (time.perf_counter() - t))
    return statistics.median(times)


def phase_span_forms(label, bank, n_blocks, flat, forms, seed) -> tuple:
    """12a/12b: phase 5's busy dispatch and a ring-down through each form
    of ``forms`` (name -> (tables, the kernels' launches of the two
    dispatches)) against the flat single-level chunked form ``flat``:
    mix and state <= -90 dB, every chunk_scan call of the form bitwise its
    twin on its own inputs, the busy dispatch timed synced A B B A
    against flat, peak memory. Returns (summary, launches)."""
    import torch
    from openpbso_tpu_torch.config import SAMPLE_RATE
    from openpbso_tpu_torch.ops import chunk_scan as k1
    from openpbso_tpu_torch.runtime.solver import default_gains, step_span
    state = busy_state(bank, seed)
    gains = default_gains(O, device=bank.device)
    names = ("mix", "z_re", "z_im", "decay mix", "decay z_re",
             "decay z_im")
    ref = form_dispatch(bank, flat, state, gains, n_blocks)
    want = span_want(1, 1)
    check(ref["launches"] == want,
          f"12 {label} flat: launches {ref['launches']} != {want}")
    check(bool(np.isfinite(ref["out"][0]).all())
          and float(np.abs(ref["out"][0]).max()) > 0,
          f"12 {label} flat: mix not finite or silent")
    launches = dict(ref["launches"])
    out = {"n_blocks": n_blocks, "N": n_blocks * S,
           "flat": {"n_chunks": flat.n_chunks, "chunk": flat.chunk,
                    "peak_gb": ref["peak_gb"]}}

    def busy(tables):
        return lambda: step_span(state, bank, tables, gains,
                                 n_blocks=n_blocks, block_size=S,
                                 num_slots=1)[1]
    for name, (tables, want) in forms.items():
        with record_scans() as scans:
            got = form_dispatch(bank, tables, state, gains, n_blocks)
        want = dict(dict.fromkeys(KERNELS, 0), **want)
        check(got["launches"] == want,
              f"12 {label} {name}: launches {got['launches']} != {want}")
        check(len(scans) == want["chunk_scan"],
              f"12 {label} {name}: {len(scans)} chunk_scan calls")
        for k in KERNELS:
            launches[k] += got["launches"][k]
        dbs = {n: db_error(g, r) for n, g, r in zip(names, got["out"],
                                                    ref["out"])}
        check(max(dbs.values()) <= -90.0,
              f"12 {label} {name}: {dbs} dB against flat")
        scan_shapes = []
        for args in scans:
            args = [a.to(bank.device) if isinstance(a, torch.Tensor) else a
                    for a in args]
            k, p = k1.chunk_scan(*args), k1.chunk_scan_reference(*args)
            check(all(torch.equal(a, b) for a, b in zip(k, p)),
                  f"12 {label} {name}: chunk_scan not bitwise its twin on "
                  f"the inputs of {list(args[0].shape)} x {args[4]}")
            scan_shapes.append([list(args[0].shape), args[4],
                                args[5] is None])
        del scans
        a1, b1, b2, a2 = (synced_ms(busy(t)) for t in (flat, tables, tables,
                                                       flat))
        out[name] = {"db_vs_flat": dbs, "peak_gb": got["peak_gb"],
                     "launches": got["launches"],
                     "chunk_scan_calls_bitwise": scan_shapes,
                     "flat_ms": [a1, a2], "ms": [b1, b2],
                     "rtf": n_blocks * S / SAMPLE_RATE / (
                         1e-3 * statistics.mean([b1, b2]))}
        print(f"span form {label} {name}: {json.dumps(out[name])}",
              flush=True)
    return out, launches


def phase_forms_shared(bank, lam64, seed) -> tuple:
    """12a: shared 256x1024 at 512 blocks (N = 262144): the default
    chunked tables (superchunk X = 512, G = 32), factored (R = 512, X =
    512) and full ([M, N+1]) against flat."""
    import dataclasses
    import torch
    from openpbso_tpu_torch.ops.span import build_span_tables, with_planes
    n_blocks, m, dev = SPAN_CASES[0][1], bank.num_modes, bank.device
    builds = {}
    tables = {}
    for form in ("auto", "factored", "full"):
        t = time.perf_counter()
        tables[form] = build_span_tables(lam64, n_blocks * S, num_modes=m,
                                         device=dev, form=form)
        builds[form] = time.perf_counter() - t
    default = with_planes(tables["auto"])   # as a session's tables
    check((default.chunk, default.n_chunks, default.superchunk)
          == (512, 512, 32), "12a: the default tables are not C=512 X=512 "
          f"G=32 ({default.chunk}, {default.n_chunks}, "
          f"{default.superchunk})")
    check((tables["factored"].radix, tables["factored"].big_steps)
          == (512, 512) and tables["full"].p_re.shape == (m, n_blocks * S
                                                           + 1),
          "12a: factored or full tables of another shape")
    flat = dataclasses.replace(default, s_re=None, s_im=None)
    scan2 = span_want(1, 1)
    out, launches = phase_span_forms("shared", bank, n_blocks, flat, {
        "superchunk": (default, scan2), "factored": (tables["factored"], {}),
        "full": (tables["full"], {})}, seed)
    out["table_build_s"] = builds
    del tables, default, flat
    torch.cuda.empty_cache()
    return out, launches


def phase_forms_hetero(bank, lam64, baby, seed) -> tuple:
    """12b: hetero 256x1024 at 64 blocks (N = 32768, C = R = 512, X = 64):
    factored and the opt-in superchunk tables (G = 32: passes A and C and
    the group scan through chunk_scan) against flat. ``baby``: phase 5's
    hetero chunk tables (C = 512), whose baby table every form here
    shares; the superchunk and giant powers are built alone and held
    bitwise against build_span_tables on the first objects."""
    import dataclasses
    import torch
    from openpbso_tpu_torch.ops.span import (ChunkSpanTables, SpanTables,
                                             build_span_tables, power_rows)
    n_blocks, m, dev = LONG_SPAN_BLOCKS, bank.num_modes, bank.device
    c = baby.chunk
    x = n_blocks * S // c
    check((c, x) == (512, 64), f"12b: C={c} X={x}")
    t = time.perf_counter()
    lam = np.pad(lam64, ((0, 0), (0, m - lam64.shape[1])))
    s_re, s_im = power_rows(lam, np.arange(33) * c, torch.float32, dev)
    a_re, a_im = power_rows(lam, np.arange(x + 1) * c, torch.float32, dev)
    build_s = time.perf_counter() - t
    few = 4
    for form, kw, rows in (
            ("chunked", dict(hetero_superchunk=True), (s_re, s_im)),
            ("factored", {}, (a_re, a_im))):
        ref = build_span_tables(lam64[:few], n_blocks * S, radix=c,
                                num_modes=m, device=dev, form=form,
                                shared=False, **kw)
        want = (ref.s_re, ref.s_im) if form == "chunked" else (ref.a_re,
                                                               ref.a_im)
        check(all(torch.equal(r[:few], w) for r, w in zip(rows, want))
              and torch.equal(baby.b_re[:few], ref.b_re),
              f"12b: the {form} powers differ from build_span_tables'")
    flat = dataclasses.replace(baby, n_chunks=x)
    superchunk = ChunkSpanTables(b_re=baby.b_re, b_im=baby.b_im,
                                 n_chunks=x, s_re=s_re, s_im=s_im,
                                 planes=baby.planes)
    factored = SpanTables(a_re=a_re, a_im=a_im, b_re=baby.b_re,
                          b_im=baby.b_im)
    check(superchunk.superchunk == 32 and factored.span == n_blocks * S,
          "12b: table shapes")
    out, launches = phase_span_forms("hetero", bank, n_blocks, flat, {
        "superchunk": (superchunk, dict(span_want(1, 1), chunk_scan=4)),
        "factored": (factored, {})}, seed)
    out["powers_build_s"] = build_s
    del superchunk, factored, flat, s_re, s_im, a_re, a_im
    torch.cuda.empty_cache()
    return out, launches


def phase_forms_mesh(scene, shared, shared_lam) -> tuple:
    """12c: a shared span of 64 chunks through build_span_tables' default
    superchunk tables (put in the sessions' caches: a session builds the
    flat form), on a (2, 2) mesh of cuda:0 cells (the powers split on the
    mode axis) against the unsharded session, <= -90 dB: two dispatches
    of 64 blocks."""
    from openpbso_tpu_torch.ops.span import build_span_tables
    from openpbso_tpu_torch.parallel import sharding
    rng = np.random.default_rng(12)
    hits = hit_script(rng, O, M, S)
    n_dispatch = 2
    ref_sess = new_session(shared, None, scene["listeners"], hits,
                           "blocked", lam64=shared_lam)
    ref_sess._span_cache[512] = build_span_tables(
        shared_lam, LONG_SPAN_BLOCKS * S, num_modes=shared.num_modes,
        device=shared.device)
    reset_launches()
    ref = ref_sess.render_multi(n_dispatch * LONG_SPAN_BLOCKS,
                                blocks_per_dispatch=LONG_SPAN_BLOCKS)
    ref_counts = read_launches()
    tables = ref_sess.span_tables_for(LONG_SPAN_BLOCKS)
    check(tables.superchunk == 32 and ref_counts["chunk_scan"] == n_dispatch,
          f"12c: unsharded G={tables.superchunk}, launches {ref_counts}")
    sess = mesh_session(shared, (2, 2), lam64=shared_lam,
                        tables_from=ref_sess, one_card=True)
    sess.set_listener(scene["listeners"])
    for h in hits:
        sess.hit(h["obj"], h["space"], kind=h["kind"], width_us=h["width_us"],
                 amp=h["amp"], when=h["when"])
    reset_launches()
    sharding.REDUCTIONS = 0
    mix = sess.render_multi(n_dispatch * LONG_SPAN_BLOCKS,
                            blocks_per_dispatch=LONG_SPAN_BLOCKS)
    counts = read_launches()
    want = {k: 4 * ref_counts[k] for k in KERNELS}
    check(counts == want, f"12c: launches {counts} != {want}")
    check(sharding.REDUCTIONS == n_dispatch,
          f"12c: {sharding.REDUCTIONS} reductions")
    (key, grid), = sess._sharded_tables.items()
    check(key == 512 and tuple(grid[1][1].s_re.shape)
          == (1, 33, shared.num_modes // 2),
          f"12c: sharded tables {key} {tuple(grid[1][1].s_re.shape)}")
    db = db_error(mix, ref)
    check(db <= -90.0 and float(np.abs(ref).max()) > 0,
          f"12c: {db} dB against unsharded")
    out = {"db_vs_unsharded": db, "launches": counts,
           "reductions": n_dispatch, "chunk": key,
           "superchunk": grid[1][1].superchunk}
    print("span forms mesh:", json.dumps(out), flush=True)
    return out, counts


def phase_native(dirs, mix) -> dict:
    """12d: the native decoder on phase 8's model directories (every map
    bitwise the Python codec's, no fallback), its bulk load timed A B B A
    against the Python codec's, load_model once, and a producer and a
    consumer thread passing 10^4 blocks of a [512, 2] mix through
    NativeSpscRing in order and whole."""
    from openpbso_tpu_torch.io.fatcube import (decode_fatcube,
                                               load_all_fatcubes,
                                               maps_match_bits)
    from openpbso_tpu_torch.io.meta import resolve_model_dir
    from openpbso_tpu_torch.models import load_model
    from openpbso_tpu_torch.native import bindings
    lib = bindings.load_native()
    check(lib is not None, f"native library: {bindings.build_error}")
    check(os.path.dirname(os.path.realpath(lib._name))
          == os.path.realpath(bindings.BUILD_DIR),
          f"native library loaded from {lib._name}")
    paths = [resolve_model_dir(d, "m") for d in dirs]
    n_maps = 0
    t = time.perf_counter()
    for p in paths:
        names = sorted(n for n in os.listdir(p.ffat_dir)
                       if n.endswith(".fatcube"))
        for name in names:
            with open(os.path.join(p.ffat_dir, name), "rb") as fh:
                data = fh.read()
            got = bindings.native_decode_fatcube(data)
            check(got is not None, f"12d: {name} fell back to the codec")
            check(maps_match_bits(got, decode_fatcube(data)),
                  f"12d: {name} differs from the Python codec's")
        n_maps += len(names)
    check(n_maps == len(dirs) * M, f"12d: {n_maps} maps")
    check_s = time.perf_counter() - t

    def load_all(fn):
        t = time.perf_counter()
        for p in paths:
            fn(p.ffat_dir)
        return time.perf_counter() - t
    a1, b1, b2, a2 = (load_all(f) for f in (
        load_all_fatcubes, bindings.load_all_fatcubes_native,
        bindings.load_all_fatcubes_native, load_all_fatcubes))
    t = time.perf_counter()
    model = load_model(paths[0])
    load_s = time.perf_counter() - t
    check(len(model.ffat_maps) == M, "12d: load_model's maps")

    block = np.ascontiguousarray(mix[:S], np.float32)
    ring = bindings.NativeSpscRing(8, block.shape)
    n = 10 ** 4
    received, bad = [], []

    def produce():
        i = 0
        while i < n:
            if ring.try_push(block + np.float32(i)):
                i += 1

    def consume():
        while len(received) < n:
            got = ring.try_pop()
            if got is not None:
                if not np.array_equal(got, block + np.float32(len(received))):
                    bad.append(len(received))
                received.append(got[0, 0])
    threads = [threading.Thread(target=f) for f in (produce, consume)]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
    ring_s = time.perf_counter() - t
    check(len(received) == n and not bad and ring.dropped == 0,
          f"12d: ring passed {len(received)} blocks, {len(bad)} wrong")
    out = {"maps": n_maps, "decode_check_s": check_s,
           "codec_s": [a1, a2], "native_s": [b1, b2],
           "load_model_s": load_s, "ring_blocks": n, "ring_s": ring_s}
    print("native:", json.dumps(out), flush=True)
    return out


def phase_span_forms_all(scene, hetero, modes, shared, shared_lam, baby,
                         dirs, seed) -> dict:
    """Phase 12; returns its launches per kernel."""
    import torch
    launches = dict.fromkeys(KERNELS, 0)
    shared_out, counts_a = phase_forms_shared(shared, shared_lam, seed)
    hetero_out, counts_b = phase_forms_hetero(hetero, modes, baby, seed + 1)
    print("span forms tables:", json.dumps({
        "shared_build_s": shared_out["table_build_s"],
        "hetero_powers_build_s": hetero_out["powers_build_s"]}), flush=True)
    _, counts_c = phase_forms_mesh(scene, shared, shared_lam)
    for counts in (counts_a, counts_b, counts_c):
        for k in counts:
            launches[k] += counts[k]
    torch.cuda.empty_cache()
    phase_native(dirs, scene["mix"])
    print("span forms launches:", json.dumps(launches), flush=True)
    return launches


def contraction_inputs(tables, k, nl, cplx, seed,
                       kinds=("span_inject", "g", "hom")) -> dict:
    """A busy span's contraction inputs at ``tables``' shape, made on the
    card from a seed: span_inject's (f [O, K, N], b e_k) and span_reduce's
    for g (transfer rows, complex with ``cplx``, against b e_k) and for hom
    (against chunk starts [O, X, M], the conv added), each with the
    tables' planes, as the span module passes them; those of ``kinds``."""
    import torch
    dev = tables.b_re.device
    c, x, m = tables.chunk, tables.n_chunks, tables.b_re.shape[-1]
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    be = (randn(O, k, m), randn(O, k, m))
    t = (randn(O, nl, m), randn(O, nl, m) if cplx else None)
    tbl = (tables.b_re, tables.b_im)
    check(tables.planes is not None, "13: tables without their planes")
    make = {"span_inject": lambda: (randn(O, k, x * c), *be, *tbl,
                                    tables.planes),
            "g": lambda: (*t, *be, *tbl, 0, None, tables.planes),
            "hom": lambda: (*t, randn(O, x, m), randn(O, x, m), *tbl, 1,
                            randn(O, nl, x, c), tables.planes)}
    return {kind: make[kind]() for kind in kinds}


def library_call(kind, args):
    """The cuBLAS SGEMM pair of a contraction as one PyTorch matrix
    product, the yardstick (never called by the port): chunk rows @
    [b_re | b_im] for span_inject, [w_pr | w_pi] @ [b_re; b_im] for
    span_reduce, its operands made ahead (the weights' shape, from v)."""
    import torch
    if kind == "span_inject":
        f, _, _, b_re, b_im = args[:5]
        o, k, n = f.shape
        c = b_re.shape[1] - 1
        rows = f.reshape(o, k * n // c, c)
        tbl = torch.cat([b_re[:, :c], b_im[:, :c]], dim=-1)   # [Og, C, 2M]
        if tbl.shape[0] == 1:
            rows2, tbl0 = rows.reshape(-1, c), tbl[0]
            return lambda: rows2 @ tbl0
        return lambda: torch.bmm(rows, tbl)
    t_re, _, v_re, _, b_re, b_im, off = args[:7]
    m = v_re.shape[-1]
    c = b_re.shape[1] - 1
    w = torch.cat([v_re.repeat(1, t_re.shape[1], 1)] * 2, dim=-1)
    tbl = torch.cat([b_re[:, off:off + c], b_im[:, off:off + c]],
                    dim=-1).transpose(1, 2)                  # [Og, 2M, C]
    if tbl.shape[0] == 1:
        w2, tbl0 = w.reshape(-1, 2 * m), tbl[0]
        return lambda: w2 @ tbl0
    return lambda: torch.bmm(w, tbl)


def contraction_timing(label, kind, args, want=None) -> dict:
    """Phase 13 for one kernel call: contraction_case, the variant
    variant_for picks (``want`` when given), then CUDA-event and profiler
    times beside the twin's, the SGEMM pair's and the bound
    (bench/roofline.py)."""
    import torch
    from openpbso_tpu_torch.bench import roofline
    from openpbso_tpu_torch.bench.toeplitz_ab import chain_ms
    from openpbso_tpu_torch.ops import span_inject as k3
    from openpbso_tpu_torch.ops import span_reduce as k4
    name = "span_inject" if kind == "span_inject" else "span_reduce"
    out = contraction_case(f"{label}, {kind}", name, args)
    kernel, twin = contraction_call(name)
    if name == "span_inject":
        f, _, _, b_re, _ = args[:5]
        o, k, n = f.shape
        c, m, og = b_re.shape[1] - 1, b_re.shape[-1], b_re.shape[0]
        bound = roofline.span_inject(o, og, k, n // c, c, m)
        out["variant"] = k3.variant_for(o, k, n // c, c, m, og)
    else:
        t_re, t_im, v_re, _, b_re, _, _, add = args[:8]
        o, nl, m = t_re.shape
        c, og = b_re.shape[1] - 1, b_re.shape[0]
        bound = roofline.span_reduce(o, og, nl, v_re.shape[1], c, m,
                                     add is not None, cplx=t_im is not None)
        out["variant"] = k4.variant_for(o, nl, v_re.shape[1], c, m, og)
    check(want is None or out["variant"] == want,
          f"{name} ({label}, {kind}) routed to {out['variant']}, not {want}")
    out["ms"] = chain_ms(lambda: kernel(*args))
    out["enqueue_ms"] = enqueue_ms(lambda: kernel(*args))
    out.update(device_times(lambda: kernel(*args), name, bound, out["ms"]))
    out["plain_ms"] = time_ms(lambda: twin(*args), runs=10)
    call = library_call(kind, args)
    out["library_ms"] = chain_ms(call)
    del call
    torch.cuda.empty_cache()
    out.update(bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
               share_bound=bound["bound_ms"] / out["device_ms"],
               share_bound_events=bound["bound_ms"] / out["ms"],
               tflops=bound["flops"] / out["device_ms"] / 1e9)
    print("contraction case:", json.dumps(out), flush=True)
    return out


@contextlib.contextmanager
def twin_contractions():
    """While open, the span module calls span_inject's and span_reduce's
    plain twins (the stage code the kernels replace), on the card too."""
    from openpbso_tpu_torch.ops import span as span_mod
    originals = span_mod.span_inject, span_mod.span_reduce
    span_mod.span_inject = contraction_call("span_inject")[1]
    span_mod.span_reduce = contraction_call("span_reduce")[1]
    try:
        yield
    finally:
        span_mod.span_inject, span_mod.span_reduce = originals


def dispatch_ab(label, bank, tables, n_blocks, seed) -> dict:
    """Phase 5's busy dispatch through the twin-composed stages and the
    kernels, synced, A B B A (twin, kernels, kernels, twin); the two mixes
    and end states agree to <= -90 dB."""
    from openpbso_tpu_torch.ops import span as span_mod
    from openpbso_tpu_torch.runtime.solver import default_gains, step_span
    state = busy_state(bank, seed)
    gains = default_gains(O, device=bank.device)
    builds = span_mod.PLANE_BUILDS

    def busy():
        return step_span(state, bank, tables, gains, n_blocks=n_blocks,
                         block_size=S, num_slots=1)

    def twin():
        with twin_contractions():
            return busy()
    outs = []
    for fn in (busy, twin):
        st, mix = fn()
        outs.append([x.cpu().numpy() for x in (mix, st.z_re, st.z_im)])
    dbs = [db_error(a, b) for a, b in zip(*outs)]
    check(max(dbs) <= -90.0 and float(np.abs(outs[1][0]).max()) > 0,
          f"13 {label}: kernels vs twins {dbs} dB")
    a1, b1, b2, a2 = (synced_ms(fn) for fn in (twin, busy, busy, twin))
    check(span_mod.PLANE_BUILDS == builds,
          f"13 {label}: the dispatches built planes of cached tables")
    out = {"case": label, "n_blocks": n_blocks, "db_mix_state": dbs,
           "twin_ms": [a1, a2], "kernel_ms": [b1, b2]}
    print("contraction dispatch:", json.dumps(out), flush=True)
    return out


# phase 13's grid of g on a shared table: chunks C (the one- and
# four-block spans' 64 and 256, nb=512's 512), slots K (one; a full bucket
# and the AR channel) and listener rows L (one real; a binaural ITD
# scene's two complex rows), each with the variant variant_for must pick
# at 256 x 1024 (ops/span_reduce.py::CLUSTER_ROUTE)
SHARED_G_WANT = {
    (64, 1, 1): "cluster", (64, 1, 2): "cluster", (64, 17, 1): "mma16",
    (64, 17, 2): "mma16", (256, 1, 1): "cluster", (256, 1, 2): "cluster",
    (256, 17, 1): "mma16", (256, 17, 2): "wgmma", (512, 1, 1): "cluster",
    (512, 1, 2): "cluster", (512, 17, 1): "wgmma", (512, 17, 2): "wgmma"}
# the live stream's spans (lookahead 1 and 4, X = 8 chunks of a
# per-object table): blocks, chunk, slots (17: a full bucket and the AR
# channel, the rattle streams'; 1: the plain streams') and toeplitz_conv's
# variant
SHORT_SPANS = {"one-block span, full bucket + AR": (1, 64, 17, "short"),
               "four-block span, full bucket + AR": (4, 256, 17, "short"),
               "one-block span, plain (K = 1)": (1, 64, 1, "v3"),
               "four-block span, plain (K = 1)": (4, 256, 1, "v3")}


def phase_contractions(hetero, lam64, shared, shared_lam, shared_tables,
                       hetero_tables, seed) -> dict:
    """Phase 13: span_inject and span_reduce (g, hom) at the main path's
    shapes, each against its twin and timed beside it, its SGEMM pair and
    its bound; g on a shared table at SHARED_G_WANT's grid; toeplitz_conv
    at the one- and four-block spans' shapes (SHORT_SPANS) beside conv1d,
    a matmul on the materialised operand and its bound; each case's
    variant gated; the whole busy dispatch twin-composed against the
    kernels, A B B A; 7d's engine p50/p99 as they stand. Returns the
    shared nb=512 entries (the kernels line's)."""
    import torch
    render_span = session_span_tables(hetero, lam64, SPAN_DISPATCH)
    built = {"shared nb=512": (shared_tables, 1, 1, False),
             "hetero nb=1024": (hetero_tables, 1, 1, False),
             "hetero nb=16 (5b's spans)": (render_span, 1, 1, False)}
    out = {}
    for i, (label, (tables, k, nl, cplx)) in enumerate(built.items()):
        inputs = contraction_inputs(tables, k, nl, cplx, seed + i)
        out[label] = {kind: contraction_timing(label, kind, args)
                      for kind, args in inputs.items()}
        del inputs
        torch.cuda.empty_cache()
    seed += len(built)
    shared_chunks = {c: session_span_tables(shared, shared_lam, n_blocks)
                     for c, n_blocks in ((64, 1), (256, 4))}
    shared_chunks[512] = shared_tables
    for i, ((c, k, nl), want) in enumerate(SHARED_G_WANT.items()):
        tables = shared_chunks[c]
        check(tables.shared and tables.chunk == c,
              f"13: shared tables of C={tables.chunk}, not {c}")
        label = (f"shared g, C = {c}, K = {k}, L = {nl}"
                 + (" complex" if nl == 2 else ""))
        args = contraction_inputs(tables, k, nl, nl == 2, seed + i,
                                  kinds=("g",))["g"]
        out[label] = {"g": contraction_timing(label, "g", args, want)}
        del args
        torch.cuda.empty_cache()
    del shared_chunks
    seed += len(SHARED_G_WANT)
    gen = torch.Generator(device=hetero.device).manual_seed(seed)
    for i, (label, (n_blocks, chunk, k, conv)) in enumerate(
            SHORT_SPANS.items()):
        tables = session_span_tables(hetero, lam64, n_blocks)
        check((tables.chunk, tables.n_chunks) == (chunk, 8),
              f"13: {label} tables C={tables.chunk} X={tables.n_chunks}")
        inputs = contraction_inputs(tables, k, 1, False, seed + i)
        out[label] = {kind: contraction_timing(label, kind, args)
                      for kind, args in inputs.items()}
        g, f = (torch.randn(shape, generator=gen, device=hetero.device)
                for shape in ((O, 1, k, chunk), (O, k, 8, chunk)))
        out[label]["toeplitz_conv"] = toeplitz_case(f"13 {label}", g, f,
                                                    want=conv)
        del inputs, tables, g, f
        torch.cuda.empty_cache()
    for label, inputs in CONTRACTION_INPUTS.items():
        out[label] = {kind: contraction_timing(label, kind, args)
                      for kind, args in inputs.items()}
    CONTRACTION_INPUTS.clear()
    torch.cuda.empty_cache()
    for label, row in out.items():
        for kind, e in row.items():
            print(f"13 share: {label}, {kind} ({e.get('variant', 'conv')}): "
                  f"events {e['ms']} ms (chained), device {e['device_ms']} "
                  f"ms ({e['device_from']}), "
                  f"library {e['library_ms']} ms, bound {e['bound_ms']} ms "
                  f"({e['bound_by']}), share {e['bound_ms'] / e['ms']:.3f} "
                  f"events, {e['bound_ms'] / e['device_ms']:.3f} device",
                  flush=True)
    dispatch = [dispatch_ab("shared nb=512", shared, shared_tables,
                            SPAN_CASES[0][1], seed),
                dispatch_ab("hetero nb=1024", hetero, hetero_tables,
                            SPAN_CASES[1][1], seed),
                dispatch_ab("hetero nb=16", hetero, render_span,
                            SPAN_DISPATCH, seed)]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print("contractions:", json.dumps({
        "card": smi, "dispatch_ab": dispatch, "engine_7d": ENGINE_STATS,
        "ms": {label: {kind: e["ms"] for kind, e in v.items()}
               for label, v in out.items()},
        "variant": {label: {kind: e.get("variant", "conv")
                            for kind, e in v.items()}
                    for label, v in out.items()}}), flush=True)
    head = out["shared nb=512"]
    return {"span_inject": head["span_inject"], "span_reduce": head["hom"]}


def kernel_bounds(hetero_modes_padded, shared_modes_padded, n_chunks,
                  chunk):
    """Each kernel's bound (bench/roofline.py) at the shape its JSON entry
    was timed at: fused_block phase 3's hetero block, chunk_scan,
    toeplitz_conv, span_inject and span_reduce (hom) the shared nb=512
    span, ar_noise [O, 512, S] and ar_block
    O objects. The AR kernels' operations are the instructions per sample
    of ar_noise's main loop in the built library's SASS
    (bench/sass_count.py), at the card's maximum SM clock."""
    from openpbso_tpu_torch.bench import roofline, sass_count
    from openpbso_tpu_torch.ops import _build
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0]
    clock_hz = float(clock) * 1e6
    per_sample = sass_count.count(_build.library_path(),
                                  "ar_noise_kernelILb0E")["by_class_per_item"]
    out = {
        "fused_block": roofline.fused_block(O, O, hetero_modes_padded, S,
                                            CHUNK),
        "chunk_scan": roofline.chunk_scan(O, 1, n_chunks,
                                          shared_modes_padded, True),
        "toeplitz_conv": roofline.toeplitz_conv(O, 1, 1, n_chunks, chunk),
        "ar_noise": roofline.ar_noise(O, SUS_SPAN_BLOCKS, S, per_sample,
                                      clock_hz),
        "ar_block": roofline.ar_block(O, S, per_sample, clock_hz),
        "span_inject": roofline.span_inject(O, 1, 1, n_chunks, chunk,
                                            shared_modes_padded),
        "span_reduce": roofline.span_reduce(O, 1, 1, n_chunks, chunk,
                                            shared_modes_padded, True),
    }
    print("kernel bounds:", json.dumps(dict(
        out, sm_clock_hz=clock_hz, ar_noise_sass_per_sample=per_sample)),
          flush=True)
    return out


@contextlib.contextmanager
def phase_clock(name, seconds):
    t = time.perf_counter()
    yield
    seconds[name] = time.perf_counter() - t
    print(f"phase {name}: {seconds[name]} s", flush=True)


def run_phases(args, model_pool, model_futures) -> int:
    """Phases 3-12, the bounds and the closing lines."""
    import torch
    seconds = {}
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    t = time.perf_counter()
    modes = hetero_modes(O, M)
    hetero = hetero_bank(O, M, S, None, modes)   # the builders' default
    check(hetero.device.type == "cuda",
          f"a bank built without device= is on {hetero.device}")
    print(f"hetero bank {O}x{hetero.num_modes}: "
          f"{time.perf_counter() - t} s", flush=True)

    with phase_clock("3", seconds):
        prod = kernel_case("hetero", hetero, S, CHUNK, rng, timed=True)
        shared = shared_bank(O, M, S, dev)
        kernel_case("shared", shared, S, CHUNK, rng, timed=True)
        kernel_case("ragged", hetero_bank(5, 40, 256, dev), 256, CHUNK, rng)
        kernel_case("chunk>S", hetero_bank(3, 24, 32, dev), 32, CHUNK, rng)

    with phase_clock("4", seconds):
        per_block = phase_session(session_scene(hetero, rng))

    from openpbso_tpu_torch.ops.coeffs import lambda_from_modes
    mat, omega_squared = shared_modes(M)
    shared_lam = lambda_from_modes(mat.density, omega_squared, mat.alpha,
                                   mat.beta)[0]
    with phase_clock("5", seconds):
        span_cases = {}
        for i, (name, n_blocks) in enumerate(SPAN_CASES):
            bank, lam = ((shared, shared_lam) if name == "shared"
                         else (hetero, modes[0]))
            span_cases[name] = span_kernel_case(name, bank, lam, n_blocks,
                                                args.seed + i)
        span_launches = phase_span_session(hetero, modes[0], per_block)
        phase_toeplitz_shapes(args.seed, dev)

    with phase_clock("6", seconds):
        ar = phase_ar_kernels(args.seed, dev)
        phase_sustained_span(shared, shared_lam, args.seed)
        drag_launches = phase_sustained_session(hetero, modes[0], per_block)

    with phase_clock("8 (models written)", seconds):
        model_dirs = [f.result() for f in model_futures]
        model_pool.shutdown(wait=True)   # no worker alive in the live phases
    with phase_clock("7", seconds):
        live_launches = phase_live(per_block, modes[0], rng)
    with phase_clock("8", seconds):
        spatial_launches = phase_spatial(model_dirs, args.seed)
    with phase_clock("9", seconds):
        served_launches = phase_served(model_dirs, per_block, modes,
                                       args.seed + 9)
    torch.cuda.empty_cache()
    with phase_clock("10", seconds):
        mesh_launches = phase_mesh(per_block, modes[0], shared, shared_lam,
                                   model_dirs, args.seed + 10)
    with phase_clock("11", seconds):
        dataset_launches = phase_dataset(args.seed + 11)
    torch.cuda.empty_cache()
    hetero_tables = span_cases["hetero"].pop("tables")
    with phase_clock("12", seconds):
        forms_launches = phase_span_forms_all(
            per_block, hetero, modes[0], shared, shared_lam, hetero_tables,
            model_dirs, args.seed + 12)
    torch.cuda.empty_cache()
    with phase_clock("13", seconds):
        contractions = phase_contractions(
            hetero, modes[0], shared, shared_lam,
            span_cases["shared"].pop("tables"), hetero_tables,
            args.seed + 13)
    del hetero_tables

    head = span_cases[SPAN_CASES[0][0]]
    bounds = kernel_bounds(hetero.num_modes, shared.num_modes,
                           head["n_chunks"], head["chunk"])
    # launches: each kernel's count on its render's path (phases 4, 5b,
    # 6c) plus the engine streams' (7d), the spatial path's (8b, 8c, 8e,
    # 8f), the served path's (9a-9b's streams, 9c's bakes), the meshes'
    # (10a-10e's sharded runs), the dataset's (11) and the span forms'
    # (12a-12c's dispatches), each read around its own run
    kernels = [dict(name="fused_block", launches=per_block["launches"],
                    max_abs_err=prod["max_abs_err"], ms=prod["kernel_ms"],
                    device_ms=prod["device_ms"], plain_ms=prod["plain_ms"],
                    library_ms=None)]
    kernels += [dict(name=k, launches=span_launches[k],
                     max_abs_err=head[k]["max_abs_err"], ms=head[k]["ms"],
                     device_ms=head[k]["device_ms"],
                     plain_ms=head[k]["plain_ms"],
                     library_ms=head[k].get("library_ms"))
                for k in ("chunk_scan", "toeplitz_conv")]
    kernels += [dict(name=k, launches=drag_launches[path][k],
                     max_abs_err=ar[k]["max_abs_err"], ms=ar[k]["ms"],
                     device_ms=ar[k]["device_ms"],
                     plain_ms=ar[k]["plain_ms"], library_ms=None)
                for k, path in (("ar_noise", "span"), ("ar_block", "block"))]
    kernels += [dict(name=k, launches=span_launches[k],
                     **{key: contractions[k][key] for key in (
                         "max_abs_err", "ms", "device_ms", "plain_ms",
                         "library_ms")})
                for k in ("span_inject", "span_reduce")]
    for k in kernels:
        k["launches"] += (live_launches[k["name"]]
                          + spatial_launches[k["name"]]
                          + served_launches[k["name"]]
                          + mesh_launches[k["name"]]
                          + dataset_launches[k["name"]]
                          + forms_launches[k["name"]])
        k.update(route="cuda", source=KERNELS[k["name"]][0],
                 replaces=KERNELS[k["name"]][1],
                 bound_ms=bounds[k["name"]]["bound_ms"],
                 bound_by=bounds[k["name"]]["bound_by"])
    print("phase seconds:", json.dumps(seconds), flush=True)
    print("device time: " + ", ".join(
        f"{k['name']} {k['device_ms']} ms (events {k['ms']} ms)"
        for k in kernels), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "an NVIDIA GPU (no CPU fallback)", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    from openpbso_tpu_torch.ops import _build
    t = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t} s ({_build.library_path()})",
          flush=True)
    if _build.build_log:
        print(_build.build_log.strip(), flush=True)

    # phase 8's model directories are written by worker processes while
    # phases 3-6 run, and waited for before the live phases
    models_root = tempfile.mkdtemp(prefix="chip_smoke_models_")
    pool, futures = start_scene_models(models_root, args.seed)
    try:
        return run_phases(args, pool, futures)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        shutil.rmtree(models_root, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
