"""The port's command-line apps (openpbso_tpu_torch.apps) against
openpbso_tpu/apps: the flag surface of every app (only ``--platform`` ->
``--device`` differs), the offline renders and the field exports, the
served Scene from assets/demo/scene.json in lockstep (<= -100 dB), the
CLI end to end in a subprocess on the CPU, and the numpy-only tools
(softrender, assemble_movie, fetch_dataset) bitwise or on the same
inputs. Nothing here needs the network.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from openpbso_tpu.apps import assemble_movie as j_movie
from openpbso_tpu.apps import fetch_dataset as j_fetch
from openpbso_tpu.apps import real_time_modal_sound as j_rt
from openpbso_tpu.apps import render_fields as j_fields
from openpbso_tpu.apps import render_offline as j_offline
from openpbso_tpu.apps import render_timeline as j_timeline
from openpbso_tpu.apps import serve as j_serve
from openpbso_tpu.apps import softrender as j_soft
from openpbso_tpu.io.meta import resolve_model_dir as j_resolve
from openpbso_tpu.models.modal_model import load_model as j_load_model
from openpbso_tpu.runtime import engine as j_engine_mod
from openpbso_tpu.runtime import server as jserver
from openpbso_tpu_torch.apps import assemble_movie as t_movie
from openpbso_tpu_torch.apps import fetch_dataset as t_fetch
from openpbso_tpu_torch.apps import real_time_modal_sound as t_rt
from openpbso_tpu_torch.apps import render_fields as t_fields
from openpbso_tpu_torch.apps import render_offline as t_offline
from openpbso_tpu_torch.apps import render_timeline as t_timeline
from openpbso_tpu_torch.apps import serve as t_serve
from openpbso_tpu_torch.apps import softrender as t_soft
from openpbso_tpu_torch.io.meta import read_meta, resolve_model_dir, \
    write_meta
from openpbso_tpu_torch.models.modal_model import load_model
from openpbso_tpu_torch.ops.doppler import DopplerPostMix
from openpbso_tpu_torch.runtime import engine as t_engine_mod
from openpbso_tpu_torch.runtime import server as tserver
from test_torch_server import Lockstep, run_script, start, wait_for

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------- flags


class _Parsed(Exception):
    pass


def parser_of(entry, argv):
    """The ArgumentParser an app builds, caught at its parse_args."""
    real = argparse.ArgumentParser.parse_args

    def catch(self, *a, **kw):
        raise _Parsed(self)
    argparse.ArgumentParser.parse_args = catch
    try:
        entry(argv)
    except _Parsed as e:
        return e.args[0]
    finally:
        argparse.ArgumentParser.parse_args = real
    raise AssertionError("the app never parsed its arguments")


def flag_set(parser):
    return {tuple(a.option_strings) or (a.dest,): (
        a.dest, a.default, tuple(a.choices) if a.choices else None,
        a.nargs, getattr(a.type, "__name__", None), a.required, a.const)
        for a in parser._actions if not isinstance(a, argparse._HelpAction)}


APPS = {
    "real_time_modal_sound": (lambda m: lambda argv: m.build_argparser()
                              .parse_args(argv), j_rt, t_rt),
    "serve": (lambda m: m.parse_args, j_serve, t_serve),
    "render_timeline": (lambda m: m.main, j_timeline, t_timeline),
    "render_offline": (lambda m: m.main, j_offline, t_offline),
    "render_fields": (lambda m: m.main, j_fields, t_fields),
    "assemble_movie": (lambda m: m.main, j_movie, t_movie),
    "fetch_dataset": (lambda m: m.main, j_fetch, t_fetch),
}


@pytest.mark.parametrize("app", list(APPS))
def test_flag_surface_matches_jax(app):
    """Every app takes the JAX package's flags with the same defaults and
    choices; ``--platform {cpu,tpu}`` becomes ``--device {cuda,cpu}``
    (cuda by default) where the JAX app has it."""
    entry, jm, tm = APPS[app]
    jflags = flag_set(parser_of(entry(jm), []))
    tflags = flag_set(parser_of(entry(tm), []))
    jplat = jflags.pop(("--platform",), None)
    tdev = tflags.pop(("--device",), None)
    assert tflags == jflags
    if jplat is None:
        assert tdev is None
    else:
        assert jplat[2] == ("cpu", "tpu")
        assert tdev[:3] == ("device", "cuda", ("cuda", "cpu"))


def test_resolve_paths_and_explicit_paths():
    p = t_rt.build_argparser()
    with pytest.raises(SystemExit):
        t_rt.resolve_paths(p.parse_args(["-m", "a.obj"]))
    args = p.parse_args(["-m", "a.obj", "-s", "b.modes", "-t", "c.txt",
                         "-p", "d", "-tex", "t.png"])
    paths = t_rt.resolve_paths(args)
    assert (paths.obj_file, paths.modes_file, paths.material_file,
            paths.ffat_dir) == ("a.obj", "b.modes", "c.txt", "d")
    assert args.obj_texture_map == "t.png"


def test_builders_raise_without_cuda(tmp_path, synth_model_root):
    """The entry points run on the card unless asked for the CPU: with no
    CUDA device, the default raises instead of building on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = t_rt.build_argparser().parse_args(["-d", synth_model_root,
                                              "-name", "synth"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_rt.make_session(args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_serve.build_server(t_serve.parse_args(["--demo-synth",
                                                 "--port", "0"]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_offline.run_config(1, "blocked", str(tmp_path))


# ---------------------------------------------------------------- sessions


def test_make_session_and_session_from_meta_match_jax(synth_model_root,
                                                      tmp_path, dberr,
                                                      capsys):
    """make_session (two instances, FFAT maps with both textures) and the
    hot-swap recipe session_from_meta build the JAX package's session: the
    same banks, listener rows and rendered blocks (<= -100 dB); the port
    says which texture it built."""
    argv = ["-d", synth_model_root, "-name", "synth", "--instances", "2",
            "--block", "256", "--listener", "0.7,0.4,0.3"]
    jargs = j_rt.build_argparser().parse_args(argv)
    targs = t_rt.build_argparser().parse_args(argv + ["--device", "cpu"])
    _, jsess = j_rt.make_session(jargs)
    model, tsess = t_rt.make_session(targs)
    assert "ffat texture: raw + compressed" in capsys.readouterr().out
    assert tsess.ffat.geom.psi_c is not None
    meta = str(tmp_path / "synth.meta")
    write_meta(meta, resolve_model_dir(synth_model_root, "synth"))
    _, jswap = j_rt.session_from_meta(jargs, meta)
    _, tswap = t_rt.session_from_meta(targs, meta)
    for js, ts in ((jsess, tsess), (jswap, tswap)):
        assert ts.bank.num_modes == js.bank.num_modes
        np.testing.assert_allclose(ts.state.transfer.numpy(),
                                   np.asarray(js.state.transfer), rtol=1e-5)
        space = model.modal_force_vertex(3)
        js.hit(1, space, kind="gaussian", width_us=300.0)
        ts.hit(1, space, kind="gaussian", width_us=300.0)
        assert dberr(ts.render(6), js.render(6)) <= -100.0


@pytest.mark.parametrize("config", [1, 2, 3, 4])
def test_render_offline_configs_match_jax(config, dberr):
    """Configs 1-4 set up and render as the JAX package's (<= -100 dB)."""
    _, jrender = j_offline._prepared(config, "blocked")
    _, trender = t_offline._prepared(config, "blocked", device="cpu")
    t = trender()
    assert np.isfinite(t).all() and float(np.abs(t).max()) > 0
    assert dberr(t, np.asarray(jrender())) <= -100.0


def test_run_config_report(tmp_path):
    r = t_offline.run_config(1, "blocked", str(tmp_path), device="cpu")
    j = j_offline.run_config(1, "blocked", str(tmp_path / "j"))
    assert r.keys() == j.keys()
    assert r["samples"] == j["samples"] and r["peak"] > 0
    assert os.path.exists(r["wav"])
    r5 = t_offline.run_config(5, "blocked", str(tmp_path), device="cpu")
    assert r5["peak"] > 0 and r5["samples"] > 0


# ---------------------------------------------------------------- fields


def test_field_exports_bitwise(tmp_path, synth_model_root):
    """Mode-shape OBJ frames, FFAT face images, field slices and the
    matcap stills: the same bytes as the JAX package's."""
    model = load_model(resolve_model_dir(synth_model_root, "synth"))
    jmodel = j_load_model(j_resolve(synth_model_root, "synth"))
    nx = ny = 8
    nz = 4
    fields = tmp_path / "fields"
    fields.mkdir()
    rng = np.random.default_rng(0)
    rng.standard_normal(nx * ny * nz).astype("<f4").tofile(
        str(fields / "p_0.dat"))
    rng.standard_normal(nx * ny).astype("<f4").tofile(
        str(fields / "p_1.dat"))
    rng.standard_normal(7).astype("<f4").tofile(str(fields / "p_2.dat"))
    out = {}
    for tag, mod, mdl in (("j", j_fields, jmodel), ("t", t_fields, model)):
        d = tmp_path / tag
        paths = (mod.export_mode_shapes(mdl, str(d / "m"), frames=3)
                 + mod.export_ffat_images({0: mdl.ffat_maps[0],
                                           3: mdl.ffat_maps[3]},
                                          str(d / "f"))
                 + mod.render_field_slices(str(fields), str(d / "s"),
                                           nx=nx, ny=ny, nz=nz)
                 + mod.render_mode_shape_frames(mdl, str(d / "p"),
                                                frames=2, size=64))
        out[tag] = [(os.path.relpath(p, d), open(p, "rb").read())
                    for p in paths]
    assert len(out["t"]) == 3 + 12 + 2 + 2
    assert out["t"] == out["j"]


def test_decode_field_plane_x_fastest_bitwise():
    nx, ny, nz = 3, 2, 4
    plane = np.arange(nx * ny, dtype=np.float32)
    vol = np.arange(nx * ny * nz, dtype=np.float32)
    for data in (plane, vol, np.arange(5, dtype=np.float32)):
        t = t_fields.decode_field_plane(data, nx, ny, nz, 1)
        j = j_fields.decode_field_plane(data, nx, ny, nz, 1)
        assert (t is None and j is None) or np.array_equal(t, j)
    assert t_fields.decode_field_plane(plane, nx, ny, nz, 0)[1, 2] == 2 + nx


def test_softrender_bitwise():
    rng = np.random.default_rng(3)
    v = rng.standard_normal((30, 3))
    f = rng.integers(0, 30, (40, 3))
    for kw in ({}, {"matcap": t_soft.default_matcap(32)},
               {"eye": np.array([2.0, 1.0, 3.0]), "width": 48,
                "height": 40}):
        jkw = dict(kw)
        if "matcap" in jkw:
            jkw["matcap"] = j_soft.default_matcap(32)
            assert np.array_equal(kw["matcap"], jkw["matcap"])
        assert np.array_equal(t_soft.render_mesh(v, f, **kw),
                              j_soft.render_mesh(v, f, **jkw))


def test_transfer_ball_matches_jax(tmp_path, synth_model_root):
    """The icosphere with its per-vertex transfer (static and qnorm
    weighted) from a CPU session, against the JAX package's."""
    import jax.numpy as jnp

    from openpbso_tpu.ops.coeffs import bank_from_material as j_bank
    from openpbso_tpu.ops.ffat import build_ffat as j_ffat
    from openpbso_tpu.runtime.session import ModalSession as JSession
    from openpbso_tpu_torch.ops.coeffs import bank_from_material
    from openpbso_tpu_torch.ops.ffat import build_ffat
    from openpbso_tpu_torch.runtime.session import ModalSession
    model = load_model(resolve_model_dir(synth_model_root, "synth"))
    w = (model.material.density, model.modes.omega_squared,
         model.material.alpha, model.material.beta)
    jb = j_bank(*w, block_size=128, dtype=jnp.float32)
    jsess = JSession(jb, ffat=j_ffat(model.ffat_maps, jb.num_modes))
    tb = bank_from_material(*w, block_size=128, device="cpu")
    tsess = ModalSession(tb, ffat=build_ffat(model.ffat_maps, tb.num_modes,
                                             device="cpu"))
    q = np.zeros(tb.num_modes)
    q[:3] = [1.0, 0.5, 0.25]
    for qn in (None, q):
        jo, jv = j_fields.export_transfer_ball(jsess, str(tmp_path / "j"),
                                               subdivisions=1, qnorm=qn)
        to, tv = t_fields.export_transfer_ball(tsess, str(tmp_path / "t"),
                                               subdivisions=1, qnorm=qn)
        assert open(to, "rb").read() == open(jo, "rb").read()
        np.testing.assert_allclose(np.load(tv), np.load(jv), rtol=1e-5)


# ---------------------------------------------------------------- serving


SCENE_SCRIPT = {
    0: [(0, {"cmd": "hit", "obj": 1, "vertex": 3, "kind": "gaussian",
             "width_us": 800.0})],
    2: [(0, {"cmd": "listener", "pos": [0.4, 0.3, 1.1]})],
    4: [(0, {"cmd": "object_pos", "obj": 2, "pos": [1.5, 0.0, -0.2]})],
    5: [(0, {"cmd": "hit", "obj": 0, "face": 5, "bary": [0.2, 0.3, 0.5]}),
        (0, {"cmd": "sustain", "obj": 2, "vertex": 1})],
    9: [(0, {"cmd": "release", "obj": 2}),
        (0, {"cmd": "hit", "obj": 2, "vertex": 7, "kind": "hertz"})],
}


def served_scene_pcm(serve_mod, server_mod, engine_mod, monkeypatch,
                     argv, n_blocks):
    gate = Lockstep(engine_mod, monkeypatch)
    monkeypatch.chdir(ROOT)
    srv = serve_mod.build_server(serve_mod.parse_args(argv))
    t = start(srv)
    c = server_mod.AudioClient(*srv.address)
    try:
        assert wait_for(lambda: srv._fanout.n_clients == 1)
        pcm, = run_script(srv, gate, [c], SCENE_SCRIPT, n_blocks)
        assert gate.engines[-1].error is None
        replies = list(c.messages)
    finally:
        c.close()
        srv.close()
        t.join(timeout=30)
    return pcm, replies


def test_served_scene_from_committed_assets_matches_jax(monkeypatch, dberr,
                                                        capsys):
    """pbso-serve --scene assets/demo/scene.json --multi-client through
    both packages' build_server, one client's script in lockstep (vertex
    and face hits on the scene's own models, a listener move, an object
    move, a drag): the PCM agrees to <= -100 dB and the replies match."""
    argv = ["--scene", "assets/demo/scene.json", "--multi-client",
            "--port", "0", "--block", "256"]
    n = 14
    jpcm, jrep = served_scene_pcm(j_serve, jserver, j_engine_mod,
                                  monkeypatch, argv + ["--platform", "cpu"],
                                  n)
    tpcm, trep = served_scene_pcm(t_serve, tserver, t_engine_mod,
                                  monkeypatch, argv + ["--device", "cpu"],
                                  n)
    assert trep == jrep and [list(m) for m in trep] == [["object_pos"]]
    assert tpcm.shape == (n * 256, 2) and float(np.abs(tpcm).max()) > 0
    assert dberr(tpcm, jpcm) <= -100.0
    assert "scene: 3 instances" in capsys.readouterr().out


def test_serve_dynamic_buckets_with_live_doppler(monkeypatch):
    """The port lets --live-doppler compose with dynamic per-client
    buckets (the JAX package refuses the pair): a grow rebuilds the
    Doppler post-mix at the new listener count and carries the ring-down,
    the first client's delay line bitwise into the stream that starts
    (after start()'s warmup); both clients stream their own columns
    afterwards."""
    with pytest.raises(SystemExit):
        j_serve.parse_args(["--multi-client", "--per-client-listeners",
                            "1,2", "--live-doppler"])
    carried = {}
    carry_from = DopplerPostMix.carry_from

    def probe(pm, old, listener):
        carried.update(hist=old._hist.clone(), d_cur=old._d_cur.copy())
        carry_from(pm, old, listener)
    monkeypatch.setattr(DopplerPostMix, "carry_from", probe)
    gate = Lockstep(t_engine_mod, monkeypatch)
    monkeypatch.chdir(ROOT)
    srv = t_serve.build_server(t_serve.parse_args([
        "--scene", "assets/demo/scene.json", "--multi-client",
        "--per-client-listeners", "1,2", "--live-doppler", "--device",
        "cpu", "--port", "0", "--block", "256"]))
    t = start(srv)
    a = tserver.AudioClient(*srv.address)
    clients = [a]
    try:
        engine = gate.engines[-1]
        assert engine._post_mix._nl == 1
        a.send(cmd="hit", obj=1, vertex=3, kind="gaussian", width_us=900.0)
        assert wait_for(lambda: engine._events.qsize() == 1)
        for _ in range(4):
            gate.step()
            a.read_block()
        b = tserver.AudioClient(*srv.address)
        clients.append(b)
        assert wait_for(lambda: srv.grows)
        assert srv.grows[0]["carried"] and srv._pcl == 2
        pm = engine._post_mix
        assert pm._nl == 2 and pm.gains.shape == (3, 2)
        # the new stream waits at its gate: the post-mix is as it starts
        assert float(carried["hist"].abs().max()) > 0
        assert torch.equal(pm._hist[:, 0], carried["hist"])
        np.testing.assert_array_equal(pm._d_cur[:, 0], carried["d_cur"])
        assert not pm._hist[:, 1].any()
        assert wait_for(lambda: srv._fanout.n_clients == 2)
        for _ in range(3):
            gate.step()
            for c in clients:
                block = c.read_block()
        assert float(np.abs(block).max()) > 0        # the ring-down goes on
        assert engine.error is None
    finally:
        for c in clients:
            c.close()
        srv.close()
        t.join(timeout=30)


def test_serve_object_motion_survives_restart(monkeypatch):
    """object_vel on a --scene --live-doppler server: the Doppler post-mix
    integrates the motion on the audio clock and the ticker moves the
    scene object; an elastic restart comes back with the moved world (a
    fresh Scene at the live positions, the velocity pushed again); a zero
    velocity stops it where the post-mix put it."""
    monkeypatch.chdir(ROOT)
    srv = t_serve.build_server(t_serve.parse_args([
        "--scene", "assets/demo/scene.json", "--multi-client",
        "--live-doppler", "--device", "cpu", "--port", "0", "--block",
        "256"]))
    srv._motion_rate = 20.0
    t = start(srv)
    c = tserver.AudioClient(*srv.address)
    try:
        x0 = srv._scene.object_position(1)[0]
        c.send(cmd="object_vel", obj=1, vel=[2.0, 0.0, 0.0])

        def moved(dx):
            c.read_block()
            return srv._scene.object_position(1)[0] >= dx
        assert wait_for(lambda: moved(x0 + 0.2))
        first = srv._scene
        srv._engine.error = RuntimeError("injected failure")
        srv._engine._stop.set()
        assert wait_for(lambda: moved(x0) and any(
            "restarted" in m for m in c.messages))
        assert srv._scene is not first
        x1 = srv._scene.object_position(1)[0]
        assert x1 >= x0 + 0.2
        assert wait_for(lambda: moved(x1 + 0.2))   # the motion goes on
        np.testing.assert_allclose(srv._engine._post_mix.velocities[1],
                                   [2.0, 0.0, 0.0])
        c.send(cmd="object_vel", obj=1, vel=[0.0, 0.0, 0.0])
        assert wait_for(lambda: moved(x0) and any(
            "object_vel" in m and not any(m["object_vel"]["vel"])
            for m in c.messages))
        # within one block's travel (2 m/s x 256 samples): a dispatch in
        # flight when the zero velocity arrives may still take its step
        pm = srv._engine._post_mix
        np.testing.assert_allclose(srv._scene.object_position(1),
                                   pm.positions[1], atol=0.02)
    finally:
        c.close()
        srv.close()
        t.join(timeout=30)


def test_serve_demo_synth_cli_subprocess(tmp_path):
    """python -m openpbso_tpu_torch.apps.serve --demo-synth --one-shot
    --device cpu: serves a client a hit and its stats, then exits."""
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    proc = subprocess.Popen(
        [sys.executable, "-m", "openpbso_tpu_torch.apps.serve",
         "--demo-synth", "--one-shot", "--device", "cpu", "--port",
         str(port), "--block", "256"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        line = ""
        while "serving" not in line:
            line = proc.stdout.readline()
            assert line or proc.poll() is None, "server died at startup"
        c = tserver.AudioClient("127.0.0.1", port, timeout=120)
        c.send(cmd="hit", obj=0, vertex=3, kind="gaussian", width_us=800.0)
        peak = 0.0
        for _ in range(400):
            peak = max(peak, float(np.abs(c.read_block()).max()))
            if peak > 0:
                break
        assert peak > 0
        c.send(cmd="quit")
        c.close()
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# ---------------------------------------------------------------- CLI


def test_cli_demo_synth_end_to_end(tmp_path):
    """The main CLI in a subprocess on the CPU writes a wav and a
    recorded timeline, which the timeline CLI bakes."""
    import wave
    out = str(tmp_path / "demo.wav")
    rec = str(tmp_path / "rec.json")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "openpbso_tpu_torch.apps."
         "real_time_modal_sound", "--demo-synth", "--seconds", "0.5",
         "--out", out, "--block", "256", "--device", "cpu", "--record",
         rec], capture_output=True, text=True, timeout=240, env=env,
        cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "wrote" in r.stdout and "ffat texture:" in r.stdout
    with wave.open(out) as w:
        assert w.getnchannels() == 2 and w.getnframes() > 0
    timeline = json.load(open(rec))
    assert timeline["events"] and timeline["duration_s"] > 0


def test_cli_print_frequencies_matches_jax(synth_model_root):
    argv = ["-d", synth_model_root, "-name", "synth", "--print-frequencies"]
    outs = []
    for mod in ("openpbso_tpu", "openpbso_tpu_torch"):
        r = subprocess.run(
            [sys.executable, "-m", f"{mod}.apps.real_time_modal_sound"]
            + argv, capture_output=True, text=True, timeout=240, cwd=ROOT,
            env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert r.returncode == 0, r.stderr[-2000:]
        outs.append(r.stdout)
    assert outs[0] == outs[1] and "Mode 0:" in outs[1]


def test_cli_interactive_again_preview_tex(tmp_path, synth_model_root):
    """Interactive 'again' (repeat the cached hit), 'preview' with a -tex
    matcap, 'stats' and 'quit' through stdin, on the CPU."""
    tex = str(tmp_path / "matcap.png")
    rng = np.random.default_rng(0)
    t_fields._write_png(tex, rng.uniform(0, 255, (32, 32, 3)).astype(
        np.uint8))
    paths = resolve_model_dir(synth_model_root, "synth")
    png = str(tmp_path / "shot.png")
    feed = f"hit 0 3 gaussian 400\nagain\npreview {png}\nstats\nquit\n"
    r = subprocess.run(
        [sys.executable, "-m", "openpbso_tpu_torch.apps."
         "real_time_modal_sound", "-m", paths.obj_file, "-s",
         paths.modes_file, "-t", paths.material_file, "-p", paths.ffat_dir,
         "-tex", tex, "--interactive", "--device", "cpu", "--block", "256",
         "--out", str(tmp_path / "i.wav")],
        input=feed, capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert open(png, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    assert f"wrote {png}" in r.stdout
    assert "no hit to repeat" not in r.stdout


# ---------------------------------------------------------------- tools


def test_assemble_movie_gif(tmp_path):
    from PIL import Image
    frames = tmp_path / "frames"
    frames.mkdir()
    for i in range(12):
        Image.new("RGB", (16, 16), (20 * i % 255, 0, 0)).save(
            frames / f"test-{i}.png")
    paths = [str(frames / f"test-{i}.png") for i in (10, 2, 7)]
    assert t_movie.numeric_frame_sort(paths) == \
        j_movie.numeric_frame_sort(paths)
    for kw in ({"start_from": 3, "count": 5}, {"start_from": 0}):
        assert t_movie.select_frames(str(frames), "test-*.png", **kw) == \
            j_movie.select_frames(str(frames), "test-*.png", **kw)
    with pytest.raises(ValueError):
        t_movie.select_frames(str(frames), "test-*.png", start_from=99)
    out = tmp_path / "movie.gif"
    assert t_movie.main(["--frames", str(frames), "--pattern", "test-*.png",
                         "--start-from", "2", "--out", str(out)]) == 0
    with Image.open(out) as im:
        assert im.n_frames == 10


@pytest.fixture
def mirror(tmp_path):
    """A local source tree in the reference's remote layout (no
    network: fetch_dataset stages from local paths)."""
    from openpbso_tpu_torch.utils.synth import synth_model_dir
    src = tmp_path / "mirror"
    mats = tmp_path / "materials"
    mats.mkdir(parents=True)
    ids = ["cup", "bowl"]
    for i, mid in enumerate(ids):
        stage = tmp_path / f"synth_{mid}"
        synth_model_dir(str(stage), "m", num_modes=10, subdivisions=1,
                        ffat_n=8, seed=10 + i)
        base = src / "data" / mid
        (base / "modal_models" / "ceramic").mkdir(parents=True)
        (base / "radiation_models" / "ceramic").mkdir(parents=True)
        name = f"{mid}_tetmesh"
        shutil.copy(stage / "m.tet.obj", base / f"{name}.tet.obj")
        shutil.copy(stage / "m_surf.modes",
                    base / "modal_models" / "ceramic" / f"{name}_surf.modes")
        shutil.copytree(stage / "m_ffat_maps",
                        base / "radiation_models" / "ceramic"
                        / "ffat_map-fdtd")
        shutil.copy(stage / "m_material.txt", mats / "ceramic.txt")
    manifest = tmp_path / "ran_obj_mat.txt"
    manifest.write_text("# comment line\ndata/cup ceramic\n"
                        "data/bowl ceramic\n")
    return tmp_path, str(manifest), str(src), str(mats), ids


def test_fetch_dataset_stages_and_writes_metas(mirror, capsys):
    """Manifest parsing, staging from a local mirror, the .meta files
    (the same bytes as the JAX tool's), a model loaded from one, the
    empty-FFAT guard, a missing source reported, and .part debris of an
    interrupted run discarded."""
    tmp_path, manifest, src, mats, ids = mirror
    assert t_fetch.parse_manifest(manifest) == \
        j_fetch.parse_manifest(manifest)
    metas = {}
    for tag, mod in (("j", j_fetch), ("t", t_fetch)):
        out_root = str(tmp_path / f"10k_{tag}")
        meta_dir = str(tmp_path / f"meta_{tag}")
        assert mod.main(["--manifest", manifest, "--source", src,
                         "--materials-dir", mats, "--out-root", out_root,
                         "--meta-dir", meta_dir]) == 0
        metas[tag] = {n: open(os.path.join(meta_dir, n)).read().replace(
            f"10k_{tag}", "10k") for n in sorted(os.listdir(meta_dir))}
    assert metas["t"] == metas["j"]
    assert sorted(metas["t"]) == ["bowl_tetmesh.meta", "cup_tetmesh.meta"]
    model = load_model(read_meta(str(tmp_path / "meta_t" /
                                     "cup_tetmesh.meta")))
    assert model.num_modes_audible > 0 and model.ffat_maps
    # the empty-FFAT guard
    out_root = str(tmp_path / "10k_t")
    ffat = os.path.join(out_root, "cup_tetmesh", "ffat_map-fdtd")
    for f in os.listdir(ffat):
        os.remove(os.path.join(ffat, f))
    written = t_fetch.write_dataset_meta(out_root, str(tmp_path / "m2"))
    assert [os.path.basename(w) for w in written] == ["bowl_tetmesh.meta"]
    # a missing source is reported, the rest staged
    bad = tmp_path / "bad.txt"
    bad.write_text("data/cup ceramic\ndata/nope ceramic\n")
    capsys.readouterr()
    assert t_fetch.main(["--manifest", str(bad), "--source", src,
                         "--materials-dir", mats, "--out-root",
                         str(tmp_path / "out2")]) == 1
    assert "SKIP nope" in capsys.readouterr().err
    # .part debris of an interrupted run
    outdir = os.path.join(str(tmp_path / "atomic"), "cup_tetmesh")
    os.makedirs(os.path.join(outdir, "ffat_map-fdtd.part"))
    open(os.path.join(outdir, "ffat_map-fdtd.part", "junk"), "w").close()
    assert t_fetch.main(["--manifest", manifest, "--source", src,
                         "--materials-dir", mats, "--out-root",
                         str(tmp_path / "atomic")]) == 0
    assert not os.path.exists(os.path.join(outdir, "ffat_map-fdtd.part"))
    assert "junk" not in os.listdir(os.path.join(outdir, "ffat_map-fdtd"))
