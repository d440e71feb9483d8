"""The plain reference's block form against the recurrence sample by
sample, at a tiny size, with every event kind: hits of each kind (one
future-dated), a slot overwritten, listener moves ramped and held, a drag
started, updated, retuned and ended."""
import numpy as np
import torch

from portbench.reference import ar, ffat, forces, modal, replay
from portbench.scenes.modal_bank import ffat_maps

S, O, M, RATE = 32, 3, 8, 44100.0


def _scene(shared):
    rng = np.random.default_rng(5)
    g = 1 if shared else O
    freqs = np.sort(rng.uniform(200.0, 9000.0, (g, M)), axis=1)
    maps = ffat_maps(rng, M, 4, 0.2, 120.0, 9000.0, 343.0)
    return dict(omega_sq=(2 * np.pi * freqs) ** 2 * 2700.0, density=2700.0,
                alpha=6.0, beta=1e-7, rate=RATE, block=S, gain=1e9,
                output_scale=1e10, unit_transfer=1e7, slots=2, objects=O,
                modes=M, maps=maps)


def _events():
    rng = np.random.default_rng(9)
    sp = lambda: rng.standard_normal(M)      # noqa: E731
    rows = lambda: rng.uniform(0.5, 2.0, (O, 3))  # noqa: E731
    return [
        (0, "listener", dict(rows=rows())),
        (0, "hit", dict(obj=0, space=sp(), kind="point", width_us=100.0,
                        amp=1.0, when=None)),
        (S, "hit", dict(obj=1, space=sp(), kind="gaussian", width_us=300.0,
                        amp=0.7, when=None)),
        (S, "hit", dict(obj=2, space=sp(), kind="hertz", width_us=500.0,
                        amp=1.3, when=3 * S)),
        (2 * S, "hit", dict(obj=1, space=sp(), kind="gaussian",
                            width_us=200.0, amp=1.1, when=None)),
        (2 * S, "hit", dict(obj=1, space=sp(), kind="point", width_us=1.0,
                            amp=0.9, when=None)),   # overwrites a slot
        (2 * S, "drag", dict(op="start", obj=0, space=sp())),
        (4 * S, "listener", dict(rows=rows())),
        (5 * S, "drag", dict(op="update", obj=0, space=sp())),
        (5 * S, "tune", dict(obj=0, a=(0.6, 0.2), sigma=0.003, mu=0.1)),
        (6 * S, "listener", dict(rows=rows())),
        (7 * S, "drag", dict(op="end", obj=0)),
    ]


def _direct(scene, events, n_blocks, ar_seed, smooth):
    """The recurrence sample by sample, in float64 numpy."""
    lam, b, valid = modal.coefficients(scene["omega_sq"], 2700.0, 6.0, 1e-7,
                                       RATE, 1e9)
    lam = np.broadcast_to(lam, (O, M))
    b = np.broadcast_to(b, (O, M))
    mask = valid.astype(float)
    maps = {k: torch.as_tensor(np.asarray(v)).to(
        torch.int64 if k in ("n_elements", "strides") else torch.float64)
        for k, v in scene["maps"].items()}
    slots = forces.Slots(O, 2, S, RATE)
    keys = ar.object_keys(ar_seed, O, "cpu")
    z = np.zeros((O, M), complex)
    cur = 1e7 * np.broadcast_to(mask, (O, M))
    hist = np.zeros((O, 2))
    out = np.zeros(n_blocks * S)
    evs = sorted(events, key=lambda e: e[0])
    for blk in range(n_blocks):
        start = blk * S
        prev = None
        for clock, op, kw in [e for e in evs if e[0] == start]:
            if op == "hit":
                slots.hit(kw["obj"], kw["space"], kw["kind"], kw["width_us"],
                          kw["amp"], kw["when"], clock)
            elif op == "listener":
                new = ffat.transfer(torch.as_tensor(kw["rows"]),
                                    maps).numpy() * mask
                if smooth and prev is None:
                    prev = cur
                cur = new
            elif op == "drag":
                slots.drag(kw["op"], kw["obj"], kw.get("space"))
            elif op == "tune":
                slots.drag("tune", kw["obj"], a=kw["a"], sigma=kw["sigma"],
                           mu=kw["mu"])
        imp = slots.impacts(start)
        exc = np.zeros((O, M, S))
        for o, (rws, prof) in imp.items():
            exc[o] = np.sum(rws, axis=0)[:, None] * prof[None, :]
        for o in np.nonzero(slots.active)[0]:
            (a, sigma, mu) = slots.ar[o]
            if slots.reset[o]:
                hist[o] = 0.0
                slots.reset[o] = False
            n = ar.normals(keys[[o]], torch.tensor([blk]), S)[0].numpy()
            m1, m2 = hist[o]
            prof = np.zeros(S)
            for j in range(S):
                m = a[0] * m1 + a[1] * m2 + sigma * n[j]
                prof[j] = mu + m
                m1, m2 = m, m1
            hist[o] = (m1, m2)
            exc[o] = slots.sus_space[o][:, None] * prof[None, :]
        for j in range(S):
            z = lam * z + b * exc[:, :, j]
            w = cur if prev is None else prev + (j + 1) / S * (cur - prev)
            out[start + j] = np.sum(w * z.imag) / 1e10
    return out


def test_block_form_matches_the_recurrence():
    for shared in (True, False):
        scene = _scene(shared)
        events = _events()
        want = _direct(scene, events, 10, 77, True)
        got = replay.render(scene, events, 10, ar_seed=77, smooth=True,
                            chunk=4)
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err < 1e-11, (shared, err)


def test_tf32_products_are_coarser():
    scene = _scene(False)
    events = _events()
    want = replay.render(scene, events, 10, ar_seed=77, smooth=True)
    f32 = replay.render(scene, events, 10, ar_seed=77, smooth=True,
                        dtype=torch.float32)
    t32 = replay.render(scene, events, 10, ar_seed=77, smooth=True,
                        dtype=torch.float32, tf32_products=True)
    e32 = np.linalg.norm(f32 - want) / np.linalg.norm(want)
    et = np.linalg.norm(t32 - want) / np.linalg.norm(want)
    assert e32 < 1e-5 and et > 30 * e32, (e32, et)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0])
    y = replay.tf32(x)
    assert y.tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.0]
