"""Port parity: force-slot excitation (openpbso_tpu_torch.ops.forces).

Slot membership (the producing predicate) is integer math and must match
the JAX package exactly; the float32 profiles may differ by ulps of exp and
sin, so they are held at <= -120 dB.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpbso_tpu.ops import forces as jf
from openpbso_tpu_torch.ops import forces as tf

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: intra-op threads only slow them down, and
    under the suite's parallel workers they oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


S = 64
KINDS = {"point": (jf.FORCE_POINT, 1.0), "gaussian": (jf.FORCE_GAUSSIAN, 9.0),
         "hertz": (jf.FORCE_HERTZ, 150.0)}


def _slots(ftype, width, t0, o=2, k=3, m=5, seed=0):
    """Slot 1 of object 0 holds the force under test; slot 0 of object 1
    holds a second, always-producing gaussian (cross-slot sums)."""
    rng = np.random.default_rng(seed)
    ft = np.zeros((o, k), np.int32)
    t0s = np.zeros((o, k), np.int32)
    wd = np.ones((o, k), np.float32)
    amp = rng.uniform(0.5, 1.5, (o, k)).astype(np.float32)
    space = rng.standard_normal((o, k, m)).astype(np.float32)
    ft[0, 1], t0s[0, 1], wd[0, 1] = ftype, t0, width
    ft[1, 0], t0s[1, 0], wd[1, 0] = jf.FORCE_GAUSSIAN, 0, 400.0
    arrays = dict(ftype=ft, t0=t0s, width=wd, amp=amp, space=space)
    js = jf.ForceSlots(**{n: jnp.asarray(a) for n, a in arrays.items()})
    ts = tf.ForceSlots(**{n: torch.from_numpy(a) for n, a in arrays.items()})
    return js, ts


def _starts(kind, t0):
    """Block starts before t0, inside the slot's life, and at expiry."""
    ftype, width = KINDS[kind]
    dur = tf.slot_duration(ftype, width, S)
    assert dur == jf.slot_duration(ftype, width, S)
    return {"before": t0 - S, "inside": t0 + (dur - 1) // S * S,
            "expiry": t0 + dur}


@pytest.mark.parametrize("when", ["before", "inside", "expiry"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_force_block_matches_jax(kind, when, dberr):
    ftype, width = KINDS[kind]
    t0 = 5 * S
    js, ts = _slots(ftype, width, t0)
    start = _starts(kind, t0)[when]
    j_tp, j_sp = jf.force_block(js, jnp.asarray(start, jnp.int32), S)
    t_tp, t_sp = tf.force_block(ts, start, S)
    assert t_tp.dtype == torch.float32 and t_tp.shape == (2, S)
    # membership: the spatial sum takes exactly the producing slots' rows
    np.testing.assert_array_equal(t_sp.numpy(), np.asarray(j_sp))
    for o in range(2):
        ref = np.asarray(j_tp[o])
        got = t_tp[o].numpy()
        assert np.isfinite(got).all()
        if not ref.any():
            assert not got.any()
        else:
            assert dberr(got, ref) <= -120
    producing = when != "expiry" and when != "before"
    assert bool(np.asarray(j_sp[0]).any()) == producing


def test_hertz_profile_is_finite_after_the_contact():
    """sin(pi * 1.0) is slightly negative in float32; its 1.5th power is
    NaN, which must be selected away, not multiplied by a zero mask."""
    js, ts = _slots(jf.FORCE_HERTZ, 40.0, 0)
    tp, _ = tf.force_block(ts, 0, S)
    assert torch.isfinite(tp).all()
    assert (tp[0, 40:] == 0).all() and (tp[0, 1:40] > 0).all()


def test_slot_tables_and_duration():
    ts = tf.make_force_slots(3, 4, 8, device="cpu")
    js = jf.make_force_slots(3, 4, 8, jnp.float32)
    for f in dataclasses.fields(tf.ForceSlots):
        a, b = getattr(ts, f.name), np.asarray(getattr(js, f.name))
        assert a.shape == b.shape and str(a.dtype)[6:] == str(b.dtype), f
        np.testing.assert_array_equal(a.numpy(), b)
    assert ts.num_slots == 4 and ts.first(2).ftype.shape == (3, 2)
    for ftype in range(4):
        for width in (0.5, 1.0, 7.9, 300.0):
            assert (tf.slot_duration(ftype, width, 512)
                    == jf.slot_duration(ftype, width, 512))
    sus = tf.make_sustained_state(3, 8, device="cpu")
    assert not sus.active.any() and sus.space.shape == (3, 8)
