"""The bank's table cache (ops/coeffs.py::TableCache): the span tables with
their planes and the AR impulse tables that one session builds are taken by
every later session on the same bank, keyed by what they were built from
(the float64 eigenvalues, the chunk or AR length, the tuning's rows, the
dtype and the device) and held within ModalSession.TABLE_CACHE_BYTES. A
session's audio is bitwise the same whether its tables were built or
shared."""
import dataclasses
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from openpbso_tpu_torch.ops.coeffs import (TableCache, bank_from_material,
                                           build_modal_bank,
                                           lambda_from_modes)
from openpbso_tpu_torch.runtime import profiling as P
from openpbso_tpu_torch.runtime import session as session_mod
from openpbso_tpu_torch.runtime.session import ModalSession
from openpbso_tpu_torch.runtime.solver import SolverConfig
from openpbso_tpu_torch.utils.synth import CERAMIC, synth_mode_data

S = 64
MODES = 12
OBJECTS = 3


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread and a span log of the test's own."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    P.reset()
    yield
    P.reset()
    torch.set_num_threads(threads)


def _modes(seed):
    md = synth_mode_data(MODES, 8, seed=seed)
    return md.omega_squared


def _scene(layout):
    """(bank, lam64): one mode set for every object, or one each."""
    if layout == "shared":
        w2 = _modes(3)
        bank = bank_from_material(CERAMIC.density, w2, CERAMIC.alpha,
                                  CERAMIC.beta, num_objects=OBJECTS,
                                  block_size=S, device="cpu")
        return bank, lambda_from_modes(CERAMIC.density, w2, CERAMIC.alpha,
                                       CERAMIC.beta)[0]
    parts = [lambda_from_modes(CERAMIC.density, _modes(3 + i),
                               CERAMIC.alpha, CERAMIC.beta)
             for i in range(OBJECTS)]
    lam, b, valid = (np.stack(x) for x in zip(*parts))
    return build_modal_bank(lam, b, valid, block_size=S, shared=False,
                            device="cpu"), lam


@pytest.fixture(scope="module", params=["shared", "per_object"])
def scene(request):
    return _scene(request.param)


def _space(k):
    return np.cos(0.7 * k + np.arange(MODES))


def _session(bank, lam64, dtype=torch.float32):
    return ModalSession(bank, lam64=lam64, num_slots=4, dtype=dtype,
                        config=SolverConfig(block_size=S,
                                            backend="blocked"))


def _play(sess, retune=None):
    """A hit rendered in a span, then every object dragging across
    renders of 3 and 4 blocks (a drag span each; two AR lengths), with
    ``retune`` (a) applied to object 1 before the last render: the audio."""
    sess.hit(0, _space(0), kind="gaussian", width_us=900.0)
    out = [sess.render_multi(4, blocks_per_dispatch=4)]
    for obj in range(OBJECTS):
        sess.sustained_start(obj, _space(obj + 1))
    out += [sess.render_multi(3, blocks_per_dispatch=3),
            sess.render_multi(4, blocks_per_dispatch=4)]
    if retune is not None:
        sess.set_ar_params(1, a=retune)
    out.append(sess.render_multi(4, blocks_per_dispatch=4))
    return np.concatenate(out)


class _Builds:
    """Counts the session module's span and AR table builds."""

    def __init__(self, monkeypatch):
        self.span = self.ar = 0
        build, impulse = session_mod.build_span_tables, \
            session_mod.ar_impulse_g

        def span(*a, **kw):
            self.span += 1
            return build(*a, **kw)

        def ar(*a, **kw):
            self.ar += 1
            return impulse(*a, **kw)
        monkeypatch.setattr(session_mod, "build_span_tables", span)
        monkeypatch.setattr(session_mod, "ar_impulse_g", ar)


def _fresh(bank):
    """The bank with empty caches (the same tensors)."""
    return dataclasses.replace(bank)


def _tables_spans(run):
    """The ``session.tables`` spans' counters of what ``run`` records."""
    P.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out = run()
    s = P.spans()
    tables = s["name"] == P.NAMES.index("session.tables")
    return out, s["c0"][tables].tolist()


def test_a_second_session_takes_the_first_ones_tables(scene, monkeypatch):
    """A second session on the bank renders spans and drag spans with no
    build, each of its session misses counted as a hit of the bank's cache
    (``bank`` = 1), and its audio is bitwise a session's on a fresh
    bank."""
    bank, lam64 = scene
    bank = _fresh(bank)
    builds = _Builds(monkeypatch)
    first, counters = _tables_spans(lambda: _play(_session(bank, lam64)))
    assert builds.span and builds.ar and counters
    assert set(counters) == {0}
    made = (builds.span, builds.ar)
    second, counters = _tables_spans(lambda: _play(_session(bank, lam64)))
    assert (builds.span, builds.ar) == made        # nothing built
    assert counters and set(counters) == {1}
    assert P.COUNTERS[P.TABLES] == ("bank",)
    alone = _play(_session(_fresh(bank), lam64))
    assert np.abs(alone).max() > 0
    np.testing.assert_array_equal(second, alone)
    np.testing.assert_array_equal(first, alone)


def test_shared_tables_are_the_same_tensors(scene):
    """The bank hands the later session the tensors the first one built,
    planes included."""
    bank, lam64 = scene
    bank = _fresh(bank)
    a, b = _session(bank, lam64), _session(bank, lam64)
    ta, tb = a.span_tables_for(4), b.span_tables_for(4)
    assert tb.b_re is ta.b_re and tb.planes is ta.planes
    assert a.ar_span_table(4) is b.ar_span_table(4)
    assert len(bank.table_cache) == 2


@pytest.mark.parametrize("differ", ["lam64", "dtype", "tuning"])
def test_sessions_with_other_inputs_get_their_own_tables(scene, differ,
                                                         monkeypatch):
    """A session whose eigenvalues (an equal-shaped array of other
    values), dtype or AR tuning differ from the first's builds its own
    tables, and renders bitwise what it renders on a fresh bank."""
    bank, lam64 = scene
    bank = _fresh(bank)
    _play(_session(bank, lam64))
    other_lam = lam64 * (1.0 - 1e-7) if differ == "lam64" else lam64
    dtype = torch.float64 if differ == "dtype" else torch.float32

    def make(b):
        sess = _session(b, other_lam, dtype)
        if differ == "tuning":
            for obj in range(OBJECTS):
                sess.set_ar_params(obj, a=(0.6, 0.2))
        return sess
    builds = _Builds(monkeypatch)
    shared = _play(make(bank))
    # the AR tables depend on the tuning and dtype, the span tables on
    # the eigenvalues and dtype
    assert (builds.span > 0, builds.ar > 0) == {
        "lam64": (True, False), "dtype": (True, True),
        "tuning": (False, True)}[differ]
    alone = _play(make(_fresh(bank)))
    np.testing.assert_array_equal(shared, alone)
    fresh = make(_fresh(bank))
    theirs = make(bank)
    for n in (3, 4):
        mine, ref = theirs.span_tables_for(n), fresh.span_tables_for(n)
        assert mine.b_re.dtype == dtype
        assert torch.equal(mine.b_re, ref.b_re)
        assert torch.equal(mine.b_im, ref.b_im)
        assert torch.equal(theirs.ar_span_table(n), fresh.ar_span_table(n))


def test_a_session_renders_alike_after_the_bound_evicts(scene,
                                                        monkeypatch):
    """With a bound that holds about one table, every put evicts the
    least recently used; the bank's cache stays within the bound, and a
    later session renders bitwise a fresh bank's session."""
    bank, lam64 = scene
    bank = _fresh(bank)
    first = _session(bank, lam64)
    one = first.span_tables_for(4)
    bound = sum(t.nbytes for t in (one.b_re, one.b_im,
                                   *vars(one.planes).values()))
    first.TABLE_CACHE_BYTES = bound
    _play(first)
    assert 0 < bank.table_cache.nbytes <= bound
    later = _session(bank, lam64)
    later.TABLE_CACHE_BYTES = bound
    builds = _Builds(monkeypatch)
    got = _play(later)
    assert builds.span == 1        # the AR tables' puts evicted it
    assert 0 < bank.table_cache.nbytes <= bound
    np.testing.assert_array_equal(got, _play(_session(_fresh(bank),
                                                      lam64)))


def test_a_retune_takes_the_tuned_table_and_leaves_others_alone(scene):
    """A retune mid-session (object 1) drops the session's AR tables; the
    session takes the table of the new tuning, from the bank when another
    session built it, and a session rendering beside it on the same bank
    renders bitwise as it would alone."""
    bank, lam64 = scene
    bank = _fresh(bank)
    plain = _play(_session(_fresh(bank), lam64))
    tuned = _play(_session(_fresh(bank), lam64), retune=(0.5, 0.3))
    assert not np.array_equal(plain, tuned)
    a, b = _session(bank, lam64), _session(bank, lam64)
    got_a = _play(a, retune=(0.5, 0.3))
    assert a._ar_host[1].tolist() == [0.5, 0.3]
    want = session_mod.ar_impulse_g(a._ar_host, 4 * S)
    assert torch.equal(a.ar_span_table(4, force_per_object=True),
                       torch.as_tensor(want).float())
    got_b = _play(b)
    np.testing.assert_array_equal(got_a, tuned)
    np.testing.assert_array_equal(got_b, plain)
    # a third session retuned alike takes the tuned tables from the bank
    c = _session(bank, lam64)
    np.testing.assert_array_equal(_play(c, retune=(0.5, 0.3)), tuned)


def test_table_cache_drops_the_least_recently_used():
    cache = TableCache()
    for key in "abc":
        cache.put(key, key.upper(), 10, budget=30)
    assert cache.get("a") == "A"                  # b is now the oldest
    cache.put("d", "D", 10, budget=30)
    assert cache.get("b") is None
    assert [cache.get(k) for k in "acd"] == ["A", "C", "D"]
    cache.put("e", "E", 31, budget=30)            # larger than the bound
    assert cache.get("e") is None and len(cache) == 3
    cache.put("f", "F", 25, budget=30)
    assert len(cache) == 1 and cache.nbytes == 25 and cache.get("f") == "F"


def test_table_cache_holds_its_bound_under_threads():
    """Many threads hitting, missing and putting at once: no error, and
    the cache ends within its bound with every entry what was put."""
    import sys
    cache = TableCache()
    errors = []

    def work(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(2000):
                key = int(rng.integers(0, 40))
                got = cache.get(key)
                if got is None:
                    cache.put(key, ("table", key), 1 + key % 7, budget=60)
                elif got != ("table", key):
                    errors.append((key, got))
        except Exception as exc:       # reported by the assert below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert 0 < cache.nbytes <= 60
