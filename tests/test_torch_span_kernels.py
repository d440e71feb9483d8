"""Port parity: the chunked span's mode contractions, span_inject (the
chunk injections) and span_reduce (the per-slot kernels g and the
cross-chunk hom), against the JAX package's stage code.

The same numpy inputs, made from a seed, go through the JAX package's
contractions (openpbso_tpu/ops/span.py::_contract_xm, _contract_xr and
ops/integrator.py::_complex_weights, as _integrate_span_chunked composes
them) and through the port's wrappers, which run their plain twins on CPU
tensors. The bar is the port's CPU bar, <= -100 dB in float32.
tests/test_torch_gpu.py and chip_smoke.py hold the CUDA kernels against
those twins on a GPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpbso_tpu.ops import span as js
from openpbso_tpu.ops.coeffs import build_modal_bank
from openpbso_tpu.ops.integrator import _complex_weights as j_weights
from openpbso_tpu_torch.convert import bank_from_numpy, span_tables_from_numpy
from openpbso_tpu_torch.ops import span as ts
from openpbso_tpu_torch.ops import span_inject as k3
from openpbso_tpu_torch.ops import span_reduce as k4

O, M = 3, 40


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: intra-op threads only slow them down, and
    under the suite's parallel workers they oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lam(shared, seed=0):
    """[O, M] complex128 eigenvalues of ringing modes (one row repeated for
    a shared bank)."""
    rng = np.random.default_rng(seed)
    rows = 1 if shared else O
    lam = (rng.uniform(0.995, 0.99995, (rows, M))
           * np.exp(1j * rng.uniform(0.01, 3.0, (rows, M))))
    return np.repeat(lam, O, axis=0) if shared else lam


def _table(shared, c):
    """The baby table lam^r, r in [0, C], as the port builds it ([Og, C+1,
    M] float32 re and im) and as numpy arrays for the JAX package."""
    t = ts.build_span_tables(_lam(shared), 2 * c, radix=c, num_modes=M,
                             device="cpu")
    assert t.shared == shared and t.chunk == c
    return t.b_re, t.b_im


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _jax_inject(f, be_re, be_im, b_re, b_im):
    """openpbso_tpu/ops/span.py:587-594 on f [O, K, N]."""
    o, k, n = f.shape
    c = b_re.shape[1] - 1
    x, m = n // c, b_re.shape[-1]
    rows = jnp.asarray(f).reshape(o, k, x, c)[..., ::-1].reshape(o, k * x, c)
    t_re = js._contract_xm(rows, jnp.asarray(b_re)[:, :c]).reshape(o, k, x, m)
    t_im = js._contract_xm(rows, jnp.asarray(b_im)[:, :c]).reshape(o, k, x, m)
    be_re, be_im = jnp.asarray(be_re), jnp.asarray(be_im)
    inj_re = jnp.sum(be_re[:, :, None, :] * t_re
                     - be_im[:, :, None, :] * t_im, axis=1)
    inj_im = jnp.sum(be_re[:, :, None, :] * t_im
                     + be_im[:, :, None, :] * t_re, axis=1)
    return np.asarray(inj_re), np.asarray(inj_im)


def _jax_reduce(t_re, t_im, v_re, v_im, b_re, b_im, off, add):
    """_complex_weights then the _contract_xr pair, as
    openpbso_tpu/ops/span.py:557-572 (off 0) and :602-619 (off 1) compose
    them on listener rows [O, L, M]."""
    o, r, m = v_re.shape
    nl = t_re.shape[1]
    c = b_re.shape[1] - 1
    w_pr, w_pi = j_weights(
        jnp.asarray(t_re)[:, :, None, :],
        None if t_im is None else jnp.asarray(t_im)[:, :, None, :],
        jnp.asarray(v_re)[:, None], jnp.asarray(v_im)[:, None])
    out = (js._contract_xr(w_pr.reshape(o, nl * r, m),
                           jnp.asarray(b_re)[:, off:off + c])
           + js._contract_xr(w_pi.reshape(o, nl * r, m),
                             jnp.asarray(b_im)[:, off:off + c]))
    out = np.asarray(out).reshape(o, nl, r, c)
    return out if add is None else out + add


# ---------------------------------------------------- the twins vs JAX


@pytest.mark.parametrize("x,c", [(4, 64), (5, 192)])   # ragged X, C = 192
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("shared", [True, False])
def test_span_inject_twin_matches_jax(shared, k, x, c, dberr):
    b_re, b_im = _table(shared, c)
    rng = np.random.default_rng(k * 100 + x)
    f, be_re, be_im = (_rand(rng, O, k, x * c), _rand(rng, O, k, M),
                       _rand(rng, O, k, M))
    ref = _jax_inject(f, be_re, be_im, b_re.numpy(), b_im.numpy())
    before = k3.LAUNCHES
    got = k3.span_inject(*(torch.from_numpy(a) for a in (f, be_re, be_im)),
                         b_re, b_im)
    assert k3.LAUNCHES == before           # CPU tensors: the twin
    for g, r in zip(got, ref):
        assert g.shape == (O, x, M) and g.dtype == torch.float32
        assert np.abs(r).max() > 0
        assert dberr(g.numpy(), r) <= -100


@pytest.mark.parametrize("r,c", [(4, 64), (5, 192)])
@pytest.mark.parametrize("add", [False, True])
@pytest.mark.parametrize("off", [0, 1])
@pytest.mark.parametrize("rows", ["real", "complex"])
@pytest.mark.parametrize("nl", [1, 2])
@pytest.mark.parametrize("shared", [True, False])
def test_span_reduce_twin_matches_jax(shared, nl, rows, off, add, r, c,
                                      dberr):
    b_re, b_im = _table(shared, c)
    rng = np.random.default_rng(nl * 1000 + off * 100 + r)
    t_re = _rand(rng, O, nl, M)
    t_im = _rand(rng, O, nl, M) if rows == "complex" else None
    v_re, v_im = _rand(rng, O, r, M), _rand(rng, O, r, M)
    extra = _rand(rng, O, nl, r, c) if add else None
    ref = _jax_reduce(t_re, t_im, v_re, v_im, b_re.numpy(), b_im.numpy(),
                      off, extra)
    before = k4.LAUNCHES

    def t(a):
        return None if a is None else torch.from_numpy(a)
    got = k4.span_reduce(t(t_re), t(t_im), t(v_re), t(v_im), b_re, b_im,
                         off, t(extra))
    assert k4.LAUNCHES == before
    assert got.shape == (O, nl, r, c) and got.dtype == torch.float32
    assert np.abs(ref).max() > 0
    assert dberr(got.numpy(), ref) <= -100


@pytest.mark.parametrize("c", [64, 256])
@pytest.mark.parametrize("nl,rows", [(1, "real"), (2, "complex")])
def test_span_reduce_twin_matches_jax_shared_full_bucket(nl, rows, c, dberr):
    """g on a shared table at a full slot bucket and the AR slot (K = 17),
    a corner of phase 13's shared g grid: one listener row or a binaural
    scene's two complex rows."""
    b_re, b_im = _table(True, c)
    rng = np.random.default_rng(nl * 10 + c)
    t_re = _rand(rng, O, nl, M)
    t_im = _rand(rng, O, nl, M) if rows == "complex" else None
    v_re, v_im = _rand(rng, O, 17, M), _rand(rng, O, 17, M)
    ref = _jax_reduce(t_re, t_im, v_re, v_im, b_re.numpy(), b_im.numpy(), 0,
                      None)
    before = k4.LAUNCHES
    got = k4.span_reduce(torch.from_numpy(t_re),
                         None if t_im is None else torch.from_numpy(t_im),
                         torch.from_numpy(v_re), torch.from_numpy(v_im),
                         b_re, b_im, 0)
    assert k4.LAUNCHES == before
    assert got.shape == (O, nl, 17, c)
    assert np.abs(ref).max() > 0
    assert dberr(got.numpy(), ref) <= -100


# --------------------------------------------------------- the wrappers


def _inject_args(k=1, x=3, c=64, shared=True):
    b_re, b_im = _table(shared, c)
    rng = np.random.default_rng(1)
    return [torch.from_numpy(_rand(rng, O, k, x * c)),
            torch.from_numpy(_rand(rng, O, k, M)),
            torch.from_numpy(_rand(rng, O, k, M)), b_re, b_im]


def _reduce_args(nl=1, r=3, c=64, shared=True):
    b_re, b_im = _table(shared, c)
    rng = np.random.default_rng(2)
    return [torch.from_numpy(_rand(rng, O, nl, M)), None,
            torch.from_numpy(_rand(rng, O, r, M)),
            torch.from_numpy(_rand(rng, O, r, M)), b_re, b_im, 1]


@pytest.mark.parametrize("i,bad", [
    (0, lambda a: a.double()),                  # f in float64
    (1, lambda a: a.to(torch.int32)),           # be as integers
    (0, lambda a: a[..., :-1]),                 # N not a multiple of C
    (1, lambda a: a[:, :, :-1]),                # be of other modes
    (3, lambda a: torch.cat([a, a])),           # 2 tables for 3 objects
    (4, lambda a: a[:, :-1]),                   # re and im tables differ
])
def test_span_inject_refuses_bad_inputs(i, bad):
    args = _inject_args()
    args[i] = bad(args[i])
    with pytest.raises(ValueError):
        k3.span_inject(*args)


@pytest.mark.parametrize("i,bad", [
    (0, lambda a: a.double()),                  # t in float64
    (2, lambda a: a.half()),                    # v in float16
    (0, lambda a: a[..., :-1]),                 # t of other modes
    (1, lambda a: torch.zeros((O, 2, M))),      # t_im of other rows
    (3, lambda a: a[:, :-1]),                   # v_im of other rows
    (4, lambda a: torch.cat([a, a])),           # 2 tables for 3 objects
    (6, lambda a: 2),                           # a table row offset of 2
])
def test_span_reduce_refuses_bad_inputs(i, bad):
    args = _reduce_args()
    args[i] = bad(args[i])
    with pytest.raises(ValueError):
        k4.span_reduce(*args)


def test_span_reduce_refuses_an_add_of_another_shape():
    args = _reduce_args()
    with pytest.raises(ValueError, match="shape mismatch"):
        k4.span_reduce(*args, torch.zeros((O, 1, 3, 63)))


def test_span_kernel_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor a CUDA device gets no kernel and no
    fallback."""
    args = [a.to("meta") for a in _inject_args()]
    with pytest.raises(ValueError, match="no span_inject kernel"):
        k3.span_inject(*args)
    args = [a.to("meta") if isinstance(a, torch.Tensor) else a
            for a in _reduce_args()]
    with pytest.raises(ValueError, match="no span_reduce kernel"):
        k4.span_reduce(*args)


def test_span_inject_refuses_no_slots():
    with pytest.raises(ValueError, match="shape mismatch"):
        k3.span_inject(*_inject_args(k=0))


@pytest.mark.parametrize("x", [k3.STACKED_CHUNKS + 1, 40])
def test_stacked_variant_refuses_many_chunks(x):
    """The stacked variant takes at most STACKED_CHUNKS chunks an object;
    more raise before anything is built, whatever the device."""
    args = _inject_args(k=17, x=x, shared=False)
    with pytest.raises(ValueError, match="stacked"):
        k3._launch(*args, None, "stacked")


@pytest.mark.parametrize("nl,r", [(1, k4.SPLIT_ROWS + 1), (2, 17)])
def test_split_variant_refuses_many_rows(nl, r):
    """The split variant takes at most SPLIT_ROWS rows (L R) an object;
    more raise before anything is built, whatever the device."""
    args = _reduce_args(nl=nl, r=r, shared=False)
    with pytest.raises(ValueError, match="split"):
        k4._launch(*args, None, None, "split")


# ------------------------------------------ the span through the wrappers


@pytest.fixture(scope="module")
def span_banks():
    """layout -> (JAX bank, port bank, lam64) of O x M modes."""
    out = {}
    for layout in ("shared", "hetero"):
        lam = _lam(layout == "shared", seed=3)
        b = np.random.default_rng(4).uniform(0.5, 1.5, (O, M))
        jb = build_modal_bank(lam, b, np.ones((O, M), bool), block_size=64,
                              pad_modes_to=8, shared=layout == "shared",
                              dtype=jnp.float32)
        assert jb.num_modes == M
        out[layout] = (jb, bank_from_numpy(jax.tree.map(np.asarray, jb),
                                           device="cpu"), lam)
    return out


@pytest.fixture
def wrapper_calls(monkeypatch):
    """Count the span module's calls of span_inject and span_reduce."""
    calls = {"span_inject": 0, "span_reduce": 0}

    def counted(name, fn):
        def call(*args):
            calls[name] += 1
            calls[f"{name} planes"] = args[-1] is not None and not (
                isinstance(args[-1], (int, torch.Tensor)))
            return fn(*args)
        return call
    for name in calls:
        monkeypatch.setattr(ts, name, counted(name, getattr(ts, name)))
    return calls


@pytest.mark.parametrize("planes", [False, True])
@pytest.mark.parametrize("rows", ["plain", "listeners", "complex"])
@pytest.mark.parametrize("layout", ["shared", "hetero"])
def test_chunked_span_through_the_wrappers_matches_jax(
        span_banks, layout, rows, planes, wrapper_calls, dberr):
    """integrate_span (one span_inject, two span_reduce) and decay_span
    (one span_reduce) of the chunked form against the JAX package's, on
    plain, [L = 2, O, M] listener and complex rows; with ``planes`` the
    tables carry their SpanPlanes, as a session's do, and the wrappers
    take them."""
    jbank, tbank, lam = span_banks[layout]
    n, c = 8 * 64, 128
    jt = js.build_span_tables(lam, n, radix=c, num_modes=M)
    tt = span_tables_from_numpy(jax.tree.map(np.asarray, jt), device="cpu")
    assert isinstance(tt, ts.ChunkSpanTables) and tt.n_chunks == 4
    assert tt.planes is None        # left to be made where the tables live
    if planes:
        tt = ts.with_planes(tt)
    rng = np.random.default_rng(7)
    k = 2
    z = [_rand(rng, O, M) * 1e-3 for _ in range(2)]
    space, f = _rand(rng, O, k, M), _rand(rng, O, k, n)
    shape = (2, O, M) if rows == "listeners" else (O, M)
    tr = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    ti = (rng.uniform(-1, 1, shape).astype(np.float32)
          if rows == "complex" else None)

    def j(a):
        return None if a is None else jnp.asarray(a)

    def t(a):
        return None if a is None else torch.from_numpy(a)
    ref = js.integrate_span(j(z[0]), j(z[1]), jbank, jt, j(space), j(f),
                            j(tr), transfer_im=j(ti))
    before = (k3.LAUNCHES, k4.LAUNCHES)
    got = ts.integrate_span(t(z[0]), t(z[1]), tbank, tt, t(space), t(f),
                            t(tr), transfer_im=t(ti))
    assert (wrapper_calls["span_inject"], wrapper_calls["span_reduce"]) == (
        1, 2)
    assert wrapper_calls["span_inject planes"] == planes
    assert wrapper_calls["span_reduce planes"] == planes
    for g, r in zip(got, ref):
        assert np.abs(np.asarray(r)).max() > 0
        assert dberr(g.numpy(), np.asarray(r)) <= -100
    ref = js.decay_span(j(z[0]), j(z[1]), jbank, jt, j(tr),
                        transfer_im=j(ti))
    got = ts.decay_span(t(z[0]), t(z[1]), tbank, tt, t(tr),
                        transfer_im=t(ti))
    assert (wrapper_calls["span_inject"], wrapper_calls["span_reduce"]) == (
        1, 3)
    assert wrapper_calls["span_reduce planes"] == planes
    assert (k3.LAUNCHES, k4.LAUNCHES) == before
    for g, r in zip(got, ref):
        assert dberr(g.numpy(), np.asarray(r)) <= -100


# ------------------------------------------------------------ the planes


@pytest.mark.parametrize("c", [64, 192])
@pytest.mark.parametrize("shared", [True, False])
def test_span_planes_split_the_table_exactly(shared, c):
    """span_planes on tables bitwise the JAX package's build_span_tables:
    hi (the table with its low 13 bits cleared, what the tensor cores read
    of it) + lo == the table bitwise, and the inject copy is the table's
    first C rows reversed and transposed, [Og, M, C], with its own lo
    plane, bitwise."""
    lam = _lam(shared)
    jt = js.build_span_tables(lam, 2 * c, radix=c, num_modes=M)
    b_re, b_im = _table(shared, c)
    assert np.array_equal(b_re.numpy(), np.asarray(jt.b_re))
    assert np.array_equal(b_im.numpy(), np.asarray(jt.b_im))
    before = ts.PLANE_BUILDS
    p = ts.span_planes(b_re, b_im)
    assert ts.PLANE_BUILDS == before + 1

    def hi(x):
        return (x.view(torch.int32) & -8192).view(torch.float32)
    for b, lo, bt, bt_lo in ((b_re, p.lo_re, p.bt_re, p.bt_lo_re),
                             (b_im, p.lo_im, p.bt_im, p.bt_lo_im)):
        assert lo.shape == b.shape and bt.shape == (b.shape[0], M, c)
        assert torch.equal(hi(b) + lo, b)
        assert not (hi(b).view(torch.int32) & 0x1FFF).any()
        assert torch.equal(bt, b[:, :c].flip(1).transpose(1, 2))
        assert bt.is_contiguous() and lo.is_contiguous()
        assert torch.equal(hi(bt) + bt_lo, bt)
        assert torch.equal(bt_lo, lo[:, :c].flip(1).transpose(1, 2))
        assert lo.abs().max() > 0 and lo.abs().max() < 2e-3 * b.abs().max()


def test_span_planes_refuse_other_dtypes():
    b = torch.zeros((1, 5, 8), dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        ts.span_planes(b, b)


def test_with_planes_builds_once_and_keeps_given_planes():
    b_re, b_im = _table(False, 64)
    t = ts.ChunkSpanTables(b_re=b_re, b_im=b_im, n_chunks=2)
    before = ts.PLANE_BUILDS
    tp = ts.with_planes(t)
    assert ts.PLANE_BUILDS == before + 1 and tp.planes is not None
    assert ts.with_planes(tp) is tp and ts.PLANE_BUILDS == before + 1
    short = ts.dataclasses.replace(tp, n_chunks=1)
    assert short.planes is tp.planes        # a span length keeps them
    t64 = ts.ChunkSpanTables(b_re=b_re.double(), b_im=b_im.double(),
                             n_chunks=2)
    assert ts.with_planes(t64).planes is None   # the kernels take float32


@pytest.mark.parametrize("shared", [True, False])
def test_wrappers_take_planes_on_the_cpu(shared):
    """CPU tensors run the twin whether or not planes are given: the
    same result, bitwise."""
    rng = np.random.default_rng(21)
    b_re, b_im = _table(shared, 64)
    p = ts.span_planes(b_re, b_im)
    f = torch.from_numpy(_rand(rng, O, 2, 3 * 64))
    be = [torch.from_numpy(_rand(rng, O, 2, M)) for _ in range(2)]
    for a, b in zip(k3.span_inject(f, *be, b_re, b_im),
                    k3.span_inject(f, *be, b_re, b_im, p)):
        assert torch.equal(a, b)
    t = torch.from_numpy(_rand(rng, O, 1, M))
    v = [torch.from_numpy(_rand(rng, O, 3, M)) for _ in range(2)]
    add = torch.from_numpy(_rand(rng, O, 1, 3, 64))
    assert torch.equal(k4.span_reduce(t, None, *v, b_re, b_im, 1, add),
                       k4.span_reduce(t, None, *v, b_re, b_im, 1, add, p))


# ----------------------------------------------------------- the routing


@pytest.mark.parametrize("args,want", [
    ((256, 1, 512, 512, 1024, 1), "wgmma"),       # hom, shared nb=512
    ((256, 1, 1024, 512, 1024, 256), "wgmma"),    # hom, hetero nb=1024
    ((256, 2, 20, 512, 1024, 1), "wgmma"),        # hom, shared, L = 2
    ((256, 1, 1, 512, 1024, 1), "cluster"),       # g, shared: 256 rows
    ((256, 1, 1, 512, 1024, 256), "fp32"),        # g, per-object
    ((256, 2, 2, 512, 1024, 256), "fp32"),        # g, per-object, L R = 4
    ((256, 1, 16, 512, 1024, 256), "mma16"),      # hom, hetero nb=16
    ((256, 1, 17, 64, 1024, 256), "split"),       # g, one-block span
    ((256, 1, 5, 512, 1024, 256), "mma16"),       # g, per-object, 5 slots
    ((256, 1, 1, 512, 42, 256), "mma16"),         # g, 42 modes: no float4
    ((256, 2, 16, 512, 1024, 256), "mma16"),      # 8c's L = 2 hom
    ((64, 1, 16, 512, 512, 64), "mma16"),         # a (2, 2) shard's hom
    ((64, 1, 1, 512, 512, 64), "fp32"),           # a (2, 2) shard's g
    ((256, 1, 512, 512, 42, 1), "mma64"),         # 42 modes: no TMA
    ((3, 1, 40, 64, 128, 1), "cluster"),          # a shared table, few rows
    ((256, 1, 17, 256, 1024, 256), "split"),      # g, four-block span
    ((256, 1, 8, 64, 1024, 256), "split"),        # hom, one-block span
    ((256, 1, 8, 256, 1024, 256), "split"),       # hom, four-block span
    ((256, 1, 5, 64, 1024, 256), "split"),        # g, 5 slots, C = 64
    ((256, 1, 16, 64, 1024, 256), "split"),       # g, bucket, no AR
    ((256, 2, 17, 64, 1024, 256), "mma16"),       # L R = 34 rows
    # g on a shared table at the span's chunks, slots and listener rows
    ((256, 1, 1, 64, 1024, 1), "cluster"),        # C = 64, one row
    ((256, 2, 1, 64, 1024, 1), "cluster"),        # C = 64, two rows
    ((256, 1, 1, 256, 1024, 1), "cluster"),       # C = 256
    ((256, 2, 1, 256, 1024, 1), "cluster"),       # C = 256, two rows
    ((256, 2, 1, 512, 1024, 1), "cluster"),       # 8c's g: 512 x 4 tiles
    ((256, 1, 17, 64, 1024, 1), "mma16"),         # a full bucket, C = 64
    ((256, 2, 17, 64, 1024, 1), "mma16"),         # and two rows
    ((256, 1, 17, 256, 1024, 1), "mma16"),        # a full bucket, C = 256
    ((256, 2, 17, 256, 1024, 1), "wgmma"),        # and two rows
    ((256, 1, 17, 512, 1024, 1), "wgmma"),        # a full bucket, C = 512
    ((256, 1, 8, 64, 1024, 1), "cluster"),        # hom, a shared one-block
    ((256, 1, 8, 256, 1024, 1), "cluster"),       # hom, 2048 x 2 tiles
    ((256, 1, 8, 512, 1024, 1), "mma16"),         # hom, 2048 x 4 tiles
])
def test_span_reduce_variant_by_shape(args, want):
    """The variant follows from the shape alone: the same answer every
    time, wgmma where one table's rows fill 128-row tiles that fill the
    card."""
    assert k4.variant_for(*args) == want
    assert k4.variant_for(*args) == want
    assert want in k4.VARIANTS


@pytest.mark.parametrize("args,want", [
    ((256, 1, 512, 512, 1024, 1), "wgmma"),       # shared nb=512
    ((256, 1, 1024, 512, 1024, 256), "wgmma"),    # hetero nb=1024
    ((256, 1, 16, 512, 1024, 1), "wgmma"),        # shared nb=16
    ((256, 1, 16, 512, 1024, 256), "mma16"),      # hetero nb=16
    ((256, 4, 16, 512, 1024, 256), "mma16"),      # hetero nb=16, K = 4
    ((256, 17, 8, 64, 1024, 256), "stacked"),     # one-block, full bucket
    ((64, 1, 16, 512, 512, 64), "mma16"),         # a (2, 2) shard
    ((256, 1, 512, 7, 1024, 1), "mma64"),         # odd chunk: no TMA
    ((70, 3, 20, 64, 1024, 1), "wgmma"),          # 128-row tiles cross objects
    ((70, 3, 20, 64, 384, 1), "mma16"),           # too few tiles
    ((256, 17, 8, 256, 1024, 256), "stacked"),    # four-block, full bucket
    ((256, 3, 8, 64, 1024, 256), "stacked"),      # one-block, 3 slots
    ((256, 2, 8, 64, 1024, 256), "mma16"),        # one-block, 2 slots
    ((256, 17, 8, 512, 1024, 256), "mma16"),      # X = 8 chunks of 512
    ((256, 17, 9, 64, 1024, 256), "mma16"),       # 9 chunks
    ((256, 16, 8, 64, 1024, 256), "stacked"),     # one-block, bucket, no AR
    ((256, 17, 8, 128, 1024, 256), "stacked"),    # two-block span
    ((256, 17, 8, 64, 1024, 1), "wgmma"),         # a shared table
])
def test_span_inject_variant_by_shape(args, want):
    assert k3.variant_for(*args) == want
    assert k3.variant_for(*args) == want
    assert want in k3.VARIANTS
