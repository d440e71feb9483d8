"""GPU-only tests of the port: the CUDA kernels against their plain twins.

They skip without a CUDA device. This file imports no jax, so it also runs
on a GPU machine that has no JAX installed (tests/conftest.py imports jax;
skip it there):

    python -m pytest --noconftest -m cuda tests/test_torch_gpu.py -q
"""
import os

import numpy as np
import pytest
import torch

from openpbso_tpu_torch.config import REBASE_PERIOD
from openpbso_tpu_torch.ops import ar_block as kb
from openpbso_tpu_torch.ops import ar_noise as ka
from openpbso_tpu_torch.ops import chunk_scan as k1
from openpbso_tpu_torch.ops import fused_integrator as fi
from openpbso_tpu_torch.ops import span_inject as k3
from openpbso_tpu_torch.ops import span as span_mod
from openpbso_tpu_torch.ops import span_reduce as k4
from openpbso_tpu_torch.ops import toeplitz_conv as k2
from openpbso_tpu_torch.ops.coeffs import build_modal_bank, lambda_from_modes
from openpbso_tpu_torch.ops.forces import ar_impulse_g, make_sustained_state
from openpbso_tpu_torch.ops.integrator import step_block_blocked
from openpbso_tpu_torch.ops.span import build_span_tables, span_planes
from openpbso_tpu_torch.runtime.session import ModalSession
from openpbso_tpu_torch.runtime.solver import SolverConfig
from openpbso_tpu_torch.utils.synth import CERAMIC, synth_mode_data

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _db(test, ref) -> float:
    test = np.asarray(test, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.linalg.norm(test - ref)
    return -np.inf if err == 0 else 20 * np.log10(err / np.linalg.norm(ref))


def _modes(o, n, shared):
    """(lam, b, valid) [O, n]: per-object frequency ranges make a
    heterogeneous bank; one range for every object a shared one."""
    offsets = [0] * o if shared else range(o)
    parts = [lambda_from_modes(CERAMIC.density, synth_mode_data(
        n, 8, seed=7, f_low=100.0 + i, f_high=15000.0 + 3 * i).omega_squared,
        CERAMIC.alpha, CERAMIC.beta) for i in offsets]
    return tuple(np.stack(x) for x in zip(*parts))


def _bank(o, n, s, shared, device):
    """build_modal_bank stores the tables once for a shared mode set."""
    return build_modal_bank(*_modes(o, n, shared), block_size=s,
                            device=device)


def _inputs(bank, s, seed=0):
    rng = np.random.default_rng(seed)
    o, m = bank.num_objects, bank.num_modes
    mask = bank.mask.cpu().numpy()
    arrays = [rng.standard_normal((o, m)) * mask,
              rng.standard_normal((o, m)) * mask,
              rng.standard_normal((o, m)) * mask,
              rng.standard_normal((o, s)),
              rng.uniform(0.5, 2.0, (o, m))]
    zr, zi, sp, tp, tr = (torch.as_tensor(a, dtype=torch.float32,
                                          device=bank.device) for a in arrays)
    return zr, zi, bank, sp, tp, tr


@pytest.mark.parametrize("o,n,s,chunk,shared", [
    (5, 40, 256, 64, False),      # ragged: 40 modes padded to 128
    (4, 200, 512, 64, True),      # shared tables, read with stride 0
    (3, 300, 512, 256, False),    # chunk wider than a block's threads
    (2, 24, 32, 64, False),       # chunk > S clamps to one chunk
    (16, 1024, 512, 64, False),   # a full cluster of 8 tiles
    (3, 1100, 512, 64, False),    # 1152 modes: 9 tiles, blocks walk tiles
    (2, 1024, 512, 256, False),   # a chunk of 256: 16 tiles of 64 modes
])
def test_kernel_matches_twin(cuda, o, n, s, chunk, shared):
    """Both mode contractions run as 3xTF32 on the tensor cores: <= -110
    dB against the FP32 twin, <= -90 dB against blocked, bitwise
    repeatable."""
    bank = _bank(o, n, s, shared, cuda)
    assert bank.shared_tables == shared
    args = _inputs(bank, s)
    before = fi.LAUNCHES
    got = fi.step_block_fused(*args, chunk=chunk)[:3]
    again = fi.step_block_fused(*args, chunk=chunk)[:3]
    assert fi.LAUNCHES == before + 2
    ref = fi.fused_block_reference(*args, chunk=chunk)
    blocked = step_block_blocked(*args)[:3]
    for k, a, r, b in zip(got, again, ref, blocked):
        assert torch.equal(k, a)                       # deterministic
        assert torch.isfinite(k).all()
        assert _db(k.cpu(), r.cpu()) <= -110
        assert _db(k.cpu(), b.cpu()) <= -90


def test_fused_kernel_refuses_strided_rows(cuda):
    """The wrapper checks contiguity instead of copying."""
    bank = _bank(2, 40, 64, False, cuda)
    zr, zi, _, sp, tp, tr = _inputs(bank, 64)
    wide = torch.zeros((2, 2 * bank.num_modes), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fi.step_block_fused(wide[:, ::2], zi, bank, sp, tp, tr)


def test_matmul_precision_pin_at_production_shape(cuda):
    """TF32 would keep ~10 mantissa bits (about -60 dB here); the pinned
    float32 product must stay near float32 rounding."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((256, 1024)).astype(np.float32)
    b = rng.standard_normal((1024, 512)).astype(np.float32)
    got = (torch.from_numpy(a).to(cuda) @ torch.from_numpy(b).to(cuda)).cpu()
    ref = a.astype(np.float64) @ b.astype(np.float64)
    assert _db(got, ref) <= -120


def test_session_steps_through_the_kernel(cuda):
    bank = _bank(6, 40, 256, False, cuda)
    assert not bank.shared_tables
    sessions = {name: ModalSession(bank, config=SolverConfig(
        block_size=256, backend=name)) for name in ("auto", "blocked")}
    rng = np.random.default_rng(2)
    for obj in range(6):
        space = rng.standard_normal(40)
        for sess in sessions.values():
            sess.hit(obj, space, kind="gaussian", width_us=600.0,
                     when=256 * (obj % 3))
    before = fi.LAUNCHES
    mix = sessions["auto"].render(10)
    busy = fi.LAUNCHES - before
    # slots expire at 260, 516 and 772: blocks at 0, 256, 512, 768 are busy
    assert busy == 4
    assert np.isfinite(mix).all() and np.abs(mix).max() > 0
    assert _db(mix, sessions["blocked"].render(10)) <= -90


def _randn(rng, *shape, device):
    return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                           device=device)


def _assert_kernel_matches_twin(got, again, ref, db=-100):
    for k, a, r in zip(got, again, ref):
        assert torch.equal(k, a)                       # deterministic
        assert torch.isfinite(k).all()
        assert _db(k.cpu(), r.cpu()) <= db


@pytest.mark.parametrize("o,n,chunk,n_chunks,shared,decay", [
    (4, 200, 64, 8, True, False),     # shared lam^C rows, stride 0
    (3, 300, 512, 40, False, False),  # per-object rows, the long chunk
    (5, 40, 64, 17, False, False),    # ragged: 40 modes padded to 128
    (3, 300, 512, 9, True, True),     # ring-down: no injections
    (2, 40, 64, 16, False, True),
])
def test_chunk_scan_matches_twin(cuda, o, n, chunk, n_chunks, shared, decay):
    tables = build_span_tables(_modes(o, n, shared)[0], chunk * n_chunks,
                               radix=chunk, device=cuda)
    assert tables.shared == shared and tables.n_chunks == n_chunks
    m = tables.b_re.shape[-1]
    rng = np.random.default_rng(4)
    z = [_randn(rng, o, m, device=cuda) for _ in range(2)]
    inj = ([None, None] if decay else
           [_randn(rng, o, n_chunks, m, device=cuda) for _ in range(2)])
    args = (*z, tables.b_re[:, chunk], tables.b_im[:, chunk], n_chunks, *inj)
    before = k1.LAUNCHES
    got = k1.chunk_scan(*args)
    again = k1.chunk_scan(*args)
    assert k1.LAUNCHES == before + 2
    _assert_kernel_matches_twin(got, again, k1.chunk_scan_reference(*args))


@pytest.mark.parametrize("o,nl,k,x,c", [
    (3, 1, 1, 8, 64),
    (2, 1, 1, 40, 512),               # the long chunk, 2 row tiles
    (2, 3, 2, 17, 64),                # listener rows, slots, ragged tile
    (2, 3, 1, 5, 512),
    (2, 1, 3, 3, 7),                  # odd chunk: 4-byte copies, one tile
    (3, 2, 1, 37, 7),                 # odd chunk, ragged rows
    (2, 1, 1, 33, 192),               # a 3-block span's chunk, ragged rows
    (4, 1, 16, 8, 64),                # a one-block span, full slot bucket
    (2, 3, 2, 40, 128),               # listener rows and slots, ragged
    (2, 1, 2, 3, 1),                  # one-sample chunks
    (1, 1, 1, 9, 600),                # two column groups
    (1, 2, 1, 5, 513),                # two column groups, odd chunk
    (256, 1, 1, 512, 512),            # the span headline (shared nb=512)
    (64, 2, 3, 100, 64),              # more items than resident blocks
    (140, 1, 1, 17, 1700),            # one stage buffer, many items
    (1, 1, 2, 5, 3000),               # near the widest chunk it takes
    (2, 1, 0, 5, 64),                 # no slots: zeros
])
def test_toeplitz_conv_matches_twin(cuda, o, nl, k, x, c):
    """The 3xTF32 tensor-core kernel is FP32-accurate: <= -110 dB against
    the FP32 twin at every shape, and bitwise repeatable."""
    rng = np.random.default_rng(5)
    g = _randn(rng, o, nl, k, c, device=cuda)
    f = _randn(rng, o, k, x, c, device=cuda)
    before = k2.LAUNCHES
    got = k2.toeplitz_conv(g, f)
    again = k2.toeplitz_conv(g, f)
    assert k2.LAUNCHES == before + 2
    assert got.shape == (o, nl, x, c)
    _assert_kernel_matches_twin([got], [again],
                                [k2.toeplitz_conv_reference(g, f)], db=-110)


TOEPLITZ_CASES = [   # O, L, K, X, C: every variant held at each, forced
    (4, 1, 17, 8, 64),                # one-block span, full bucket + AR
    (3, 2, 17, 8, 256),               # four-block span, two listener rows
    (5, 1, 1, 8, 64),                 # one-block span, plain stream
    (3, 1, 1, 8, 256),                # four-block span, plain stream
    (2, 1, 3, 5, 192),                # three-block span, ragged chunks
    (2, 2, 2, 3, 30),                 # C of no whole float4 or m16 tile
    (2, 1, 0, 8, 64),                 # no slots: zeros
    (2, 1, 2, 9, 64),                 # nine chunks: short refuses
    (1, 1, 1, 8, 512),                # chunks of 512: short refuses
]


@pytest.mark.parametrize("variant", k2.VARIANTS)
@pytest.mark.parametrize("o,nl,k,x,c", TOEPLITZ_CASES)
def test_every_toeplitz_variant_matches_twin(cuda, o, nl, k, x, c, variant):
    """Each of the kernel's variants, whatever variant_for would pick,
    <= -110 dB against the twin and bitwise repeatable; short refuses
    more than 8 chunks or 256 samples before it builds anything."""
    rng = np.random.default_rng(18)
    g = _randn(rng, o, nl, k, c, device=cuda)
    f = _randn(rng, o, k, x, c, device=cuda)
    if variant == "short" and (x > 8 or c > 256):
        with pytest.raises(ValueError, match="short"):
            k2._launch(g, f, variant)
        return
    got = k2._launch(g, f, variant)
    again = k2._launch(g, f, variant)
    assert got.shape == (o, nl, x, c)
    _assert_kernel_matches_twin([got], [again],
                                [k2.toeplitz_conv_reference(g, f)], db=-110)


def test_short_toeplitz_takes_misaligned_views(cuda):
    """The short variant on views 4 bytes off a 16-byte boundary takes
    its 4-byte copies; the wrapper routes the shape there."""
    rng = np.random.default_rng(19)
    g = _randn(rng, 3 * 17 * 64 + 1, device=cuda)[1:].reshape(3, 1, 17, 64)
    f = _randn(rng, 3 * 17 * 8 * 64 + 1, device=cuda)[1:].reshape(
        3, 17, 8, 64)
    assert g.data_ptr() % 16 != 0 and f.data_ptr() % 16 != 0
    assert k2.variant_for(3, 1, 17, 8, 64) == "short"
    before = k2.LAUNCHES
    got, again = k2.toeplitz_conv(g, f), k2.toeplitz_conv(g, f)
    assert k2.LAUNCHES == before + 2
    _assert_kernel_matches_twin([got], [again],
                                [k2.toeplitz_conv_reference(g, f)], db=-110)


def test_toeplitz_conv_takes_unaligned_rows(cuda):
    """Views that start off a 16-byte boundary take the 4-byte copies."""
    rng = np.random.default_rng(6)
    g = _randn(rng, 2, 1, 1, 65, device=cuda)[..., 1:]
    f = _randn(rng, 2 * 1 * 9 * 64 + 1, device=cuda)[1:].reshape(2, 1, 9, 64)
    assert f.data_ptr() % 16 != 0
    got = k2.toeplitz_conv(g, f)
    _assert_kernel_matches_twin([got], [k2.toeplitz_conv(g, f)],
                                [k2.toeplitz_conv_reference(g, f)], db=-110)


def test_toeplitz_conv_refuses_a_chunk_it_cannot_hold(cuda):
    g = torch.zeros((1, 1, 1, 3100), device=cuda)
    f = torch.zeros((1, 1, 2, 3100), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        k2.toeplitz_conv(g, f)


def test_render_multi_spans_through_both_kernels(cuda):
    """Every span dispatch runs the chunk scan; the ones with live forces
    also run the Toeplitz convolution, and none runs the per-block kernel."""
    lam, b, v = _modes(6, 40, False)
    bank = build_modal_bank(lam, b, v, block_size=256, device=cuda)
    sessions = {
        "span": ModalSession(bank, config=SolverConfig(block_size=256),
                             lam64=lam),
        "blocked": ModalSession(bank, config=SolverConfig(
            block_size=256, backend="blocked"))}
    rng = np.random.default_rng(2)
    for obj in range(6):
        space = rng.standard_normal(40)
        for sess in sessions.values():
            sess.hit(obj, space, kind="gaussian", width_us=600.0,
                     when=256 * (obj % 3))
    before = (k1.LAUNCHES, k2.LAUNCHES, fi.LAUNCHES)
    mix = sessions["span"].render_multi(10, blocks_per_dispatch=4)
    # dispatches start at blocks 0, 4 and 8; the last slot expires at
    # sample 772 (block 3), so only the first dispatch has live forces
    assert (k1.LAUNCHES - before[0], k2.LAUNCHES - before[1],
            fi.LAUNCHES - before[2]) == (3, 1, 0)
    assert np.isfinite(mix).all() and np.abs(mix).max() > 0
    assert _db(mix, sessions["blocked"].render(10)) <= -90


# ------------------------------------------------- the span contractions


def _span_table(o, n, c, shared, device, num_modes=None):
    """A chunked span's baby table (C + 1 powers of real modes)."""
    return build_span_tables(_modes(o, n, shared)[0], 2 * c, radix=c,
                             num_modes=num_modes, device=device)


@pytest.mark.parametrize("o,k,x,c,n,shared,num_modes", [
    (3, 1, 8, 64, 200, True, None),       # 16-chunk tile, shared table
    (2, 3, 40, 512, 300, False, None),    # per-object, slots, ragged tile
    (4, 17, 8, 64, 40, False, None),      # one-block span, full bucket + AR
    (2, 1, 33, 192, 100, True, None),     # a 3-block span's chunk, ragged
    (2, 2, 5, 7, 40, False, None),        # odd chunk: 4-byte copies
    (3, 2, 20, 64, 40, True, 42),         # 42 modes: 4-byte copies
    (2, 1, 17, 64, 40, False, 43),        # odd modes: scalar stores
    (256, 1, 512, 512, 1024, True, None),  # the span headline (nb=512)
    (70, 1, 20, 64, 1024, True, None),    # shared: 64-row tiles cross objects
    (70, 3, 20, 64, 1024, True, None),    # and slots, each row its own be
    (30, 1, 40, 192, 1024, True, None),   # wgmma: C = 192, ragged tiles
    (150, 2, 20, 64, 300, True, 384),     # wgmma: M = 384, K = 2
    (2, 3, 600, 64, 1024, False, None),   # wgmma: per-object, 600 chunks
    (200, 17, 8, 48, 1024, True, None),   # wgmma: K = 17, C ends mid-stage
])
def test_span_inject_matches_twin(cuda, o, k, x, c, n, shared, num_modes):
    """The 3xTF32 injection GEMM is FP32-accurate: <= -110 dB against the
    twin at every shape, bitwise repeatable, one launch a call."""
    tables = _span_table(o, n, c, shared, cuda, num_modes)
    m = tables.b_re.shape[-1]
    rng = np.random.default_rng(11)
    f = _randn(rng, o, k, x * c, device=cuda)
    be = [_randn(rng, o, k, m, device=cuda) for _ in range(2)]
    args = (f, *be, tables.b_re, tables.b_im)
    before = k3.LAUNCHES
    got = k3.span_inject(*args)
    again = k3.span_inject(*args)
    assert k3.LAUNCHES == before + 2
    assert got[0].shape == (o, x, m)
    _assert_kernel_matches_twin(got, again, k3.span_inject_reference(*args),
                                db=-110)


@pytest.mark.parametrize("o,nl,r,c,n,shared,cplx,off,add,num_modes", [
    (3, 1, 8, 64, 200, True, False, 1, True, None),    # hom, shared
    (2, 2, 40, 512, 300, False, True, 1, True, None),  # ITD rows, L = 2
    (4, 1, 17, 64, 40, False, False, 0, False, None),  # g, full bucket + AR
    (3, 2, 1, 512, 200, True, True, 0, False, None),   # g, one slot
    (2, 1, 33, 192, 100, True, False, 1, False, None),  # ring-down, ragged
    (2, 3, 5, 7, 40, False, True, 1, True, None),      # odd chunk: scalars
    (3, 1, 20, 64, 40, True, False, 1, True, 42),      # 42 modes: scalars
    (256, 1, 512, 512, 1024, True, False, 1, True, None),  # the headline
    (256, 2, 20, 512, 200, True, True, 1, True, None),  # tiles cross rows
    (300, 2, 20, 192, 200, True, True, 1, True, None),  # wgmma: C = 192
    (300, 1, 60, 64, 300, True, False, 0, False, 384),  # wgmma: M = 384, g
    (5, 1, 1000, 512, 200, False, False, 1, True, None),  # wgmma: per-object
    (25, 2, 300, 64, 200, False, True, 0, False, None),  # wgmma: ditto, L = 2
])
def test_span_reduce_matches_twin(cuda, o, nl, r, c, n, shared, cplx, off,
                                  add, num_modes):
    """The 3xTF32 mode-reduce GEMM with its weight prologue is
    FP32-accurate: <= -110 dB against the twin at every shape, bitwise
    repeatable, one launch a call."""
    tables = _span_table(o, n, c, shared, cuda, num_modes)
    m = tables.b_re.shape[-1]
    rng = np.random.default_rng(12)
    t_re = _randn(rng, o, nl, m, device=cuda)
    t_im = _randn(rng, o, nl, m, device=cuda) if cplx else None
    v = [_randn(rng, o, r, m, device=cuda) for _ in range(2)]
    extra = _randn(rng, o, nl, r, c, device=cuda) if add else None
    args = (t_re, t_im, *v, tables.b_re, tables.b_im, off, extra)
    before = k4.LAUNCHES
    got = k4.span_reduce(*args)
    again = k4.span_reduce(*args)
    assert k4.LAUNCHES == before + 2
    assert got.shape == (o, nl, r, c)
    _assert_kernel_matches_twin([got], [again],
                                [k4.span_reduce_reference(*args)], db=-110)


# (name, O, Og is O, K, X, C, M) of span_inject and (name, O, Og is O, L,
# R, C, M, complex, off, add) of span_reduce: every variant of each kernel
# is held against the twin at all of them, forced past variant_for
INJECT_CASES = [
    ("shared K=1", 40, False, 1, 20, 64, 256),
    ("per-object K=3", 3, True, 3, 150, 192, 128),
    ("shared K=17", 12, False, 17, 8, 64, 128),
    ("per-object C=512", 2, True, 1, 130, 512, 384),
    ("per-object X=8 K=5 C=64", 6, True, 5, 8, 64, 256),
    ("per-object X=8 K=17 C=64", 5, True, 17, 8, 64, 256),
    ("per-object X=8 K=5 C=256", 3, True, 5, 8, 256, 384),
    ("per-object X=8 K=17 C=256", 3, True, 17, 8, 256, 128),
    ("per-object X=5 K=20 C=64", 2, True, 20, 5, 64, 128),
]
REDUCE_CASES = [
    ("shared hom", 40, False, 1, 20, 64, 256, False, 1, True),
    ("per-object g, L = 2, K = 2", 30, True, 2, 2, 512, 256, True, 0, False),
    ("per-object g, K = 1", 40, True, 1, 1, 192, 384, False, 0, False),
    ("shared g, L = 2", 200, False, 2, 1, 192, 128, True, 0, False),
    ("per-object hom, L = 2", 2, True, 2, 150, 512, 384, True, 1, True),
    ("per-object g, K = 17", 9, True, 1, 17, 64, 128, False, 0, False),
    ("per-object g, K = 5", 6, True, 1, 5, 64, 256, False, 0, False),
    ("per-object g, K = 17, C = 256", 3, True, 1, 17, 256, 384, False, 0,
     False),
    ("per-object g, L = 2, K = 5", 4, True, 2, 5, 64, 256, True, 0, False),
    ("per-object g, L = 2, K = 13, C = 256", 3, True, 2, 13, 256, 128, True,
     0, False),
    ("per-object hom, X = 8, C = 256", 3, True, 1, 8, 256, 256, False, 1,
     True),
    ("shared g, K = 17, L = 2, C = 64", 12, False, 2, 17, 64, 128, True, 0,
     False),
    ("shared g, K = 17, C = 256", 9, False, 1, 17, 256, 256, False, 0,
     False),
    ("shared g, K = 1, C = 512", 40, False, 1, 1, 512, 256, False, 0, False),
]


@pytest.mark.parametrize("variant", k3.VARIANTS)
@pytest.mark.parametrize("case", INJECT_CASES, ids=[c[0] for c in
                                                    INJECT_CASES])
def test_every_span_inject_variant_matches_twin(cuda, case, variant):
    """Each of the kernel's variants, whatever variant_for would pick,
    <= -110 dB against the twin and bitwise repeatable."""
    _, o, hetero, k, x, c, m = case
    tables = _span_table(o, 40, c, not hetero, cuda, m)
    rng = np.random.default_rng(14)
    f = _randn(rng, o, k, x * c, device=cuda)
    be = [_randn(rng, o, k, m, device=cuda) for _ in range(2)]
    args = (f, *be, tables.b_re, tables.b_im)
    planes = span_planes(tables.b_re, tables.b_im)
    if variant == "stacked" and x > k3.STACKED_CHUNKS:
        with pytest.raises(ValueError, match="stacked"):
            k3._launch(*args, planes, variant)
        return
    got = k3._launch(*args, planes, variant)
    again = k3._launch(*args, planes, variant)
    _assert_kernel_matches_twin(got, again, k3.span_inject_reference(*args),
                                db=-110)


@pytest.mark.parametrize("variant", k4.VARIANTS)
@pytest.mark.parametrize("case", REDUCE_CASES, ids=[c[0] for c in
                                                    REDUCE_CASES])
def test_every_span_reduce_variant_matches_twin(cuda, case, variant):
    _, o, hetero, nl, r, c, m, cplx, off, add = case
    tables = _span_table(o, 40, c, not hetero, cuda, m)
    rng = np.random.default_rng(15)
    t_re = _randn(rng, o, nl, m, device=cuda)
    t_im = _randn(rng, o, nl, m, device=cuda) if cplx else None
    v = [_randn(rng, o, r, m, device=cuda) for _ in range(2)]
    extra = _randn(rng, o, nl, r, c, device=cuda) if add else None
    args = (t_re, t_im, *v, tables.b_re, tables.b_im, off, extra)
    planes = span_planes(tables.b_re, tables.b_im)
    most = {"fp32": k4.FP32_ROWS, "split": k4.SPLIT_ROWS}
    if nl * r > most.get(variant, nl * r):
        with pytest.raises(ValueError, match=variant):
            k4._launch(*args, planes, variant)
        return
    got = k4._launch(*args, planes, variant)
    again = k4._launch(*args, planes, variant)
    _assert_kernel_matches_twin([got], [again],
                                [k4.span_reduce_reference(*args)], db=-110)


def test_cluster_variant_takes_misaligned_rows(cuda):
    """The cluster variant on modes of no whole float4 (M = 42) and on
    views 4 bytes off a 16-byte boundary takes its 4-byte copies: <= -110
    dB against the twin, bitwise repeatable; the wrapper routes a shared
    table's g there."""
    rng = np.random.default_rng(20)
    for m_modes, off in ((42, 0), (None, 1)):
        tables = _span_table(20, 40, 48, True, cuda, m_modes)
        m = tables.b_re.shape[-1]

        def view(*shape):
            n = int(np.prod(shape))
            return _randn(rng, n + off, device=cuda)[off:].reshape(shape)
        t = [view(20, 1, m) for _ in range(2)]
        v = [view(20, 3, m) for _ in range(2)]
        assert k4.variant_for(20, 1, 3, 48, m, 1) == "cluster"
        args = (*t, *v, tables.b_re, tables.b_im, 0)
        _assert_kernel_matches_twin([k4.span_reduce(*args)],
                                    [k4.span_reduce(*args)],
                                    [k4.span_reduce_reference(*args)],
                                    db=-110)


@pytest.mark.parametrize("shared", [True, False])
def test_span_planes_on_the_card_match_the_cpu(cuda, shared):
    """The planes made on the card are bitwise the planes made on the CPU
    from the same table (an exact layout step)."""
    tables = _span_table(4, 200, 192, shared, cuda)
    got = span_planes(tables.b_re, tables.b_im)
    want = span_planes(tables.b_re.cpu(), tables.b_im.cpu())
    for name in ("lo_re", "lo_im", "bt_re", "bt_im", "bt_lo_re", "bt_lo_im"):
        assert getattr(got, name).is_cuda
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name))


def test_wgmma_variants_refuse_misaligned_inputs(cuda):
    """The wgmma variant reads through the TMA, whose bases are 16-byte
    aligned: a view 4 bytes off raises, as does a plane of another
    layout; the mma variants take the same view."""
    tables = _span_table(256, 200, 512, True, cuda)
    m = tables.b_re.shape[-1]
    rng = np.random.default_rng(16)
    f = _randn(rng, 256 * 512 * 32 + 1, device=cuda)[1:].reshape(
        256, 1, 32 * 512)
    be = [_randn(rng, 256, 1, m, device=cuda) for _ in range(2)]
    assert k3.variant_for(256, 1, 32, 512, m, 1) == "wgmma"
    with pytest.raises(ValueError, match="16-byte aligned"):
        k3.span_inject(f, *be, tables.b_re, tables.b_im)
    _assert_kernel_matches_twin(
        k3._launch(f, *be, tables.b_re, tables.b_im, None, "mma64"),
        k3._launch(f, *be, tables.b_re, tables.b_im, None, "mma64"),
        k3.span_inject_reference(f, *be, tables.b_re, tables.b_im), db=-110)
    t = _randn(rng, 256 * m + 1, device=cuda)[1:].reshape(256, 1, m)
    v = [_randn(rng, 256, 32, m, device=cuda) for _ in range(2)]
    assert k4.variant_for(256, 1, 32, 512, m, 1) == "wgmma"
    with pytest.raises(ValueError, match="16-byte aligned"):
        k4.span_reduce(t, None, *v, tables.b_re, tables.b_im, 1)
    bad = span_planes(tables.b_re[:, :-1], tables.b_im[:, :-1])
    with pytest.raises(ValueError, match="layout"):
        k4.span_reduce(t.clone(), None, *v, tables.b_re, tables.b_im, 1,
                       None, bad)


def test_span_kernels_take_unaligned_rows(cuda):
    """Views that start off a 16-byte boundary take the 4-byte copies."""
    tables = _span_table(2, 40, 64, False, cuda)
    m = tables.b_re.shape[-1]
    rng = np.random.default_rng(13)
    f = _randn(rng, 2 * 9 * 64 + 1, device=cuda)[1:].reshape(2, 1, 9 * 64)
    be = [_randn(rng, 2, 1, m, device=cuda) for _ in range(2)]
    assert f.data_ptr() % 16 != 0
    args = (f, *be, tables.b_re, tables.b_im)
    _assert_kernel_matches_twin(k3.span_inject(*args), k3.span_inject(*args),
                                k3.span_inject_reference(*args), db=-110)
    t = _randn(rng, 2 * m + 1, device=cuda)[1:].reshape(2, 1, m)
    v = [_randn(rng, 2, 9, m, device=cuda) for _ in range(2)]
    args = (t, None, *v, tables.b_re, tables.b_im, 1)
    _assert_kernel_matches_twin([k4.span_reduce(*args)],
                                [k4.span_reduce(*args)],
                                [k4.span_reduce_reference(*args)], db=-110)


def test_short_variants_take_misaligned_views(cuda):
    """The stacked and split variants (the one-block span's shape, K = 17
    slots, X = 8 chunks of 64) on views 4 bytes off a 16-byte boundary
    (every input, or be alone) and on modes of no whole float4 take their
    4-byte loads: <= -110 dB against the twin, bitwise repeatable; the
    wrappers route them there."""
    rng = np.random.default_rng(17)
    for m_modes, f_off in ((None, 1), (42, 1), (None, 0)):
        tables = _span_table(3, 40, 64, False, cuda, m_modes)
        m = tables.b_re.shape[-1]

        def view(*shape, off=1):
            n = int(np.prod(shape))
            return _randn(rng, n + off, device=cuda)[off:].reshape(shape)
        f = view(3, 17, 8 * 64, off=f_off)
        be = [view(3, 17, m) for _ in range(2)]
        assert be[0].data_ptr() % 16 != 0
        assert k3.variant_for(3, 17, 8, 64, m, 3) == "stacked"
        args = (f, *be, tables.b_re, tables.b_im)
        _assert_kernel_matches_twin(k3.span_inject(*args),
                                    k3.span_inject(*args),
                                    k3.span_inject_reference(*args), db=-110)
        t = [view(3, 1, m) for _ in range(2)]
        assert k4.variant_for(3, 1, 17, 64, m, 3) == "split"
        args = (*t, *be, tables.b_re, tables.b_im, 0)
        _assert_kernel_matches_twin([k4.span_reduce(*args)],
                                    [k4.span_reduce(*args)],
                                    [k4.span_reduce_reference(*args)],
                                    db=-110)


def test_spans_go_through_the_contraction_kernels(cuda):
    """A busy span is one span_inject and two span_reduce (g and hom), a
    ring-down span one span_reduce, beside chunk_scan and toeplitz_conv;
    the render matches the blocked backend's."""
    lam, b, v = _modes(6, 40, False)
    bank = build_modal_bank(lam, b, v, block_size=256, device=cuda)
    sessions = {
        "span": ModalSession(bank, config=SolverConfig(block_size=256),
                             lam64=lam),
        "blocked": ModalSession(bank, config=SolverConfig(
            block_size=256, backend="blocked"))}
    rng = np.random.default_rng(2)
    for obj in range(6):
        space = rng.standard_normal(40)
        for sess in sessions.values():
            sess.hit(obj, space, kind="gaussian", width_us=600.0,
                     when=256 * (obj % 3))
    mods = (k1, k2, k3, k4, fi)
    before = [mod.LAUNCHES for mod in mods]
    builds = span_mod.PLANE_BUILDS
    mix = sessions["span"].render_multi(10, blocks_per_dispatch=4)
    # one busy dispatch (block 0) and two ring-down ones
    assert [mod.LAUNCHES - b for mod, b in zip(mods, before)] == [
        3, 1, 1, 4, 0]
    # the planes of the render's tables (chunks of 128 and 64), each
    # built once
    assert len(sessions["span"]._span_cache) == 2
    assert span_mod.PLANE_BUILDS == builds + 2
    assert np.isfinite(mix).all() and np.abs(mix).max() > 0
    assert _db(mix, sessions["blocked"].render(10)) <= -90


# ----------------------------------------------------- sustained channel


def _channel(o, m, device, seed=0):
    """A sustained channel on the card: every third object inactive, a
    ringing history and per-object tunings."""
    st = make_sustained_state(o, m, seed=seed, device=device)
    rng = np.random.default_rng(seed)
    st.active[:] = torch.as_tensor(np.arange(o) % 3 != 2)
    st.ar_hist[:] = torch.as_tensor(rng.standard_normal((o, 2)) * 0.01)
    st.sigma[:] = torch.as_tensor(rng.uniform(0.001, 0.003, o))
    st.a[::2] = torch.tensor([0.9, 0.05], device=device)
    return st


@pytest.mark.parametrize("o,x,s,block_start", [
    (5, 7, 512, 0),
    (3, 6, 100, REBASE_PERIOD - 3 * 100),   # ragged row, no modulo (S odd)
    (4, 9, 512, REBASE_PERIOD - 4 * 512),   # the block index wraps
])
def test_ar_noise_matches_twin(cuda, o, x, s, block_start):
    key = make_sustained_state(o, 8, seed=o, device=cuda).key
    idx0, period = ka.block_counter(block_start, s)
    before = ka.LAUNCHES
    got, again = (ka.ar_noise(key, block_start, x, s) for _ in range(2))
    bits = ka.ar_noise(key, block_start, x, s, bits=True)
    assert ka.LAUNCHES == before + 3
    assert torch.equal(got, again)                       # deterministic
    assert torch.equal(bits, ka.ar_noise_reference(key, idx0, x, period, s,
                                                   bits=True))
    ref = ka.ar_noise_reference(key, idx0, x, period, s)
    assert got.shape == (o, x, s) and torch.isfinite(got).all()
    assert _db(got.cpu(), ref.cpu()) <= -120


@pytest.mark.parametrize("o,s,block_start", [
    (7, 512, 3 * 512), (4, 100, 0), (6, 512, REBASE_PERIOD + 5 * 512),
    (3, 99, 0)])                  # S not a multiple of 4: scalar stores
def test_ar_block_matches_twin(cuda, o, s, block_start):
    st = _channel(o, 8, cuda)
    args = (st.key, st.a, st.ar_hist, st.sigma, st.mu, st.active)
    before = kb.LAUNCHES
    got, again = (kb.ar_block(*args, block_start, s) for _ in range(2))
    assert kb.LAUNCHES == before + 2
    idx, _ = ka.block_counter(block_start, s)
    noise = ka.ar_noise(st.key, block_start, 1, s)[:, 0]
    given = kb.ar_block_reference(*args, idx, s, noise=noise)
    own = kb.ar_block_reference(*args, idx, s)
    for k, a, g, r in zip(got, again, given, own):
        assert torch.equal(k, a) and torch.equal(k, g)   # the twin's bits
        assert torch.isfinite(k).all()
        assert _db(k.cpu(), r.cpu()) <= -100
    assert (got[0][2::3] == 0).all()
    assert torch.equal(got[1][2::3], st.ar_hist[2::3])


def test_toeplitz_conv_as_the_ar_noise_conv(cuda):
    """K = 1 and C = S: the AR noise convolution of sustained_span, with a
    shared impulse row expanded over the objects."""
    g = torch.as_tensor(ar_impulse_g((0.783, 0.116), 512)[:, :512],
                        dtype=torch.float32, device=cuda)
    key = make_sustained_state(6, 8, device=cuda).key
    noise = ka.ar_noise(key, 0, 9, 512)
    conv_g = g.expand(6, 512)[:, None, None, :]
    got = k2.toeplitz_conv(conv_g, noise[:, None])
    again = k2.toeplitz_conv(conv_g, noise[:, None])
    _assert_kernel_matches_twin(
        [got], [again], [k2.toeplitz_conv_reference(conv_g, noise[:, None])],
        db=-110)


def test_drags_render_per_block_and_by_span(cuda):
    """A drag renders through the fused kernel and ar_block per block, and
    through ar_noise, chunk_scan and toeplitz_conv by span; the two agree
    (<= -60 dB, the JAX package's span-vs-block contract for drags)."""
    lam, b, v = _modes(6, 40, False)
    bank = build_modal_bank(lam, b, v, block_size=256, device=cuda)
    rng = np.random.default_rng(8)
    vecs = [rng.standard_normal(40) for _ in range(3)]
    mixes, counts = {}, {}
    for path in ("block", "span"):
        sess = ModalSession(bank, config=SolverConfig(block_size=256),
                            lam64=lam)
        render = (sess.render if path == "block" else
                  lambda n, s=sess: s.render_multi(n, blocks_per_dispatch=4))
        before = [m.LAUNCHES for m in (fi, kb, ka, k1, k2)]
        sess.hit(1, vecs[0], kind="gaussian", width_us=600.0)
        sess.sustained_start(0, vecs[1])
        sess.sustained_start(3, vecs[2])
        out = [render(4)]
        sess.set_ar_params(3, sigma=0.003, mu=0.1)
        out.append(render(4))
        sess.sustained_end(0)
        sess.sustained_end(3)
        out.append(render(4))
        mixes[path] = np.concatenate(out)
        counts[path] = [m.LAUNCHES - n for m, n in
                        zip((fi, kb, ka, k1, k2), before)]
    # per block: 8 drag blocks through both kernels; by span: 2 drag spans
    # (noise + a conv each, plus the slot conv of the first), 3 spans
    assert counts == {"block": [8, 8, 0, 0, 0], "span": [0, 0, 2, 3, 4]}
    assert np.isfinite(mixes["span"]).all()
    assert np.abs(mixes["span"]).max() > 0
    assert _db(mixes["span"], mixes["block"]) <= -60


# ----------------------------------------------- the live stream on the card

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden")


@pytest.mark.parametrize("name", ["impulse_24modes_quarter_sec.npy",
                                  "cpp_reference_point_1s.npy"])
def test_fused_kernel_vs_golden(cuda, name):
    """The fused kernel at S = 512, C = 64 against the committed goldens
    of the float64 oracle and the compiled C++ reference: 24 modes struck
    by a unit impulse at sample 0 under the unit transfer, so the render
    at another block size is the same waveform, cut to the golden's
    length. <= -100 dB."""
    from openpbso_tpu_torch.config import UNIT_TRANSFER
    from openpbso_tpu_torch.ops.coeffs import bank_from_material
    ref = np.load(os.path.join(GOLDEN_DIR, name)).astype(np.float64)
    md = synth_mode_data(24, 8, seed=0)
    space = np.random.default_rng(3).standard_normal(24)
    bank = bank_from_material(CERAMIC.density, md.omega_squared,
                              CERAMIC.alpha, CERAMIC.beta, block_size=512,
                              device=cuda)
    m = bank.num_modes
    sp = torch.zeros((1, m), device=cuda)
    sp[0, :24] = torch.as_tensor(space, dtype=torch.float32)
    tr = torch.full((1, m), UNIT_TRANSFER, device=cuda)
    zr = zi = torch.zeros((1, m), device=cuda)
    out = []
    before = fi.LAUNCHES
    n_blocks = -(-ref.shape[0] // 512)
    for blk in range(n_blocks):
        tp = torch.zeros((1, 512), device=cuda)
        if blk == 0:
            tp[0, 0] = 1.0
        zr, zi, sound, _ = fi.step_block_fused(
            zr, zi, bank, sp if blk == 0 else sp * 0, tp, tr)
        out.append(sound[0].cpu().numpy())
    assert fi.LAUNCHES == before + n_blocks
    assert _db(np.concatenate(out)[:ref.shape[0]], ref) <= -100


def _live_session(device, smooth=True, lam=False):
    from openpbso_tpu_torch.ops.ffat import build_ffat
    from openpbso_tpu_torch.utils.synth import synth_fatcube
    lam64, b, v = _modes(6, 40, False)
    bank = build_modal_bank(lam64, b, v, block_size=256, device=device)
    ffat = build_ffat({i: synth_fatcube(i, 200.0 * (i + 1), n=6)
                       for i in range(40)}, bank.num_modes, device=device)
    sess = ModalSession(bank, ffat, SolverConfig(block_size=256,
                                                 smooth_transfer=smooth),
                        lam64=lam64 if lam else None)
    sess.set_listener(np.array([0.6, 0.4, 0.9]))
    return sess


def test_xfade_block_against_fused_renders(cuda):
    """A ramped listener move on the fused backend goes through the blocked
    form and equals the blend of the two constant-row renders through the
    kernel (<= -90 dB); a ramp from a row to itself is the plain step."""
    import dataclasses

    from openpbso_tpu_torch.runtime.solver import (step_block,
                                                   step_block_xfade)
    sess = _live_session(cuda, smooth=False)
    rng = np.random.default_rng(2)
    sess.hit(0, rng.standard_normal(40), kind="gaussian", width_us=900.0)
    sess.hit(4, rng.standard_normal(40), kind="gaussian", width_us=900.0)
    sess.render(2)
    row_a = sess.state.transfer
    sess.set_listener(np.array([-0.3, 0.8, 0.5]))
    state, row_b = sess.state, sess.state.transfer
    kw = dict(block_size=256, backend="auto", with_sustained=False)
    before = fi.LAUNCHES
    new, sound, _, _ = step_block_xfade(state, sess.bank, sess.gains, row_a,
                                        **kw)
    noop = step_block_xfade(state, sess.bank, sess.gains, row_b, **kw)[1]
    assert fi.LAUNCHES == before            # routed to the blocked form
    const = [step_block(dataclasses.replace(state, transfer=r), sess.bank,
                        sess.gains, **kw) for r in (row_a, row_b)]
    assert fi.LAUNCHES == before + 2
    ramp = torch.arange(1, 257, device=cuda, dtype=torch.float32) / 256
    blend = const[0][1] + ramp * (const[1][1] - const[0][1])
    assert float(sound.abs().max()) > 0
    assert _db(sound.cpu(), blend.cpu()) <= -90
    assert _db(noop.cpu(), const[1][1].cpu()) <= -90
    assert _db(new.z_im.cpu(), const[1][0].z_im.cpu()) <= -90


def test_qnorm_on_the_fused_backend(cuda):
    """compute_qnorm leaves the kernel's step bitwise as it was and takes
    the telemetry from the blocked form; the probe advances nothing."""
    from openpbso_tpu_torch.runtime.solver import step_block
    from openpbso_tpu_torch.runtime.state import clone_state, state_leaves
    sess = _live_session(cuda)
    rng = np.random.default_rng(3)
    sess.hit(1, rng.standard_normal(40), kind="gaussian", width_us=900.0)
    sess.render(2)
    kw = dict(block_size=256, with_sustained=False)
    before = fi.LAUNCHES
    plain = step_block(sess.state, sess.bank, sess.gains, backend="auto",
                       **kw)
    withq = step_block(sess.state, sess.bank, sess.gains, backend="auto",
                       compute_qnorm=True, **kw)
    assert fi.LAUNCHES == before + 2
    assert torch.equal(withq[1], plain[1])
    assert torch.equal(withq[0].z_im, plain[0].z_im)
    scan = step_block(sess.state, sess.bank, sess.gains, backend="scan",
                      compute_qnorm=True, **kw)[3]
    assert withq[3].shape == (6, sess.bank.num_modes)
    assert _db(withq[3].cpu(), scan.cpu()) <= -100
    kept, clock = clone_state(sess.state), sess.sample_clock
    probe = sess.qnorm_probe()
    assert probe.is_cuda and float(probe.max()) > 0
    assert sess.sample_clock == clock
    for a, b in zip(state_leaves(kept), state_leaves(sess.state)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def test_engine_checkpoint_round_trip_across_devices(cuda, tmp_path):
    """A snapshot of a running CUDA session, taken through engine.control:
    a fresh CUDA session restored from it renders the next blocks bitwise
    as the running one did, drags and a retuned AR table included; the
    same file loads into a CPU session, whose own snapshot loads back."""
    import time

    from openpbso_tpu_torch.runtime import (RawCollectorSink,
                                            StreamingEngine, load_session,
                                            save_session)
    from openpbso_tpu_torch.runtime.state import state_leaves
    sess = _live_session(cuda)
    engine = StreamingEngine(sess, RawCollectorSink(), qnorm_every=4)
    rng = np.random.default_rng(4)
    engine.hit(0, rng.standard_normal(40), kind="gaussian", width_us=900.0)
    engine.start()
    engine.sustained_start(2, rng.standard_normal(40))
    engine.set_ar_params(2, a=(0.6, 0.2), sigma=0.003, mu=0.1)
    deadline = time.time() + 120
    while engine._blocks_done < 12 and time.time() < deadline:
        time.sleep(0.001)
    path = str(tmp_path / "live.npz")
    box = {}

    def snapshot(s):
        save_session(path, s)
        box["next"] = s.render(8)

    assert engine.control(snapshot)
    engine.stop()
    assert engine.error is None and engine.latest_qnorm() is not None
    fresh = _live_session(cuda)
    load_session(path, fresh)
    assert fresh._sus_active[2] and tuple(fresh._ar_host[2]) == (0.6, 0.2)
    assert np.array_equal(fresh.render(8), box["next"])
    assert np.abs(box["next"]).max() > 0
    host = _live_session("cpu")
    load_session(path, host)
    assert all(t.device.type == "cpu" for t in state_leaves(host.state)
               if isinstance(t, torch.Tensor))
    back = str(tmp_path / "host.npz")
    save_session(back, host)
    again = _live_session(cuda)
    load_session(back, again)
    assert all(t.is_cuda for t in state_leaves(again.state)
               if isinstance(t, torch.Tensor))
    assert np.array_equal(again.render(8), box["next"])


def test_warmup_leaves_no_trace_on_the_card(cuda):
    sessions = [_live_session(cuda, lam=True) for _ in range(2)]
    rng = np.random.default_rng(5)
    vec = rng.standard_normal(40)
    for sess in sessions:
        sess.hit(3, vec, kind="gaussian", width_us=900.0)
        sess.sustained_start(1, vec)
    sessions[0].warmup(qnorm=True, span_blocks=(1, 4))
    assert np.array_equal(sessions[0].render(6), sessions[1].render(6))
    assert np.array_equal(sessions[0].render_multi(8, 4),
                          sessions[1].render_multi(8, 4))


# ------------------------------------------------------- the spatial path


def _scene_models(tmp_path, n_models=2, modes=24):
    from openpbso_tpu_torch.io.meta import resolve_model_dir
    from openpbso_tpu_torch.models import load_model
    from openpbso_tpu_torch.utils.synth import synth_model_dir
    return [load_model(resolve_model_dir(synth_model_dir(
        str(tmp_path / f"m{i}"), "m", num_modes=modes + 8 * i, seed=i + 1),
        "m")) for i in range(n_models)]


def _scene(models, device, n=6, **kw):
    from openpbso_tpu_torch.models import Scene, SceneInstance
    inst = [SceneInstance(models[i % len(models)],
                          np.array([0.5 * i, 0.2 * (i % 3), 0.0]))
            for i in range(n)]
    scene = Scene(inst, block_size=256, device=device, **kw)
    scene.set_listener(np.array([0.4, 1.1, 0.6]))
    rng = np.random.default_rng(8)
    for i in range(n):
        scene.hit(i, int(rng.integers(0, models[0].num_vertices)),
                  kind="gaussian", width_us=700.0, when=256 * (i % 3))
    return scene


def test_span_kernels_on_binaural_itd_rows(cuda, tmp_path, monkeypatch):
    """A binaural ITD Scene's spans put L = 2 complex listener rows
    through both span kernels: on the render's own inputs chunk_scan is
    bitwise its twin and toeplitz_conv within -110 dB and repeatable; the
    render matches the per-block one (blocked form, no kernel)."""
    from openpbso_tpu_torch.ops import span as span_mod
    models = _scene_models(tmp_path)
    captured = {}

    def capture(fn, label):
        def call(*args):
            captured.setdefault(label, [a.clone() if isinstance(
                a, torch.Tensor) else a for a in args])
            return fn(*args)
        return call
    monkeypatch.setattr(span_mod, "chunk_scan",
                        capture(span_mod.chunk_scan, "scan"))
    monkeypatch.setattr(span_mod, "toeplitz_conv",
                        capture(span_mod.toeplitz_conv, "conv"))
    kw = dict(binaural=True, itd=True)
    before = (k1.LAUNCHES, k2.LAUNCHES, fi.LAUNCHES)
    span = _scene(models, cuda, **kw).render_multi(9, blocks_per_dispatch=3)
    # dispatches at blocks 0, 3 and 6; the last slot (hit at block 2)
    # rings past block 3, so two have live forces
    assert (k1.LAUNCHES - before[0], k2.LAUNCHES - before[1],
            fi.LAUNCHES - before[2]) == (3, 2, 0)
    per_block = _scene(models, cuda, **kw)
    assert per_block.session.state.transfer_im.shape == (2, 6, 128)
    assert fi.LAUNCHES == before[2]
    ref = per_block.render(9)
    assert span.shape == (9 * 256, 2) and np.abs(ref).max() > 0
    assert _db(span, ref) <= -90
    g, f = captured["conv"]
    assert g.shape[1] == 2
    _assert_kernel_matches_twin([k2.toeplitz_conv(g, f)],
                                [k2.toeplitz_conv(g, f)],
                                [k2.toeplitz_conv_reference(g, f)], db=-110)
    args = captured["scan"]
    for a, b in zip(k1.chunk_scan(*args), k1.chunk_scan_reference(*args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("hetero", [False, True])
def test_compressed_transfer_matches_its_cpu_run(cuda, hetero):
    """Both Psi textures looked up on the card agree with the same lookups
    on CPU tensors (<= -100 dB), and the two textures differ. [L, O, 3]
    listener rows in one call (the session's set_listener) give each
    listener's row bitwise equal to a call on that row alone."""
    from openpbso_tpu_torch.ops.ffat import (build_ffat, build_ffat_hetero,
                                             compute_transfer)
    from openpbso_tpu_torch.ops.ffat_fit import compress_map
    from openpbso_tpu_torch.utils.synth import synth_fatcube
    maps = [{i: synth_fatcube(i, 300.0 * (i + 1), n=6, seed=s)
             for i in range(40)} for s in (0, 1)]
    comp = [{i: compress_map(m) for i, m in mp.items()} for mp in maps]
    rng = np.random.default_rng(9)
    p = rng.uniform(-1.0, 1.0, (5, 3)) * 2.0
    p[:, 2] += 1.0
    rows = []
    for device in ("cpu", cuda):
        if hetero:
            ffat = build_ffat_hetero([maps[i % 2] for i in range(5)], 128,
                                     device=device, compressed_maps=[
                                         comp[i % 2] for i in range(5)])
        else:
            ffat = build_ffat(maps[0], 128, device=device,
                              compressed_maps=comp[0])
        pos = torch.as_tensor(p, dtype=torch.float32, device=device)
        rows.append([compute_transfer(ffat, pos, compressed=c).cpu()
                     for c in (False, True)])
    host, card = rows
    for got, ref in zip(card, host):
        assert torch.isfinite(got).all() and _db(got, ref) <= -100
    assert not torch.equal(card[0], card[1])
    listeners = torch.stack([pos, pos.flip(0), 0.5 * pos])
    for c in (False, True):
        both = compute_transfer(ffat, listeners, compressed=c)
        assert both.shape == (3, 5, 128)
        for li in range(3):
            assert torch.equal(both[li], compute_transfer(
                ffat, listeners[li], compressed=c))


def test_fused_block_on_the_replicated_rows(cuda, tmp_path):
    """The replicated binaural layout (2 single-listener rows per object)
    steps through fused_block and matches the shared-state rows, which
    take the blocked form, per channel (<= -90 dB)."""
    models = _scene_models(tmp_path)
    before = fi.LAUNCHES
    shared = _scene(models, cuda, binaural=True).render(8)
    assert fi.LAUNCHES == before
    rep = _scene(models, cuda, binaural=True, shared_state=False)
    assert rep.session.state.transfer.shape == (12, 128)
    got = rep.render(8)
    assert fi.LAUNCHES > before
    for ch in range(2):
        assert _db(got[:, ch], shared[:, ch]) <= -90


def _mesh_pair(cuda, shape=(2, 2), o=16, n=128, **cfg):
    """A ShardedSession on a mesh whose cells all name the card, and the
    unsharded session on the same hetero bank (span tables from lam64)."""
    from openpbso_tpu_torch.parallel import ShardedSession, make_mesh
    lam, b, valid = _modes(o, n, shared=False)
    bank = build_modal_bank(lam, b, valid, block_size=256, device=cuda)
    kw = dict(config=SolverConfig(block_size=256, backend="blocked", **cfg),
              num_slots=4, lam64=lam)
    mesh = make_mesh(*shape, devices=[cuda] * (shape[0] * shape[1]))
    return ShardedSession(bank, mesh, **kw), ModalSession(bank, **kw), n


def test_mesh_session_on_the_card(cuda):
    """A (2, 2) mesh on the card per block, by span (one reduction per
    dispatch, the span kernels launched on every shard) and with a drag,
    against the unsharded session."""
    from openpbso_tpu_torch.parallel import sharding
    sh, ref, n = _mesh_pair(cuda)
    vec = np.random.default_rng(3).standard_normal(n)
    for s in (sh, ref):
        s.hit(5, vec, kind="gaussian", width_us=300.0)
    a = np.concatenate([sh.step()[1].cpu().numpy() for _ in range(3)])
    b = np.concatenate([ref.step()[1].cpu().numpy() for _ in range(3)])
    assert np.abs(b).max() > 0 and _db(a, b) <= -90
    for s in (sh, ref):       # both spans busy: a hit in each
        s.hit(2, vec, kind="hertz", width_us=2000.0)
        s.hit(12, -vec, when=s.sample_clock + 4 * 256)
    k1.LAUNCHES = k2.LAUNCHES = sharding.REDUCTIONS = 0
    a = sh.render_multi(8, blocks_per_dispatch=4)
    assert sharding.REDUCTIONS == 2
    assert k1.LAUNCHES == 2 * 4 and k2.LAUNCHES == 2 * 4
    assert _db(a, ref.render_multi(8, blocks_per_dispatch=4)) <= -90
    space = np.linspace(-1.0, 1.0, n)
    for s in (sh, ref):
        s.sustained_start(9, space)
    kb.LAUNCHES = ka.LAUNCHES = 0
    a = np.concatenate([sh.step()[1].cpu().numpy() for _ in range(2)]
                       + [sh.render_multi(4, blocks_per_dispatch=4)])
    assert kb.LAUNCHES == 2 * 4 and ka.LAUNCHES == 4
    b = np.concatenate([ref.step()[1].cpu().numpy() for _ in range(2)]
                       + [ref.render_multi(4, blocks_per_dispatch=4)])
    assert _db(a, b) <= -60


def test_mesh_routes_a_hit_to_the_last_shard(cuda):
    """A hit on the last object with modes only in the last mode slice
    lands in the last shard's rows on the card and is heard like the
    unsharded session's."""
    sh, ref, n = _mesh_pair(cuda)
    space = np.zeros(n)
    space[-n // 4:] = 1.0
    for s in (sh, ref):
        s.hit(15, space, kind="gaussian", width_us=300.0)
    last = sh._shards[1][1]
    assert last.slots.space.device.type == "cuda"
    assert int(torch.count_nonzero(last.slots.space[7, 0])) > 0
    assert int(torch.count_nonzero(sh._shards[0][1].slots.space)) == 0
    a = np.concatenate([sh.step()[1].cpu().numpy() for _ in range(2)])
    b = np.concatenate([ref.step()[1].cpu().numpy() for _ in range(2)])
    assert np.abs(b).max() > 0 and _db(a, b) <= -90


def test_mesh_of_a_host_bank_keeps_only_the_shards(cuda):
    """A bank built on the CPU reaches the card only as the mesh's shards:
    the session keeps a shape-only bank, holds the shards and the state
    on the card (no second whole bank), and renders as the unsharded
    session on the card's own bank."""
    from openpbso_tpu_torch.parallel import ShardedSession, make_mesh
    lam, b, valid = _modes(16, 128, shared=False)
    host = build_modal_bank(lam, b, valid, block_size=256, device="cpu")
    kw = dict(config=SolverConfig(block_size=256, backend="blocked"),
              num_slots=4)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda)
    sh = ShardedSession(host, make_mesh(2, 2, devices=[cuda] * 4), **kw)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(cuda) - before
    assert sh.bank.pow_re.device.type == "meta"
    banks = [c for row in sh._banks for c in row]
    assert all(c.pow_re.device.type == "cuda" for c in banks)
    assert all(c.z_re.device.type == "cuda" for row in sh._shards
               for c in row)

    def nbytes(bank):
        return sum(t.numel() * t.element_size() for t in (
            bank.lam_re, bank.lam_im, bank.b_re, bank.b_im, bank.mask,
            bank.pow_re, bank.pow_im))
    whole = nbytes(host)
    assert sum(nbytes(c) for c in banks) == whole and held < 2 * whole
    ref = ModalSession(build_modal_bank(lam, b, valid, block_size=256,
                                        device=cuda), **kw)
    vec = np.random.default_rng(4).standard_normal(128)
    for s in (sh, ref):
        s.hit(13, vec, kind="gaussian", width_us=300.0)
    a = np.concatenate([sh.step()[1].cpu().numpy() for _ in range(3)])
    b = np.concatenate([ref.step()[1].cpu().numpy() for _ in range(3)])
    assert np.abs(b).max() > 0 and _db(a, b) <= -90
