"""GPU-only tests of the port: the CUDA kernels against their plain twins.

They skip without a CUDA device. This file imports no jax, so it also runs
on a GPU machine that has no JAX installed (tests/conftest.py imports jax;
skip it there):

    python -m pytest --noconftest -m cuda tests/test_torch_gpu.py -q
"""
import numpy as np
import pytest
import torch

from openpbso_tpu_torch.config import REBASE_PERIOD
from openpbso_tpu_torch.ops import ar_block as kb
from openpbso_tpu_torch.ops import ar_noise as ka
from openpbso_tpu_torch.ops import chunk_scan as k1
from openpbso_tpu_torch.ops import fused_integrator as fi
from openpbso_tpu_torch.ops import toeplitz_conv as k2
from openpbso_tpu_torch.ops.coeffs import build_modal_bank, lambda_from_modes
from openpbso_tpu_torch.ops.forces import ar_impulse_g, make_sustained_state
from openpbso_tpu_torch.ops.integrator import step_block_blocked
from openpbso_tpu_torch.ops.span import build_span_tables
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
