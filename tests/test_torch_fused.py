"""Port parity: the fused per-block step (openpbso_tpu_torch.ops.fused_integrator).

On the CPU the wrapper runs its plain twin, fused_block_reference, which is
held against the JAX Pallas kernel run in interpret mode (the way the JAX
package's own tests run it) and against the JAX blocked backend. The CUDA
kernel itself is compared with the twin on a GPU by tests/test_torch_gpu.py
and chip_smoke.py.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpbso_tpu.ops.coeffs import (bank_from_material, build_modal_bank,
                                     lambda_from_modes)
from openpbso_tpu.ops.integrator import step_block_blocked as j_blocked
from openpbso_tpu.ops.pallas_integrator import step_block_pallas
from openpbso_tpu.utils.synth import CERAMIC, synth_mode_data
from openpbso_tpu_torch.convert import bank_from_numpy
from openpbso_tpu_torch.ops import fused_integrator as fi
from openpbso_tpu_torch.ops.coeffs import ModalBank

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: intra-op threads only slow them down, and
    under the suite's parallel workers they oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


j_pallas = partial(step_block_pallas, interpret=True)


def _jax_bank(o, n, s, hetero):
    if not hetero:
        md = synth_mode_data(n, 8, seed=5)
        return bank_from_material(CERAMIC.density, md.omega_squared,
                                  CERAMIC.alpha, CERAMIC.beta, num_objects=o,
                                  block_size=s, dtype=jnp.float32)
    parts = [lambda_from_modes(CERAMIC.density, synth_mode_data(
        n, 8, seed=100 + i, f_low=100.0 + i,
        f_high=15000.0 + 3 * i).omega_squared, CERAMIC.alpha, CERAMIC.beta)
        for i in range(o)]
    lam, b, v = (np.stack(x) for x in zip(*parts))
    return build_modal_bank(lam, b, v, block_size=s, shared=False,
                            dtype=jnp.float32)


def _case(o, n, s, hetero=False, seed=5):
    jb = _jax_bank(o, n, s, hetero)
    tb = bank_from_numpy(jax.tree.map(np.asarray, jb), device="cpu")
    m = jb.num_modes
    mask = np.asarray(jb.mask)
    rng = np.random.default_rng(seed)
    x = [rng.standard_normal((o, m)) * mask,       # z_re
         rng.standard_normal((o, m)) * mask,       # z_im
         rng.standard_normal((o, m)) * mask,       # space
         rng.standard_normal((o, s)),              # time profile
         rng.uniform(0.5, 2.0, (o, m))]            # transfer
    x = [a.astype(np.float32) for a in x]
    return jb, tb, x


def _run_jax(fn, jb, x, **kw):
    zr, zi, sp, tp, tr = (jnp.asarray(a) for a in x)
    return [np.asarray(r) for r in fn(zr, zi, jb, sp, tp, tr, False, **kw)[:3]]


def _run_port(fn, tb, x, **kw):
    zr, zi, sp, tp, tr = (torch.from_numpy(a) for a in x)
    return [r.numpy() for r in fn(zr, zi, tb, sp, tp, tr, **kw)[:3]]


def _assert_db(got, ref, dberr, bar):
    for name, a, b in zip(("z_re", "z_im", "sound"), got, ref):
        assert dberr(a, b) <= bar, (name, dberr(a, b))


@pytest.mark.parametrize("o,n,s,chunk,hetero", [
    (1, 40, 256, 64, False),
    (3, 40, 256, 64, False),
    (8, 40, 256, 128, False),
    (5, 40, 256, 64, True),
    (2, 24, 32, 64, True),        # chunk > S clamps to one chunk
])
def test_reference_matches_pallas_interpret(o, n, s, chunk, hetero, dberr):
    jb, tb, x = _case(o, n, s, hetero)
    ref = _run_jax(j_pallas, jb, x, chunk=chunk)
    got = _run_port(fi.fused_block_reference, tb, x, chunk=chunk)
    _assert_db(got, ref, dberr, -110)
    # the CPU wrapper is the twin itself
    wrapped = _run_port(fi.step_block_fused, tb, x, chunk=chunk)
    for a, b in zip(wrapped, got):
        np.testing.assert_array_equal(a, b)


def test_reference_matches_jax_blocked(dberr):
    jb, tb, x = _case(5, 40, 256, hetero=True)
    ref = _run_jax(j_blocked, jb, x)
    got = _run_port(fi.step_block_fused, tb, x)
    _assert_db(got, ref, dberr, -90)


def test_chained_blocks_match_pallas(dberr):
    """State threads across three consecutive blocks."""
    jb, tb, x = _case(2, 24, 128, hetero=True)
    jx, tx = list(x), list(x)
    j_sounds, t_sounds = [], []
    for _ in range(3):
        zr, zi, snd = _run_jax(j_pallas, jb, jx, chunk=64)
        jx[:2] = [zr, zi]
        j_sounds.append(snd)
        zr, zi, snd = _run_port(fi.step_block_fused, tb, tx, chunk=64)
        tx[:2] = [zr, zi]
        t_sounds.append(snd)
    assert dberr(np.concatenate(t_sounds, -1),
                 np.concatenate(j_sounds, -1)) <= -100
    assert dberr(np.stack(tx[:2]), np.stack(jx[:2])) <= -100


def test_cpu_run_launches_no_kernel():
    _, tb, x = _case(3, 40, 256, hetero=True)
    before = fi.LAUNCHES
    _run_port(fi.step_block_fused, tb, x)
    assert fi.LAUNCHES == before == 0


def test_contract_errors():
    _, tb, x = _case(2, 24, 96, hetero=True)
    zr, zi, sp, tp, tr = (torch.from_numpy(a) for a in x)
    with pytest.raises(ValueError, match="block size"):   # qnorm needs the
        fi.step_block_fused(zr, zi, tb, sp, tp[:, :48], tr, True)  # S+1 table
    with pytest.raises(ValueError, match="complex"):
        fi.step_block_fused(zr, zi, tb, sp, tp, tr, transfer_im=tr)
    with pytest.raises(ValueError, match="multiple of chunk"):
        fi.step_block_fused(zr, zi, tb, sp, tp, tr, chunk=64)   # 96 % 64
    with pytest.raises(ValueError, match="shorter"):   # tables hold 97
        fi.fused_block_reference(zr, zi, tb, sp, torch.zeros(2, 256), tr,
                                 chunk=128)
    with pytest.raises(ValueError, match="shared memory"):
        fi._tile_modes(512, 1024, lambda tm, s, c: 8 * (c + 1) * tm)


def test_tile_choice_fits_shared_memory():
    """The widest mode tile whose shared memory fits is taken."""
    def smem(tm, s, c):       # any size that grows with tile and chunk
        return tm * (c + 1) * 16
    assert fi._tile_modes(512, 64, smem) == 128
    assert fi._tile_modes(512, 128, smem) == 64
    assert fi._tile_modes(512, 256, smem) == 32


@pytest.mark.parametrize("n,tm", [(40, 128), (300, 128), (200, 32)])
def test_kernel_tables_are_tile_major(n, tm):
    """The kernel's tables: tile t, row d, column j is lam^d of mode
    t*tm + j, exact; zero past the bank's modes and in the row pad; cached
    on the bank."""
    _, tb, _ = _case(2, n, 128, hetero=True)
    m = tb.num_modes
    tr, ti = fi._kernel_tables(tb, 64, tm, tm + 4)
    t = -(-m // tm)
    assert tr.shape == ti.shape == (2, t, 65, tm + 4) and tr.is_contiguous()
    for got, ref in zip((tr, ti), tb.chunk_tables(64)):
        flat = got[..., :tm].transpose(1, 2).reshape(2, 65, t * tm)
        assert torch.equal(flat[..., :m], ref)
        assert not flat[..., m:].any() and not got[..., tm:].any()
    assert fi._kernel_tables(tb, 64, tm, tm + 4)[0] is tr


# ------------------------------------------------ the kernel's numerics


def _rz32(x):
    """float64 -> float32 rounded toward zero: the tensor cores' float32
    accumulation (a model of it)."""
    y = x.to(torch.float32)
    over = y.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def _split(x):
    """float32 x = hi + lo as the kernel splits it (tf32x3::split_tf32): hi
    = x rounded to TF32 (its low 13 bits cleared after adding half of
    their range), lo = x - hi rounded likewise, as the tensor cores read
    the top 19 bits."""
    keep = torch.tensor(-0x2000, dtype=torch.int32)   # ~0x1fff
    hi = ((x.view(torch.int32) + 0x1000) & keep).view(torch.float32)
    lo = (((x - hi).view(torch.int32) + 0x1000) & keep).view(torch.float32)
    return hi, lo


def _mma3(pairs):
    """sum_j a[..., i, j] b[..., j, n] over every (a, b) of ``pairs`` as
    csrc/fused_block.cu runs it: in k8 steps over j, each pair's three TF32
    products lo*hi, hi*lo, hi*hi truncated into a float32 partial started
    from zero, the step's partials summed and added to float32
    accumulators, with rounding to nearest."""
    split = [(_split(a), _split(b)) for a, b in pairs]
    acc = None
    for j in range(0, pairs[0][0].shape[-1], 8):
        step = None
        for (ah, al), (bh, bl) in split:
            part = None
            for x, y in ((al, bh), (ah, bl), (ah, bh)):
                prod = x[..., j:j + 8].double() @ y[..., j:j + 8, :].double()
                part = _rz32(prod if part is None else part.double() + prod)
            step = part if step is None else step + part
        acc = step if acc is None else acc + step
    return acc


def _emulated_kernel(z_re, z_im, bank, space, f, transfer, chunk=64,
                     tm=128, parts=2):
    """fused_block_reference with both mode contractions as the kernel's
    3xTF32 products: the injections per chunk, hom per tile of tm modes
    split into ``parts`` shares (partials added in order, then the tiles
    in order); the recurrence, G and the convolution in float32."""
    o, s = f.shape
    c, k = chunk, s // chunk
    tr, ti = (x.expand(o, -1, -1) for x in bank.chunk_tables(c))
    be_re, be_im = bank.b_re * space, bank.b_im * space
    t = transfer * bank.mask
    frev = f.reshape(o, k, c).flip(-1).transpose(1, 2)    # [O, C(d), K]
    inj_re = _mma3([(tr[:, :c].transpose(1, 2), frev)])  # [O, M, K]
    inj_im = _mma3([(ti[:, :c].transpose(1, 2), frev)])
    wa, wb = [], []
    zr, zi = z_re, z_im
    pcr, pci = tr[:, c], ti[:, c]
    for x in range(k):
        wa.append(t * zi)
        wb.append(t * zr)
        s_re, s_im = inj_re[..., x], inj_im[..., x]
        zr, zi = (pcr * zr - pci * zi + be_re * s_re - be_im * s_im,
                  pci * zr + pcr * zi + be_re * s_im + be_im * s_re)
    wa, wb = torch.stack(wa, -1), torch.stack(wb, -1)     # [O, M, K]
    hom = None
    share = tm // parts
    for m0 in range(0, tr.shape[-1], tm):
        tile = None
        for p in range(m0, m0 + tm, share):
            ms = slice(p, p + share)
            r = _mma3([(tr[:, 1:, ms], wa[:, ms]), (ti[:, 1:, ms], wb[:, ms])])
            tile = r if tile is None else tile + r
        hom = tile if hom is None else hom + tile           # [O, C, K]
    g = ((tr[:, :c] * (t * be_im)[:, None]).sum(-1)
         + (ti[:, :c] * (t * be_re)[:, None]).sum(-1))    # [O, C]
    idx = torch.arange(c)
    delta = idx[:, None] - idx[None, :]
    toep = g[:, delta.clamp(min=0)] * (delta >= 0).to(g.dtype)
    conv = torch.einsum("ocj,okj->okc", toep, f.reshape(o, k, c))
    return zr, zi, hom.transpose(1, 2).reshape(o, s) + conv.reshape(o, s)


def test_3xtf32_split_holds_the_fused_step_to_float32(dberr):
    """The kernel's 3xTF32 products, emulated on the CPU at O=4, M=256,
    S=512, C=64: <= -110 dB against the same step in float64, the bar the
    kernel is held to against its FP32 twin on the card. (Splits by
    truncation with eight-step chains read about -112 dB here: the sums
    over modes amplify the products' error; one TF32 product about -58.)"""
    _, tb, x = _case(4, 256, 512, hetero=True)
    assert tb.num_modes == 256
    zr, zi, sp, tp, tr = (torch.from_numpy(a) for a in x)
    bank64 = ModalBank(**{name: getattr(tb, name).double() for name in (
        "lam_re", "lam_im", "b_re", "b_im", "mask", "pow_re", "pow_im")})
    ref = fi.fused_block_reference(*(a.double() for a in (zr, zi)), bank64,
                                   *(a.double() for a in (sp, tp, tr)))
    got = _emulated_kernel(zr, zi, tb, sp, tp, tr)
    twin = fi.fused_block_reference(zr, zi, tb, sp, tp, tr)
    for name, g, r, w in zip(("z_re", "z_im", "sound"), got, ref, twin):
        assert g.dtype == torch.float32
        assert dberr(g.numpy(), r.numpy()) <= -110, name
        assert dberr(g.numpy(), w.numpy()) <= -110, name
