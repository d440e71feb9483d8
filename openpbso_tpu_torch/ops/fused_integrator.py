"""Fused per-block integrator for heterogeneous banks: CUDA kernel + plain twin.

Counterpart of openpbso_tpu/ops/pallas_integrator.py. The blocked backend
streams [O, M, S+1]-sized lam-power tables every block (~1 GB at
256x1024x512); the chunked form reads only the chunk prefix lam^0..lam^C
of those tables and reuses it across the S/C chunks of the block. Per
object, per chunk of C samples starting at state z:

    G_d   = sum_m t_m Im(P_d beff_m)          d in [0, C)   (once per block)
    hom_c = sum_m t_m Im(P_{c+1} z_m)         c in [0, C)
    z    <- P_C z + beff sum_j P_{C-1-j} f_j
    sound = hom + G (*) f                     (causal, within each chunk)

with P_d = lam^d from the bank's float64-derived tables, beff = b*space and
t = transfer*mask. On CUDA tensors ``step_block_fused`` launches the
hand-written kernel (csrc/fused_block.cu); on CPU tensors it runs
``fused_block_reference``, the same recurrence in plain PyTorch, which is
also what the kernel is held against on the card.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from .coeffs import ModalBank
from .integrator import (_check_tables, _qnorm_blocked,
                         _weighted_gather)

DEFAULT_CHUNK = 64
# dynamic shared memory a block may use on sm_90, less 1 KB for the
# kernel's static barriers (csrc/fused_block.cu kMaxSmem)
MAX_SMEM_BYTES = 232448 - 1024
TILE_MODES = (128, 64, 32)  # modes per block, widest first

# block steps that ran on the card's kernel (one CUDA launch each)
LAUNCHES = 0


def _check_block(bank: ModalBank, s: int, chunk: int, transfer_im) -> int:
    """The contract of step_block_pallas: clamp the chunk to the block,
    which must be a whole number of chunks; real transfer rows only."""
    if transfer_im is not None:
        raise ValueError("complex transfer rows are not supported by the "
                         "fused kernel (the solver routes them to blocked)")
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"block {s} must be a multiple of chunk {chunk}")
    if bank.pow_re is None or bank.pow_re.shape[-1] < chunk + 1:
        raise ValueError("bank tables missing or shorter than the chunk")
    return chunk


def _chunk_reduce(w: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    """einsum('om,ocm->oc') over a [Og, C, M] chunk table."""
    if tbl.shape[0] == 1:
        return w @ tbl[0].T
    return torch.einsum("om,ocm->oc", w, tbl)


def fused_block_reference(
    z_re: torch.Tensor,            # [O, M]
    z_im: torch.Tensor,            # [O, M]
    bank: ModalBank,
    space: torch.Tensor,           # [O, M]
    time_profile: torch.Tensor,    # [O, S]
    transfer: torch.Tensor,        # [O, M]
    chunk: int = DEFAULT_CHUNK,
):
    """The kernel's computation in plain PyTorch, written from the chunk
    recurrence above. Returns (z_re', z_im', sound [O, S])."""
    o, s = time_profile.shape
    chunk = _check_block(bank, s, chunk, None)
    c = chunk
    tr, ti = bank.chunk_tables(c)                 # [Og, C+1, M]
    be_re = bank.b_re * space
    be_im = bank.b_im * space
    t = transfer * bank.mask
    # [Og, M, C] views for the injection gather (lam^0..lam^{C-1})
    p0r, p0i = tr[:, :c].transpose(1, 2), ti[:, :c].transpose(1, 2)
    pcr, pci = tr[:, c], ti[:, c]                 # lam^C  [Og, M]

    g = (_chunk_reduce(t * be_re, ti[:, :c])
         + _chunk_reduce(t * be_im, tr[:, :c]))   # [O, C]
    homs = []
    for k in range(s // c):
        homs.append(_chunk_reduce(t * z_im, tr[:, 1:])
                    + _chunk_reduce(t * z_re, ti[:, 1:]))
        f_rev = time_profile[:, k * c:(k + 1) * c].flip(-1)
        s_re = _weighted_gather(p0r, f_rev)
        s_im = _weighted_gather(p0i, f_rev)
        z_re, z_im = (pcr * z_re - pci * z_im + be_re * s_re - be_im * s_im,
                      pci * z_re + pcr * z_im + be_re * s_im + be_im * s_re)
    hom = torch.cat(homs, dim=-1)

    # within-chunk causal convolution: conv[o, k, cc] = sum_{j<=cc}
    # G[cc-j] f[o, k, j], as a [C(out), C(in)] Toeplitz matrix per object
    idx = torch.arange(c, device=g.device)
    delta = idx[:, None] - idx[None, :]
    toep = g[:, delta.clamp(min=0)] * (delta >= 0).to(g.dtype)  # [O, C, C]
    f_chunks = time_profile.reshape(o, s // c, c)
    conv = torch.einsum("ocj,okj->okc", toep, f_chunks)
    return z_re, z_im, hom + conv.reshape(o, s)


def _tile_modes(s: int, chunk: int, smem_bytes) -> int:
    """The widest mode tile whose shared memory fits."""
    for tm in TILE_MODES:
        if smem_bytes(tm, s, chunk) <= MAX_SMEM_BYTES:
            return tm
    raise ValueError(f"chunk {chunk} with block {s} does not fit the "
                     f"kernel's shared memory; use a smaller chunk")


def _kernel_tables(bank: ModalBank, chunk: int, tm: int, row: int):
    """lam^0..lam^chunk tile-major, [Og, T, chunk+1, row]: tile t holds the
    powers of modes t*tm .. t*tm+tm-1 in rows of ``row`` >= tm floats (modes
    past M and the row pad zero), so that a range of one tile's rows is one
    contiguous copy for the kernel. Built from the block tables once per
    (bank, chunk, tile) and cached on the bank."""
    key = ("fused", chunk, tm, row)
    tables = bank._chunk_cache.get(key)
    if tables is None:
        if bank.pow_re is None or bank.pow_re.shape[-1] < chunk + 1:
            raise ValueError(
                f"bank tables missing or shorter than chunk {chunk}")
        og, m = bank.pow_re.shape[:2]
        t = -(-m // tm)

        def tile_major(p):   # [Og, M, S+1] -> [Og, T, C+1, row]
            x = F.pad(p[..., :chunk + 1], (0, 0, 0, t * tm - m))
            x = x.reshape(og, t, tm, chunk + 1).transpose(2, 3)
            return F.pad(x, (0, row - tm)).contiguous()
        tables = (tile_major(bank.pow_re), tile_major(bank.pow_im))
        bank._chunk_cache[key] = tables
    return tables


@functools.lru_cache(maxsize=None)
def _plan(s: int, chunk: int) -> tuple[int, int]:
    """(modes per tile, floats per table row) of the kernel's launch."""
    from . import _build
    lib = _build.load()
    tm = _tile_modes(s, chunk, lib.fused_block_smem_bytes)
    return tm, lib.fused_block_row_floats(tm)


def _launch(z_re, z_im, bank, space, time_profile, transfer, chunk):
    from . import _build
    lib = _build.load()
    o, m = z_re.shape
    s = time_profile.shape[-1]
    idx = z_re.get_device()
    rows = (z_re, z_im, space, transfer, bank.b_re, bank.b_im, bank.mask)
    for x in rows + (time_profile,):
        if (x.get_device() != idx or x.dtype != torch.float32
                or not x.is_contiguous()):
            raise ValueError("the fused kernel takes contiguous float32 "
                             "tensors on one CUDA device; got "
                             f"{x.dtype} on {x.device}")
    if any(x.shape != z_re.shape for x in rows) or time_profile.shape[0] != o:
        raise ValueError("shape mismatch: expected [O, M] rows and an "
                         "[O, S] profile")
    tm, row = _plan(s, chunk)
    tr, ti = _kernel_tables(bank, chunk, tm, row)
    z_re_out = torch.empty_like(z_re)
    z_im_out = torch.empty_like(z_im)
    sound = torch.empty_like(time_profile)
    stride = 0 if tr.shape[0] == 1 else tr.stride(0)
    with _build.device_guard(z_re):
        err = lib.fused_block_step(
            tr.data_ptr(), ti.data_ptr(), stride, tr.shape[1],
            bank.b_re.data_ptr(), bank.b_im.data_ptr(), space.data_ptr(),
            transfer.data_ptr(), bank.mask.data_ptr(),
            z_re.data_ptr(), z_im.data_ptr(), time_profile.data_ptr(),
            z_re_out.data_ptr(), z_im_out.data_ptr(), sound.data_ptr(),
            o, m, s, chunk, tm, _build.launch_stream(z_re))
    _build.check(err, "fused_block_step")
    return z_re_out, z_im_out, sound


def step_block_fused(
    z_re: torch.Tensor,            # [O, M]
    z_im: torch.Tensor,            # [O, M]
    bank: ModalBank,
    space: torch.Tensor,           # [O, M]
    time_profile: torch.Tensor,    # [O, S]
    transfer: torch.Tensor,        # [O, M]
    compute_qnorm: bool = False,
    chunk: int = DEFAULT_CHUNK,
    transfer_im: torch.Tensor | None = None,
):
    """Fused backend; the contract of ops.integrator.step_block_*.

    Needs bank lam-power tables of length >= chunk+1. CUDA tensors launch
    the kernel (a failed build or launch raises); CPU tensors run the plain
    twin. Returns (z_re', z_im', sound [O, S], qnorm [O, M] | None).

    ``compute_qnorm`` leaves the step to the kernel and takes the telemetry
    from the blocked form on the same inputs (its qnorm term alone, the
    value step_block_blocked returns), which is the routing of
    step_block_pallas (openpbso_tpu/ops/pallas_integrator.py:207-211): the
    per-mode energies need the full-block tables, not the chunk prefix.
    """
    global LAUNCHES
    chunk = _check_block(bank, time_profile.shape[-1], chunk, transfer_im)
    if z_re.is_cuda:
        out = _launch(z_re, z_im, bank, space, time_profile, transfer, chunk)
        LAUNCHES += 1
    elif z_re.device.type == "cpu":
        out = fused_block_reference(z_re, z_im, bank, space, time_profile,
                                    transfer, chunk)
    else:
        raise ValueError(f"no fused kernel for device {z_re.device}")
    qnorm = None
    if compute_qnorm:
        _check_tables(bank, time_profile.shape[-1])
        qnorm = _qnorm_blocked(bank, bank.b_re * space, bank.b_im * space,
                               time_profile, z_re, z_im)
    return (*out, qnorm)


def register_backend():
    from . import integrator
    integrator.BACKENDS["fused"] = step_block_fused


register_backend()
