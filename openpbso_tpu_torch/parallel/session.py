"""ShardedSession: the session on an ('obj', 'mode') mesh of devices.

Counterpart of openpbso_tpu/parallel/session.py. A ShardedSession is a
drop-in ModalSession (the same events, the same step()/render contract;
StreamingEngine, the servers and Scene(mesh=...) drive it unchanged) whose
dispatches are the sharded steps of parallel/sharding.py.

Design. One process holds every shard: the state is a grid of per-shard
SolverStates, one on each mesh cell's device, and each dispatch runs the
port's solver code on every shard and reduces through sharding.psum.

- Event ingestion stays host-side as in ModalSession. Its in-place writes
  (hits, clears, drags, AR retunes, one at a time or a batch's rows
  together) go through ``_put_rows``, which routes an object row, and a
  batch's value of that row, to its object shard and splits a modal row
  across the mode shards; listener rows go through
  ``_install_transfer``, which scatters only the transfer leaves. In the JAX package XLA keeps such
  updates on the owning shard; here nothing would, so every write the base
  class makes is routed by hand.
- Whole-state replacement (``self.state = ...``: warmup's restore, the
  clock rebase, load_state and load_session) goes through the ``state``
  property: its setter scatters the state to the shards and its getter
  gathers them into fresh tensors on the first device (a write into those
  reaches no shard).
- Each shard's block clock is the session's, advanced by every dispatch.
- The whole bank is not kept: its shards hold its data, and ``self.bank``
  is a shape-only copy on the ``meta`` device (objects, modes, the
  tables' layout: all that the base session reads of it). A bank built
  on the CPU thus reaches the cards only as shards.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.coeffs import ModalBank
from ..ops.integrator import decay_block_blocked
from ..ops.span import choose_radix
from ..runtime.session import ModalSession, _row_each
from ..runtime.solver import (SolverConfig, step_multi_transfers,
                              step_multi_transfers_sound)
from ..runtime.state import SolverState
from .sharding import (Mesh, _grid, _join, _run, _split, _transfer_spec,
                       gather_state, make_sharded_decay_step,
                       make_sharded_multi, make_sharded_span,
                       make_sharded_span_sound, make_sharded_step,
                       make_sharded_xfade_step, psum, shard_bank,
                       shard_span_tables, shard_state, state_specs)


def _shape_only(bank: ModalBank) -> ModalBank:
    """``bank`` with every tensor on the ``meta`` device: its shapes and
    dtypes, no data."""
    return ModalBank(**{f.name: None if getattr(bank, f.name) is None
                        else getattr(bank, f.name).to("meta")
                        for f in dataclasses.fields(bank) if f.init})


class ShardedSession(ModalSession):
    """ModalSession over a sharding.Mesh ('obj', 'mode').

    The mesh axes must divide the bank's objects and modes. The blocked
    and span forms are the sharded paths: the scan and fused backends are
    refused (the JAX package's sharded session refuses the scan and its
    Pallas kernel alike)."""

    # nothing goes into the bank's table cache: the bank is a shape-only
    # copy of the session's own, and the unsharded span tables are dropped
    # once split (_span_tables_sharded), so that only the shards stay
    TABLE_CACHE_BYTES = 0

    def __init__(self, bank: ModalBank, mesh: Mesh, ffat=None, config=None,
                 num_slots: int = 16, seed: int = 0,
                 dtype: torch.dtype = torch.float32,
                 lam64: np.ndarray | None = None, num_listeners: int = 1):
        config = config or SolverConfig()
        if config.backend not in ("blocked", "auto"):
            raise ValueError("ShardedSession supports the blocked/span "
                             f"forms, not backend={config.backend!r}")
        self.mesh = mesh
        self._banks = shard_bank(mesh, bank)
        self._fns: dict = {}
        self._sharded_tables: dict[int, list] = {}   # chunk -> grid
        super().__init__(bank, ffat=ffat,
                         config=dataclasses.replace(config,
                                                    backend="blocked"),
                         num_slots=num_slots, seed=seed, dtype=dtype,
                         lam64=lam64, num_listeners=num_listeners)
        # the session's own tensors (event rows, gains, AR tables) live on
        # the mesh's first device, wherever the bank was built
        self.device = mesh.first
        self.gains = self.gains.to(self.device)
        self.bank = _shape_only(bank)

    # ------------------------------------------------------------- state

    @property
    def state(self) -> SolverState:
        """The whole state, gathered on the mesh's first device."""
        return gather_state(self.mesh, self._shards)

    @state.setter
    def state(self, state: SolverState) -> None:
        self._shards = shard_state(self.mesh, state)

    @property
    def devices(self) -> tuple:
        """The mesh's distinct devices, in cell order."""
        return tuple(dict.fromkeys(self.mesh.devices.flat))

    def _cells(self):
        return np.ndindex(*self.mesh.devices.shape)

    def _put_rows(self, leaf: str, obj, value, slot=None) -> None:
        group, name = leaf.split(".")
        mode_axis = getattr(getattr(state_specs(), group), name)[1]
        n_obj, n_mode = self.mesh.devices.shape
        per = self.bank.num_objects // n_obj
        # the rows as non-negative indices (an out-of-range one raises
        # IndexError, as the unsharded session's indexing does)
        objs = np.arange(self.bank.num_objects)[
            np.atleast_1d(np.asarray(obj))]
        each = np.ndim(obj) > 0
        like = getattr(getattr(self._shards[0][0], group), name)
        if isinstance(value, np.ndarray):
            value = torch.as_tensor(value).to(like.dtype)
        if each and isinstance(value, torch.Tensor):
            # one row each: it travels with its object to the shard
            value = _row_each(value, like.dim() - (slot is not None))
        for i in range(n_obj):
            mine = (objs >= i * per) & (objs < (i + 1) * per)
            if not mine.any():
                continue
            rows = objs[mine] - i * per if each else int(objs[0]) - i * per
            s = slot if np.ndim(slot) == 0 else np.asarray(slot)[mine]
            v = value
            if each and isinstance(v, torch.Tensor):
                v = v[torch.from_numpy(mine)]
            for j in range(n_mode):
                t = getattr(getattr(self._shards[i][j], group), name)
                vj = v
                if isinstance(vj, torch.Tensor):
                    if mode_axis is not None and vj.dim() and \
                            vj.shape[-1] > 1:
                        w = vj.shape[-1] // n_mode
                        vj = vj[..., j * w:(j + 1) * w]
                    vj = vj.to(t.device)
                if s is None:
                    t[rows] = vj
                else:
                    t[rows, s] = vj

    def _current_transfer(self) -> tuple:
        cell = self._shards[0][0]
        spec = _transfer_spec(cell.transfer)

        def join(name):
            return _join([[getattr(c, name) for c in row]
                          for row in self._shards], spec, self.mesh.first)
        return (join("transfer"),
                None if cell.transfer_im is None else join("transfer_im"))

    def _install_transfer(self, transfer, transfer_im) -> None:
        spec = _transfer_spec(transfer)
        re = _split(transfer, self.mesh, spec)
        im = _split(transfer_im, self.mesh, spec)
        for i, j in self._cells():
            self._shards[i][j] = dataclasses.replace(
                self._shards[i][j], transfer=re[i][j],
                transfer_im=None if im is None else im[i][j])

    def _shift_clock(self, sub: int) -> None:
        for i, j in self._cells():
            st = self._shards[i][j]
            st.slots.t0.sub_(sub).clamp_(min=-(1 << 30))
            self._shards[i][j] = dataclasses.replace(
                st, block_start=st.block_start - sub)

    # ---------------------------------------------------------- dispatch

    def _fn(self, kind: str, **kw):
        """The sharded callable of ``kind`` for these flags, cached per
        (kind, flags) as the JAX session caches its programs."""
        key = (kind, tuple(sorted(kw.items())))
        fn = self._fns.get(key)
        if fn is None:
            make = {"step": make_sharded_step,
                    "xfade": make_sharded_xfade_step,
                    "decay": make_sharded_decay_step,
                    "multi": make_sharded_multi,
                    "span": make_sharded_span,
                    "span_sound": make_sharded_span_sound}[kind]
            fn = make(self.mesh, block_size=self.config.block_size, **kw)
            self._fns[key] = fn
        return fn

    def _span_tables_sharded(self, n_blocks: int) -> list:
        """The span tables of n_blocks as a grid: built once per chunk
        size for the whole bank (the host float64 build is the costly
        part), split per shard once, and the unsharded copy dropped, so
        that only the shards stay on the devices."""
        span = n_blocks * self.config.block_size
        chunk = choose_radix(span)
        grid = self._sharded_tables.get(chunk)
        if grid is None:
            grid = shard_span_tables(self.mesh,
                                     self.span_tables_for(n_blocks))
            self._span_cache.pop(chunk, None)
            self._sharded_tables[chunk] = grid
        return [[dataclasses.replace(t, n_chunks=span // chunk) for t in row]
                for row in grid]

    def _step_full(self, with_sustained=None, num_slots="auto"):
        if with_sustained is None:
            with_sustained = self._with_sustained()
        if num_slots == "auto":
            num_slots = self._slot_bucket()
        fn = self._fn("step", compute_qnorm=self.config.compute_qnorm,
                      with_sustained=with_sustained, num_slots=num_slots)
        self._shards, sound, mix, qnorm = fn(self._shards, self._banks,
                                             self.gains)
        self._clock += self.config.block_size
        return sound, mix, qnorm

    def _step_decay(self):
        fn = self._fn("decay", compute_qnorm=self.config.compute_qnorm)
        self._shards, sound, mix, qnorm = fn(self._shards, self._banks,
                                             self.gains)
        self._clock += self.config.block_size
        return sound, mix, qnorm

    def _step_xfade(self, prev, with_sustained=None, num_slots="auto"):
        # a real side of the ramp (im None) ramps from or to zero phase in
        # the shards' own xfade (ops/integrator._xfade_rows), so a complex
        # row fading to a real one needs no injected zero target
        prev_re, prev_im = prev
        if with_sustained is None:
            with_sustained = self._with_sustained()
        if num_slots == "auto":
            num_slots = self._slot_bucket()
        fn = self._fn("xfade", compute_qnorm=self.config.compute_qnorm,
                      with_sustained=with_sustained, num_slots=num_slots)
        self._shards, sound, mix, qnorm = fn(self._shards, self._banks,
                                             self.gains, prev_re, prev_im)
        self._clock += self.config.block_size
        return sound, mix, qnorm

    def _step_multi(self, n_blocks, with_sustained, num_slots):
        fn = self._fn("multi", n_blocks=n_blocks,
                      with_sustained=with_sustained, num_slots=num_slots)
        self._shards, mix = fn(self._shards, self._banks, self.gains)
        return mix

    def _span_args(self, n_blocks, num_slots, idle, with_sustained,
                   ar_per_object):
        """The span callable's flags and its trailing AR table."""
        if idle:
            return dict(n_blocks=n_blocks, decay=True), ()
        if with_sustained:
            ar_g = self.ar_span_table(n_blocks, ar_per_object)
            return dict(n_blocks=n_blocks, num_slots=num_slots, decay=False,
                        with_sustained=True,
                        ar_g_shared=ar_g.shape[0] == 1), (ar_g,)
        return dict(n_blocks=n_blocks, num_slots=num_slots, decay=False), ()

    def _span_mix(self, n_blocks, num_slots, idle, with_sustained,
                  ar_per_object):
        kw, ar = self._span_args(n_blocks, num_slots, idle, with_sustained,
                                 ar_per_object)
        self._shards, mix = self._fn("span", **kw)(
            self._shards, self._banks, self._span_tables_sharded(n_blocks),
            self.gains, *ar)
        return mix

    def _span_sound(self, n_blocks, num_slots, idle, with_sustained,
                    ar_per_object):
        kw, ar = self._span_args(n_blocks, num_slots, idle, with_sustained,
                                 ar_per_object)
        self._shards, sound = self._fn("span_sound", **kw)(
            self._shards, self._banks, self._span_tables_sharded(n_blocks),
            *ar)
        return sound

    def _moving(self, rows, smooth, want_sound):
        """A listener path's chunk on every shard: each renders its rows
        of the path; the mix (linear in the mode-partial sound) takes one
        psum over both axes, the raw sound one over 'mode' and a gather."""
        multi = rows.dim() == 4
        path = _grid(rows, self.mesh, (2, 3) if multi else (1, 2))
        kw = dict(n_blocks=rows.shape[0], block_size=self.config.block_size,
                  backend=self.config.backend, smooth=smooth,
                  with_sustained=self._with_sustained(),
                  num_slots=self._slot_bucket())
        if want_sound:
            out = _run(self.mesh, lambda i, j: step_multi_transfers_sound(
                self._shards[i][j], self._banks[i][j], path[i][j], **kw))
            part = psum([[c[1] for c in row] for row in out], "mode")
            res = _join(part, (1 if multi else 0, None), self.mesh.first)
        else:
            g = _grid(self.gains, self.mesh, (0, None))
            out = _run(self.mesh, lambda i, j: step_multi_transfers(
                self._shards[i][j], self._banks[i][j], g[i][j], path[i][j],
                **kw))
            res = psum([[c[1] for c in row] for row in out],
                       ("obj", "mode"))[0][0]
        self._shards = [[c[0] for c in row] for row in out]
        return res

    def qnorm_probe(self) -> torch.Tensor:
        """Per-mode energy [O, M] over one ring-down block, every shard
        its own rows, joined over both axes."""
        parts = _run(self.mesh, lambda i, j: decay_block_blocked(
            self._shards[i][j].z_re, self._shards[i][j].z_im,
            self._banks[i][j], self._shards[i][j].transfer, True)[3])
        return _join(parts, (0, 1), self.mesh.first)
