"""Plan linter: static proofs over plan artifacts, without executing.

Every invariant the executors rely on dynamically is checked here
statically — a wrong plan is caught as a *named finding* instead of as
wrong numerics three layers later. The passes (see
:mod:`repro_torch.analysis.passes` for the framework and levels):

``structure`` — internal consistency of the in-memory plan arrays:

* ``device/shapes`` — array shapes, index bounds, count sanity.
* ``device/tile-order`` — per-unit tiles strictly ascending in the
  ``(block-row, block-col)`` composite key (the ``pack_units`` order
  contract; catches duplicated and reordered tiles).
* ``device/padding`` — padding beyond ``real_tiles`` is inert zeros.
* ``exchange/owned`` — the x-ownership map equals the canonical
  contiguous :func:`repro_torch.sparse.bell.x_block_owner` layout.
* ``exchange/needed`` — each unit's needed set is exactly the distinct
  block-cols of its real tiles, ascending, −1-padded.
* ``exchange/delivery`` — delivery exactness: every needed x block is
  scheduled exactly once, the recv (source, lane) map points at the
  send that carries it, and the wire/naive volume scalars are honest.
* ``exchange/tile-col-local`` — the workspace index is the
  :func:`repro_torch.pmvc.plan_device.tile_col_local_from` derivation.
* ``exchange/rebuild`` — the whole selective schedule is bitwise what
  :func:`build_selective_plan` derives from the device plan.
* ``overlap/counts`` — local + halo-wave counts partition the real
  tiles; per-set padding is zero; workspace paddings cover the counts.
* ``overlap/waves`` — waves disjointly cover each unit's *remote*
  needed set, never ship self-owned blocks, and follow the
  ring-distance near-first cut rule (wave k's blocks are closer than
  wave k+1's, exactly as ``build_overlap_plan`` assigns them).
* ``overlap/rebuild`` — the full overlap plan is bitwise what
  :func:`build_overlap_plan` derives from (device plan, selective).

``strict`` adds the O(nnz) anchor to the source matrix:

* ``matrix/conservation`` — every stored nonzero is a matrix element
  and every matrix element is stored exactly once: summing each
  (block-row, block-col) tile across units reproduces the matrix's
  scattered values bit-for-bit (unit-split tiles hold disjoint
  positions, so float32 equality is exact).

``full`` adds the repack-equivalence proof:

* ``session/repack`` — the device plan is bitwise
  ``pack_units(matrix, elem_unit)``; combined with the rebuild passes
  this is the patched-session ≡ replan structural equivalence for
  :meth:`SparseSession.update` (the exchange plans are deterministic
  functions of the device plan, so their equality follows).

Archive passes (``lint_archive`` / the ``python -m repro_torch.analysis``
CLI) check on-disk plans: zip/meta/member structure, per-member CRC
with the failing member and byte offset named, and v2 ragged-count
integrity — then, at ``strict``/``full``, load the session and run the
in-memory passes on it.
"""
from __future__ import annotations

import os
import zipfile
from typing import List, Optional

import numpy as np

from repro_torch.analysis.passes import (
    Finding,
    LintReport,
    PlanView,
    archive_pass,
    plan_pass,
    run_archive_passes,
    run_plan_passes,
)
from repro_torch.pmvc.plan_device import (
    OverlapPlan,
    SelectivePlan,
    build_overlap_plan,
    build_selective_plan,
    pack_units,
    tile_col_local_from,
)
from repro_torch.sparse.bell import ragged_from_stacked, x_block_owner

__all__ = ["lint_plan", "lint_session", "lint_archive", "lint_store"]


def _sel_of(view: PlanView) -> Optional[SelectivePlan]:
    ex = view.exchange
    if isinstance(ex, OverlapPlan):
        return ex.selective
    return ex if isinstance(ex, SelectivePlan) else None


def _op_of(view: PlanView) -> Optional[OverlapPlan]:
    ex = view.exchange
    return ex if isinstance(ex, OverlapPlan) else None


# ---------------------------------------------------------------------------
# structure: device plan


@plan_pass("device/shapes")
def _device_shapes(view: PlanView) -> List[Finding]:
    dp = view.device_plan
    f: List[Finding] = []

    def err(msg, where=None):
        f.append(Finding("device/shapes", msg, where))

    if dp.tiles.ndim != 4:
        err(f"tiles must be [U, T, bm, bn], got ndim={dp.tiles.ndim}")
        return f
    u, t, bm, bn = dp.tiles.shape
    if (u, bm, bn) != (dp.num_units, dp.bm, dp.bn):
        err(
            f"tiles shape {dp.tiles.shape} disagrees with "
            f"num_units={dp.num_units}, bm={dp.bm}, bn={dp.bn}"
        )
    for name in ("tile_row", "tile_col"):
        arr = getattr(dp, name)
        if arr.shape != (u, t):
            err(f"{name} shape {arr.shape} != (U, T) = {(u, t)}")
            return f
    if dp.real_tiles.shape != (u,):
        err(f"real_tiles shape {dp.real_tiles.shape} != (U,) = {(u,)}")
        return f
    if (dp.real_tiles < 0).any() or (dp.real_tiles > t).any():
        err(f"real_tiles must lie in [0, T={t}], got {dp.real_tiles.tolist()}")
        return f
    nrb, ncb = dp.num_row_blocks, dp.num_col_blocks
    for un in range(u):
        k = int(dp.real_tiles[un])
        rr, cc = dp.tile_row[un, :k], dp.tile_col[un, :k]
        if k and ((rr < 0).any() or (rr >= nrb).any()):
            err(f"tile_row out of [0, {nrb})", where=f"unit {un}")
        if k and ((cc < 0).any() or (cc >= ncb).any()):
            err(f"tile_col out of [0, {ncb})", where=f"unit {un}")
    return f


@plan_pass("device/tile-order")
def _device_tile_order(view: PlanView) -> List[Finding]:
    dp = view.device_plan
    ncb = dp.num_col_blocks
    f: List[Finding] = []
    for u in range(dp.num_units):
        k = int(dp.real_tiles[u])
        if k < 2:
            continue
        key = dp.tile_row[u, :k].astype(np.int64) * ncb + dp.tile_col[u, :k]
        d = np.diff(key)
        if (d <= 0).any():
            i = int(np.nonzero(d <= 0)[0][0])
            what = "duplicated" if d[i] == 0 else "out of ascending order"
            f.append(
                Finding(
                    "device/tile-order",
                    f"tile (rb={int(dp.tile_row[u, i + 1])}, "
                    f"cb={int(dp.tile_col[u, i + 1])}) {what} — violates the "
                    "pack_units ascending (block-row, block-col) contract",
                    where=f"unit {u}, tile {i + 1}",
                )
            )
    return f


@plan_pass("device/padding")
def _device_padding(view: PlanView) -> List[Finding]:
    dp = view.device_plan
    f: List[Finding] = []
    for u in range(dp.num_units):
        k = int(dp.real_tiles[u])
        if dp.tiles[u, k:].any():
            f.append(
                Finding(
                    "device/padding",
                    "nonzero payload in the padding region (padding tiles "
                    "must be inert zeros — they contribute to every spmv)",
                    where=f"unit {u}",
                )
            )
        if dp.tile_row[u, k:].any() or dp.tile_col[u, k:].any():
            f.append(
                Finding(
                    "device/padding",
                    "nonzero tile_row/tile_col in the padding region",
                    where=f"unit {u}",
                )
            )
    return f


# ---------------------------------------------------------------------------
# structure: selective exchange


@plan_pass("exchange/owned")
def _exchange_owned(view: PlanView) -> List[Finding]:
    sel = _sel_of(view)
    if sel is None:
        return []
    dp = view.device_plan
    u_n, ncb = dp.num_units, dp.num_col_blocks
    f: List[Finding] = []
    if sel.num_units != u_n:
        f.append(
            Finding(
                "exchange/owned",
                f"exchange num_units={sel.num_units} != device plan U={u_n}",
            )
        )
        return f
    per = -(-ncb // u_n)
    if sel.blocks_per_unit != per:
        f.append(
            Finding(
                "exchange/owned",
                f"blocks_per_unit={sel.blocks_per_unit} != ceil(NCB/U)={per}",
            )
        )
        return f
    owner = x_block_owner(ncb, u_n)
    blocks = np.arange(ncb, dtype=np.int64)
    expect = np.full((u_n, per), -1, dtype=np.int32)
    expect[owner, blocks % per] = blocks.astype(np.int32)
    if sel.owned.shape != expect.shape or not np.array_equal(sel.owned, expect):
        bad = (
            np.nonzero(sel.owned != expect)
            if sel.owned.shape == expect.shape
            else (np.array([-1]), np.array([-1]))
        )
        u, s = int(bad[0][0]), int(bad[1][0])
        f.append(
            Finding(
                "exchange/owned",
                "x ownership map diverges from the canonical contiguous "
                f"x_block_owner layout (first at unit {u}, slot {s})",
            )
        )
    return f


@plan_pass("exchange/needed")
def _exchange_needed(view: PlanView) -> List[Finding]:
    sel = _sel_of(view)
    if sel is None:
        return []
    dp = view.device_plan
    f: List[Finding] = []
    w = sel.needed.shape[1]
    for u in range(dp.num_units):
        k = int(dp.real_tiles[u])
        expect = np.unique(dp.tile_col[u, :k]) if k else np.empty(0, np.int64)
        row = sel.needed[u]
        if expect.size > w:
            f.append(
                Finding(
                    "exchange/needed",
                    f"needs {expect.size} distinct x blocks but the needed "
                    f"workspace is only W={w} wide",
                    where=f"unit {u}",
                )
            )
            continue
        ok = np.array_equal(row[: expect.size].astype(np.int64), expect) and (
            row[expect.size :] == -1
        ).all()
        if not ok:
            f.append(
                Finding(
                    "exchange/needed",
                    "needed row is not the ascending distinct block-col set "
                    "of the unit's real tiles (−1-padded at the tail)",
                    where=f"unit {u}",
                )
            )
    return f


@plan_pass("exchange/delivery")
def _exchange_delivery(view: PlanView) -> List[Finding]:
    sel = _sel_of(view)
    if sel is None:
        return []
    dp = view.device_plan
    u_n, ncb = sel.num_units, dp.num_col_blocks
    lanes = sel.send_idx.shape[2]
    owner = x_block_owner(ncb, u_n)
    f: List[Finding] = []
    wire = 0
    for u in range(u_n):
        need = sel.needed[u]
        w = int((need >= 0).sum())
        need_real = need[:w].astype(np.int64)
        wire += int((owner[need_real] != u).sum())
        # Each needed slot's recv (source, lane) must point at a send
        # carrying exactly that block.
        src = sel.recv_src[u, :w].astype(np.int64)
        lane = sel.recv_lane[u, :w].astype(np.int64)
        if w and ((src < 0).any() or (src >= u_n).any() or (lane < 0).any() or (lane >= lanes).any()):
            f.append(
                Finding(
                    "exchange/delivery",
                    "recv_src/recv_lane out of bounds",
                    where=f"unit {u}",
                )
            )
            continue
        li = sel.send_idx[src, u, lane]
        if w and (li < 0).any():
            b = int(np.nonzero(li < 0)[0][0])
            f.append(
                Finding(
                    "exchange/delivery",
                    f"needed block {int(need_real[b])} has no scheduled send "
                    f"from unit {int(src[b])} lane {int(lane[b])}",
                    where=f"unit {u}",
                )
            )
            continue
        got = sel.owned[src, li].astype(np.int64) if w else need_real
        if not np.array_equal(got, need_real):
            b = int(np.nonzero(got != need_real)[0][0])
            f.append(
                Finding(
                    "exchange/delivery",
                    f"recv slot {b} delivers block {int(got[b])}, needs "
                    f"{int(need_real[b])}",
                    where=f"unit {u}",
                )
            )
        # Delivery exactness: the schedule ships exactly w blocks to u,
        # and their multiset is exactly the needed set (once each).
        sched = sel.send_idx[:, u, :]
        vs, ls = np.nonzero(sched >= 0)
        if vs.size != w:
            f.append(
                Finding(
                    "exchange/delivery",
                    f"schedule delivers {vs.size} blocks, needs {w} — every "
                    "needed block must be scheduled exactly once",
                    where=f"unit {u}",
                )
            )
            continue
        delivered = sel.owned[vs, sched[vs, ls]].astype(np.int64)
        if not np.array_equal(np.sort(delivered), need_real):
            f.append(
                Finding(
                    "exchange/delivery",
                    "delivered block multiset differs from the needed set "
                    "(a block is duplicated or missing on the wire)",
                    where=f"unit {u}",
                )
            )
    if sel.wire_blocks != wire:
        f.append(
            Finding(
                "exchange/delivery",
                f"wire_blocks={sel.wire_blocks} but the schedule moves "
                f"{wire} remote blocks — the volume model would lie",
            )
        )
    naive = (u_n - 1) * ncb
    if sel.naive_blocks != naive:
        f.append(
            Finding(
                "exchange/delivery",
                f"naive_blocks={sel.naive_blocks} != (U-1)*NCB={naive}",
            )
        )
    return f


@plan_pass("exchange/tile-col-local")
def _exchange_tile_col_local(view: PlanView) -> List[Finding]:
    sel = _sel_of(view)
    if sel is None:
        return []
    dp = view.device_plan
    expect = tile_col_local_from(sel.needed, dp.tile_col, dp.num_col_blocks)
    got = sel.tile_col_local
    if got.shape != expect.shape or not np.array_equal(got, expect):
        where = None
        if got.shape == expect.shape:
            u, t = (int(x[0]) for x in np.nonzero(got != expect))
            where = f"unit {u}, tile {t}"
        return [
            Finding(
                "exchange/tile-col-local",
                "tile_col_local diverges from the tile_col_local_from "
                "derivation — stale workspace index (tiles would read the "
                "wrong delivered x block)",
                where,
            )
        ]
    return []


@plan_pass("exchange/rebuild")
def _exchange_rebuild(view: PlanView) -> List[Finding]:
    sel = _sel_of(view)
    if sel is None:
        return []
    rebuilt = build_selective_plan(view.device_plan)
    bad = []
    for field in ("owned", "send_idx", "recv_src", "recv_lane", "needed",
                  "tile_col_local"):
        a, b = getattr(sel, field), getattr(rebuilt, field)
        if a.shape != b.shape or not np.array_equal(a, b):
            bad.append(field)
    for field in ("num_units", "blocks_per_unit", "lanes", "wire_blocks",
                  "naive_blocks"):
        if int(getattr(sel, field)) != int(getattr(rebuilt, field)):
            bad.append(field)
    if bad:
        return [
            Finding(
                "exchange/rebuild",
                "selective schedule is not bitwise build_selective_plan("
                f"device_plan) — diverging fields: {', '.join(bad)}",
            )
        ]
    return []


# ---------------------------------------------------------------------------
# structure: overlap plan


@plan_pass("overlap/counts")
def _overlap_counts(view: PlanView) -> List[Finding]:
    op = _op_of(view)
    if op is None:
        return []
    dp = view.device_plan
    f: List[Finding] = []
    u_n, nw = dp.num_units, op.waves
    if op.halo_wave_counts.shape != (u_n, nw):
        f.append(
            Finding(
                "overlap/counts",
                f"halo_wave_counts shape {op.halo_wave_counts.shape} != "
                f"(U, K) = {(u_n, nw)}",
            )
        )
        return f
    total = op.local_counts + op.halo_wave_counts.sum(axis=1)
    if not np.array_equal(total, dp.real_tiles):
        u = int(np.nonzero(total != dp.real_tiles)[0][0])
        f.append(
            Finding(
                "overlap/counts",
                f"local + halo counts = {int(total[u])} but the device plan "
                f"has {int(dp.real_tiles[u])} real tiles — the split must "
                "be an exact partition",
                where=f"unit {u}",
            )
        )
    if op.t_local < int(op.local_counts.max(initial=0)):
        f.append(
            Finding(
                "overlap/counts",
                f"t_local={op.t_local} < max local count "
                f"{int(op.local_counts.max(initial=0))} — tiles truncated",
            )
        )
    if op.t_halo < int(op.halo_wave_counts.max(initial=0)):
        f.append(
            Finding(
                "overlap/counts",
                f"t_halo={op.t_halo} < max per-wave halo count "
                f"{int(op.halo_wave_counts.max(initial=0))} — tiles truncated",
            )
        )
    for u in range(u_n):
        kl = int(op.local_counts[u])
        if (
            op.local_tiles[u, kl:].any()
            or op.local_row[u, kl:].any()
            or op.local_slot[u, kl:].any()
        ):
            f.append(
                Finding("overlap/counts", "nonzero local padding", where=f"unit {u}")
            )
        for k in range(nw):
            kh = int(op.halo_wave_counts[u, k])
            if (
                op.halo_tiles[u, k, kh:].any()
                or op.halo_row[u, k, kh:].any()
                or op.halo_slot[u, k, kh:].any()
            ):
                f.append(
                    Finding(
                        "overlap/counts",
                        "nonzero halo padding",
                        where=f"unit {u}, wave {k}",
                    )
                )
    return f


@plan_pass("overlap/waves")
def _overlap_waves(view: PlanView) -> List[Finding]:
    op = _op_of(view)
    if op is None:
        return []
    dp = view.device_plan
    sel = op.selective
    u_n, ncb, nw = sel.num_units, dp.num_col_blocks, op.waves
    owner = x_block_owner(ncb, u_n)
    f: List[Finding] = []

    # The cut rule build_overlap_plan commits to: per unit, remote needed
    # blocks ascending by (ring distance to owner, block id), wave =
    # rank * K // count.
    uu, ii = np.nonzero(sel.needed >= 0)
    gg = sel.needed[uu, ii].astype(np.int64)
    own = owner[gg]
    remote = own != uu
    ru, rg, ro = uu[remote].astype(np.int64), gg[remote], own[remote]
    dist = np.minimum((ro - ru) % u_n, (ru - ro) % u_n)
    order = np.lexsort((rg, dist, ru))
    ru_s, rg_s = ru[order], rg[order]
    cnt = np.bincount(ru_s, minlength=u_n)
    off = np.zeros(u_n + 1, dtype=np.int64)
    np.cumsum(cnt, out=off[1:])
    rank = np.arange(ru_s.shape[0], dtype=np.int64) - off[ru_s]
    wave_expect = rank * nw // np.maximum(cnt[ru_s], 1)

    for u in range(u_n):
        m = ru_s == u
        blocks_u, wave_u = rg_s[m], wave_expect[m]
        expect_by_wave = {
            k: set(blocks_u[wave_u == k].tolist()) for k in range(nw)
        }
        seen: dict = {}
        for k in range(nw):
            sched = op.wave_send_idx[:, k, u, :]
            vs, ls = np.nonzero(sched >= 0)
            if (vs == u).any():
                f.append(
                    Finding(
                        "overlap/waves",
                        "wave ships self-owned blocks — owned x is read in "
                        "place, never sent on a wave",
                        where=f"unit {u}, wave {k}",
                    )
                )
            delivered = sel.owned[vs, sched[vs, ls]].astype(np.int64)
            uniq, counts = np.unique(delivered, return_counts=True)
            if (counts > 1).any():
                b = int(uniq[counts > 1][0])
                f.append(
                    Finding(
                        "overlap/waves",
                        f"block {b} delivered {int(counts.max())}× in one "
                        "wave (duplicated halo entry)",
                        where=f"unit {u}, wave {k}",
                    )
                )
            for b in uniq.tolist():
                if b in seen:
                    f.append(
                        Finding(
                            "overlap/waves",
                            f"block {b} appears in waves {seen[b]} and {k} "
                            "— waves must be disjoint",
                            where=f"unit {u}",
                        )
                    )
                seen[b] = k
            got = set(uniq.tolist())
            want = expect_by_wave[k]
            if got != want:
                # Membership diverges from the exact cut build_overlap_plan
                # commits to — covers wave overlap and ring-distance
                # monotonicity violations (a far block riding an early wave
                # necessarily displaces a near one into a later wave).
                f.append(
                    Finding(
                        "overlap/waves",
                        "wave membership diverges from the ring-distance "
                        "near-first cut rule (closer blocks must ride "
                        "earlier waves)",
                        where=f"unit {u}, wave {k}",
                    )
                )
        want_all = set(blocks_u.tolist())
        if set(seen) != want_all:
            missing = sorted(want_all - set(seen))[:3]
            extra = sorted(set(seen) - want_all)[:3]
            f.append(
                Finding(
                    "overlap/waves",
                    "waves do not cover the remote needed set exactly "
                    f"(missing {missing}, extra {extra})",
                    where=f"unit {u}",
                )
            )
    return f


@plan_pass("overlap/rebuild")
def _overlap_rebuild(view: PlanView) -> List[Finding]:
    op = _op_of(view)
    if op is None:
        return []
    rebuilt = build_overlap_plan(view.device_plan, op.selective, waves=op.waves)
    bad = []
    for field in (
        "local_tiles", "local_row", "local_slot",
        "halo_tiles", "halo_row", "halo_slot",
        "local_counts", "halo_wave_counts",
        "wave_send_idx", "wave_recv_src", "wave_recv_lane",
    ):
        a, b = getattr(op, field), getattr(rebuilt, field)
        if a.shape != b.shape or not np.array_equal(a, b):
            bad.append(field)
    if bad:
        return [
            Finding(
                "overlap/rebuild",
                "overlap plan is not bitwise build_overlap_plan(device_plan, "
                f"selective, waves={op.waves}) — diverging fields: "
                f"{', '.join(bad)}",
            )
        ]
    return []


# ---------------------------------------------------------------------------
# strict: matrix ↔ tiles conservation


def _conservation_fast_ok(view: PlanView) -> bool:
    """Exact conservation check on the nonzero *extraction* of the tile
    stack — the honest-plan fast path (~4x cheaper than the dense
    reconstruction: one scan of the payload plus sorts over nnz-sized
    arrays, instead of a key-ordered gather + reduceat + dense scatter
    of the whole stack).

    Equality logic: each matrix element is stored at exactly one tile
    slot position, every other stored position is zero (the pack
    contract, including split tiles — the co-owner holds zeros). So the
    multiset of stored nonzeros ``{(global row, global col) -> f32
    value}`` must equal the matrix's nonzeros bit-for-bit. Returns False
    on any divergence — the caller re-runs the dense path, which
    localizes the failing tile for the finding. Only used when
    ``tile_transform`` is None (views need a tolerance compare on the
    dense reconstruction; see below).
    """
    a = view.matrix
    dp = view.device_plan
    bm, bn = dp.bm, dp.bn
    m = np.int64(dp.shape[1])
    u_cap, t_cap = dp.tiles.shape[:2]
    flat = dp.tiles.reshape(u_cap * t_cap * bm * bn)
    # Materializing the bool mask first is ~2.6x faster than flatnonzero
    # on the f32 array (numpy scans bools much faster than floats).
    nz = np.flatnonzero(flat != 0)
    slot, pos = np.divmod(nz, bm * bn)
    # Padding slots are all-zero by the pack contract (proved by the
    # structure-level device/padding pass), so honest plans never
    # extract from them; a corrupt one diverges here and falls back.
    rows = dp.tile_row.reshape(-1)[slot].astype(np.int64)
    cols = dp.tile_col.reshape(-1)[slot].astype(np.int64)
    skey = (rows * bm + pos // bn) * m + cols * bn + pos % bn
    svals = flat[nz]
    aval = a.val.astype(np.float32)
    keep = aval != 0  # f32-underflowed values store as inert zeros
    akey = a.row.astype(np.int64) * m + a.col.astype(np.int64)
    if not keep.all():
        akey, aval = akey[keep], aval[keep]
    if skey.size != akey.size:
        return False
    if skey.size == 0:
        return True
    if not _is_strictly_sorted(akey):  # canonical COO already is
        order = np.argsort(akey, kind="stable")
        akey, aval = akey[order], aval[order]
        if not _is_strictly_sorted(akey):
            return False  # duplicate matrix coords: not a canonical COO
    p = np.searchsorted(akey, skey)
    if p.size and int(p.max()) >= akey.size:
        return False
    return bool(
        np.array_equal(akey[p], skey)
        and np.array_equal(aval[p], svals, equal_nan=True)
        # akey is unique, so bijectivity needs every target hit once.
        and int(np.bincount(p, minlength=akey.size).max()) == 1
    )


def _is_strictly_sorted(key: np.ndarray) -> bool:
    return bool(key.size < 2 or (key[1:] > key[:-1]).all())


@plan_pass("matrix/conservation", level="strict")
def _matrix_conservation(view: PlanView):
    if view.matrix is None:
        return NotImplemented
    a = view.matrix
    dp = view.device_plan
    if tuple(a.shape) != tuple(dp.shape):
        return [
            Finding(
                "matrix/conservation",
                f"matrix shape {tuple(a.shape)} != plan shape {tuple(dp.shape)}",
            )
        ]
    if view.tile_transform is None and _conservation_fast_ok(view):
        return []
    # Divergence (or a value view): dense per-tile reconstruction —
    # slower, but localizes the failing tile and supports the tolerance
    # compare value views need.
    bm, bn, ncb = dp.bm, dp.bn, dp.num_col_blocks
    counts = dp.real_tiles
    payload = ragged_from_stacked(dp.tiles, counts)
    rows = ragged_from_stacked(dp.tile_row, counts)
    cols = ragged_from_stacked(dp.tile_col, counts)
    if view.tile_transform is not None:
        payload = np.asarray(view.tile_transform(payload), np.float32)

    # Sum duplicated (rb, cb) tiles across units: a partition may split a
    # tile between units, but each element position is nonzero on exactly
    # one unit, so the per-position sum is an exact float32 reconstruction.
    key = rows.astype(np.int64) * ncb + cols.astype(np.int64)
    order = np.argsort(key, kind="stable")
    skey = key[order]
    if skey.size:
        boundary = np.empty(skey.size, dtype=bool)
        boundary[0] = True
        np.not_equal(skey[1:], skey[:-1], out=boundary[1:])
        starts = np.nonzero(boundary)[0]
        sums = np.add.reduceat(payload[order], starts, axis=0)
        ukeys = skey[starts]
    else:
        sums = np.zeros((0, bm, bn), np.float32)
        ukeys = np.empty(0, np.int64)

    ekey = (a.row // bm).astype(np.int64) * ncb + (a.col // bn).astype(np.int64)
    ref_keys = np.unique(ekey)
    if not np.array_equal(ukeys, ref_keys):
        missing = np.setdiff1d(ref_keys, ukeys)
        extra = np.setdiff1d(ukeys, ref_keys)

        def name(ks):
            return [(int(k) // ncb, int(k) % ncb) for k in ks[:3]]

        return [
            Finding(
                "matrix/conservation",
                "stored tile set diverges from the matrix's nonzero tiles "
                f"(missing (rb, cb): {name(missing)}, "
                f"spurious: {name(extra)})",
            )
        ]
    ref = np.zeros((ref_keys.size, bm, bn), np.float32)
    pos = np.searchsorted(ref_keys, ekey)
    ref[pos, a.row % bm, a.col % bn] = a.val.astype(np.float32)
    if view.tile_transform is not None:
        # A value view stores *raw* payloads and remaps the COO values
        # eagerly, so fn(float32(v)) vs float32(fn(float64 v)) may differ
        # in the last ulp — tolerance compare instead of bitwise.
        same = np.allclose(sums, ref, rtol=1e-6, atol=0.0, equal_nan=True)
    else:
        same = np.array_equal(sums, ref)
    if not same:
        t = int(np.nonzero((sums != ref).reshape(sums.shape[0], -1).any(axis=1))[0][0])
        k = int(ref_keys[t])
        return [
            Finding(
                "matrix/conservation",
                "tile payload diverges from the matrix values (an element "
                "is lost, altered, or double-stored)",
                where=f"tile (rb={k // ncb}, cb={k % ncb})",
            )
        ]
    return []


# ---------------------------------------------------------------------------
# full: repack equivalence (patched session ≡ cold replan, structurally)


@plan_pass("session/repack", level="full")
def _session_repack(view: PlanView):
    if view.matrix is None or view.elem_unit is None:
        return NotImplemented
    dp = view.device_plan
    elem_unit = np.asarray(view.elem_unit)
    if elem_unit.shape[0] != view.matrix.nnz:
        return [
            Finding(
                "session/repack",
                f"elem_unit has {elem_unit.shape[0]} entries for "
                f"{view.matrix.nnz} matrix elements",
            )
        ]
    cold = pack_units(view.matrix, elem_unit, dp.num_units, dp.bm, dp.bn)
    stored_tiles = dp.tiles
    value_view = view.tile_transform is not None
    if value_view:
        stored_tiles = np.asarray(view.tile_transform(stored_tiles), np.float32)
    bad = []
    for field, got in (
        ("tiles", stored_tiles),
        ("tile_row", dp.tile_row),
        ("tile_col", dp.tile_col),
        ("real_tiles", dp.real_tiles),
    ):
        exp = getattr(cold, field)
        if got.shape != exp.shape:
            bad.append(field)
        elif field == "tiles" and value_view:
            # fn over float32 storage vs float32(fn(float64)) — last-ulp
            # slack only (see matrix/conservation).
            if not np.allclose(got, exp, rtol=1e-6, atol=0.0, equal_nan=True):
                bad.append(field)
        elif not np.array_equal(got, exp):
            bad.append(field)
    if bad:
        return [
            Finding(
                "session/repack",
                "device plan is not bitwise pack_units(matrix, elem_unit) — "
                f"diverging fields: {', '.join(bad)} (a patched plan must "
                "equal the cold repack; exchange equality follows from the "
                "rebuild passes)",
            )
        ]
    return []


# ---------------------------------------------------------------------------
# archive passes (structure level; strict/full delegate to lint_session)


def _member_header(path: str, name: str):
    """``(shape, dtype)`` from one member's npy header, without reading
    its payload."""
    with zipfile.ZipFile(path) as zf, zf.open(name + ".npy") as fh:
        version = np.lib.format.read_magic(fh)
        if version == (1, 0):
            shape, _, dtype = np.lib.format.read_array_header_1_0(fh)
        elif version == (2, 0):
            shape, _, dtype = np.lib.format.read_array_header_2_0(fh)
        else:
            raise ValueError(f"member {name}.npy has npy format {version}")
    return shape, dtype


@archive_pass("archive/structure")
def _archive_structure(path: str) -> List[Finding]:
    from repro_torch.api.plancache import (
        READABLE_VERSIONS,
        expected_archive_members,
        read_archive_meta,
    )

    try:
        meta, names = read_archive_meta(path)
    except ValueError as e:
        return [Finding("archive/structure", str(e))]
    f: List[Finding] = []
    version = meta.get("version")
    if version not in READABLE_VERSIONS:
        f.append(
            Finding(
                "archive/structure",
                f"format v{version} not in readable versions "
                f"{READABLE_VERSIONS}",
            )
        )
        return f
    missing = expected_archive_members(meta) - names
    if missing:
        f.append(
            Finding(
                "archive/structure",
                f"missing required members: {sorted(missing)}",
            )
        )
    return f


@archive_pass("archive/integrity")
def _archive_integrity(path: str) -> List[Finding]:
    from repro_torch.api.plancache import verify_archive_payload

    try:
        verify_archive_payload(path)
    except ValueError as e:
        # The message already names the member and byte offset.
        return [Finding("archive/integrity", str(e))]
    return []


@archive_pass("archive/counts")
def _archive_counts(path: str) -> List[Finding]:
    """v2 ragged integrity: the leading dims of the ragged members must
    match the stored counts, and the padded capacities in meta must
    cover the counts — a truncated ragged member or tampered counts
    array fails here before any payload loads."""
    from repro_torch.api.plancache import read_archive_meta

    try:
        meta, names = read_archive_meta(path)
    except ValueError as e:
        return [Finding("archive/counts", str(e))]
    if meta.get("version") != 2:
        return []  # v1 stores padded arrays; shape checks happen on load
    f: List[Finding] = []

    def rows_of(name):
        shape, _ = _member_header(path, name)
        return int(shape[0]) if shape else 0

    try:
        with zipfile.ZipFile(path) as zf, zf.open("dp.real_tiles.npy") as fh:
            counts = np.lib.format.read_array(fh, allow_pickle=False)
        total = int(counts.sum())
        if (counts < 0).any():
            f.append(Finding("archive/counts", "negative dp.real_tiles entry"))
        t = meta["device_plan"]["t"]
        if t < int(counts.max(initial=0)) or t < 1:
            f.append(
                Finding(
                    "archive/counts",
                    f"padded capacity t={t} < max real tile count "
                    f"{int(counts.max(initial=0))}",
                )
            )
        for name in ("dp.tiles", "dp.tile_row", "dp.tile_col"):
            r = rows_of(name)
            if r != total:
                f.append(
                    Finding(
                        "archive/counts",
                        f"ragged member {name} has {r} rows, counts say "
                        f"{total}",
                        where=f"member {name}.npy",
                    )
                )
        ep = meta.get("exchange_plan")
        if ep and ep.get("kind") == "overlap" and ep.get("waves") is not None:
            with zipfile.ZipFile(path) as zf:
                with zf.open("op.local_counts.npy") as fh:
                    lc = np.lib.format.read_array(fh, allow_pickle=False)
                with zf.open("op.halo_wave_counts.npy") as fh:
                    hwc = np.lib.format.read_array(fh, allow_pickle=False)
            if not np.array_equal(lc + hwc.sum(axis=1), counts):
                f.append(
                    Finding(
                        "archive/counts",
                        "local_counts + halo_wave_counts do not partition "
                        "dp.real_tiles",
                    )
                )
            if hwc.shape[1] != ep["waves"]:
                f.append(
                    Finding(
                        "archive/counts",
                        f"halo_wave_counts has {hwc.shape[1]} waves, meta "
                        f"says {ep['waves']}",
                    )
                )
            if ep["t_local"] < int(lc.max(initial=0)) or ep["t_halo"] < int(
                hwc.max(initial=0)
            ):
                f.append(
                    Finding(
                        "archive/counts",
                        "overlap padded capacities below the real counts",
                    )
                )
            for name, want in (
                ("op.local_tiles", int(lc.sum())),
                ("op.local_row", int(lc.sum())),
                ("op.local_slot", int(lc.sum())),
                ("op.halo_tiles", int(hwc.sum())),
                ("op.halo_row", int(hwc.sum())),
                ("op.halo_slot", int(hwc.sum())),
            ):
                r = rows_of(name)
                if r != want:
                    f.append(
                        Finding(
                            "archive/counts",
                            f"ragged member {name} has {r} rows, counts say "
                            f"{want} (truncated or padded member)",
                            where=f"member {name}.npy",
                        )
                    )
    except (ValueError, KeyError, OSError, zipfile.BadZipFile) as e:
        f.append(Finding("archive/counts", f"count check failed: {e}"))
    return f


# ---------------------------------------------------------------------------
# entry points


def lint_plan(
    device_plan,
    exchange=None,
    *,
    matrix=None,
    elem_unit=None,
    exchange_name: Optional[str] = None,
    tile_transform=None,
    level: str = "structure",
) -> LintReport:
    """Lint in-memory plan artifacts. ``exchange`` is the exchange plan
    object (``None`` == replicated); ``matrix`` enables the strict
    conservation pass, ``elem_unit`` the full repack pass."""
    view = PlanView(
        device_plan=device_plan,
        exchange=exchange,
        matrix=matrix,
        elem_unit=elem_unit,
        exchange_name=exchange_name,
        tile_transform=tile_transform,
    )
    return run_plan_passes(view, level)


def lint_session(sess, *, level: str = "strict") -> LintReport:
    """Lint a :class:`SparseSession`'s planning artifacts at ``level``.

    ``structure`` touches only the device/exchange plans (a lazy
    session's matrix is not forced); ``strict`` adds the matrix
    conservation proof; ``full`` adds the repack-equivalence proof
    against the session's recorded partition."""
    need_matrix = level in ("strict", "full")
    return lint_plan(
        sess.device_plan,
        sess.selective,
        matrix=sess.matrix if need_matrix else None,
        elem_unit=sess.partition.elem_unit if level == "full" else None,
        exchange_name=sess.exchange,
        tile_transform=sess.tile_transform,
        level=level,
    )


def lint_archive(path: str, *, level: str = "structure") -> LintReport:
    """Lint one on-disk plan archive.

    Always runs the archive passes (structure, CRC integrity with
    member + byte offset, v2 ragged counts). At ``strict``/``full`` the
    session is then loaded and the in-memory passes run on it — but
    only when the archive passes came back clean (loading a damaged
    archive would just re-raise what the passes already localized)."""
    report = run_archive_passes(path, "structure")
    if level == "structure" or not report.ok:
        return LintReport(
            level=level,
            passes_run=report.passes_run,
            findings=report.findings,
            skipped=report.skipped,
        )
    from repro_torch.api.plancache import load_session

    try:
        # The passes read host arrays only and run no spmv, so the
        # session is loaded for the CPU whatever the caller's device.
        sess = load_session(path, lazy=False, device="cpu")
    except (ValueError, KeyError, OSError, zipfile.BadZipFile) as e:
        return LintReport(
            level=level,
            passes_run=report.passes_run + ("archive/load",),
            findings=report.findings + (Finding("archive/load", str(e)),),
            skipped=report.skipped,
        )
    plan_report = lint_session(sess, level=level)
    return LintReport(
        level=level,
        passes_run=report.passes_run + plan_report.passes_run,
        findings=report.findings + plan_report.findings,
        skipped=report.skipped + plan_report.skipped,
    )


def lint_store(directory: str, *, level: str = "structure"):
    """Lint every plan archive in a plan-store directory (``plan-*.npz``
    including generation archives and journal deltas are scanned for
    the ``plan-`` prefix; journals are skipped — they are not plan
    archives). Yields ``(path, LintReport)`` pairs, sorted by name."""
    for name in sorted(os.listdir(directory)):
        if not name.endswith(".npz") or ".tmp-" in name:
            continue
        if ".delta" in name:
            continue  # journal deltas are SparseDelta payloads, not plans
        if not name.startswith("plan-"):
            continue
        path = os.path.join(directory, name)
        yield path, lint_archive(path, level=level)
