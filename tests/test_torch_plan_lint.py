"""The port's plan linter (:mod:`repro_torch.analysis`) against the JAX
package's, on the CPU.

The case-for-case port of ``tests/test_plan_lint.py`` — zero false
positives on golden plans, every corruption of the seeded mutation
corpus flagged — with one more demand on every case: the JAX package's
linter, given the same plan arrays (carried over into its own
dataclasses) or the same archive file, reports the same passes and the
same findings, message for message. The corpus covers dropped and
duplicated tiles, duplicated halo entries, wave overlap, a stale
``tile_col_local``, a mis-owned x block, bad local/halo counts, value
and repack divergence, and on disk a truncated ragged member, a flipped
payload byte, a missing member and tampered counts.
"""
import dataclasses
import io
import zipfile

import numpy as np
import pytest

import repro.analysis as jx_lint
import repro.api.plancache as jx_plancache
import repro.pmvc.plan_device as jx_plan
from repro.analysis.__main__ import main as jx_main
from repro.sparse.formats import COO as JxCOO
from repro_torch.analysis import (
    PlanLintError,
    lint_archive,
    lint_plan,
    lint_session,
    lint_store,
)
from repro_torch.analysis.__main__ import main
from repro_torch.api.plancache import archive_members, save_session, verify_archive_payload
from repro_torch.api.session import SparseSession, distribute
from repro_torch.api.topology import Topology
from repro_torch.sparse.delta import SparseDelta
from repro_torch.sparse.generate import PAPER_SUITE, generate

TOPO = Topology(nodes=2, cores=2)
CPU = "cpu"
_JX_TYPES = {"DevicePlan": jx_plan.DevicePlan, "SelectivePlan": jx_plan.SelectivePlan,
             "OverlapPlan": jx_plan.OverlapPlan, "COO": JxCOO}


def _session(name="thermal", exchange="overlap:2", **kw):
    a = generate(PAPER_SUITE[name], seed=0)
    return distribute(a, topology=TOPO, exchange=exchange, device=CPU, **kw)


@pytest.fixture(scope="module")
def overlap_sess():
    return _session()


def _to_jax(obj):
    """A plan dataclass of the port as the JAX package's own, same arrays."""
    if dataclasses.is_dataclass(obj):
        return _JX_TYPES[type(obj).__name__](
            **{f.name: _to_jax(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
        )
    return obj


def _same(rp, rj):
    """Two lint reports, one per package, say the same thing."""
    assert (rp.level, rp.passes_run, rp.skipped) == (rj.level, rj.passes_run, rj.skipped)
    assert [(f.pass_name, f.message, f.where) for f in rp.findings] == [
        (f.pass_name, f.message, f.where) for f in rj.findings
    ]
    return rp


def _lint_both(dp, ex, *, level="structure", matrix=None, elem_unit=None, **kw):
    rp = lint_plan(dp, ex, matrix=matrix, elem_unit=elem_unit, level=level, **kw)
    rj = jx_lint.lint_plan(_to_jax(dp), _to_jax(ex), matrix=_to_jax(matrix),
                           elem_unit=elem_unit, level=level, **kw)
    return _same(rp, rj)


def _lint_session_both(sess, level):
    need_matrix = level in ("strict", "full")
    return _lint_both(
        sess.device_plan, sess.selective, level=level,
        matrix=sess.matrix if need_matrix else None,
        elem_unit=sess.partition.elem_unit if level == "full" else None,
        exchange_name=sess.exchange, tile_transform=sess.tile_transform,
    )


def _archive_both(path, level="structure"):
    return _same(lint_archive(path, level=level), jx_lint.lint_archive(path, level=level))


# ---------------------------------------------------------------- clean plans


@pytest.mark.parametrize(
    "name", sorted(n for n, spec in PAPER_SUITE.items() if spec.n <= 20000)
)
def test_no_false_positives_paper_suite(name):
    for exchange in ("replicated", "selective", "overlap:2"):
        sess = _session(name, exchange)
        for level in ("structure", "strict", "full"):
            report = lint_session(sess, level=level)
            assert report.ok, f"{name}/{exchange}/{level}: {report}"
            assert report == _lint_session_both(sess, level)


@pytest.mark.parametrize("fmt", [1, 2])
@pytest.mark.parametrize("exchange", ["replicated", "selective", "overlap", "overlap:2"])
def test_no_false_positives_archives(tmp_path, fmt, exchange):
    sess = _session("bcsstm09", exchange)
    if fmt == 1 and exchange == "overlap:2":  # v1 predates multi-wave archives
        with pytest.raises(ValueError, match="predates multi-wave"):
            save_session(sess, str(tmp_path / "plan-a.npz"), format_version=fmt)
        return
    path = save_session(sess, str(tmp_path / "plan-a.npz"), format_version=fmt)
    for level in ("structure", "strict", "full"):
        report = _archive_both(path, level)
        assert report.ok, f"v{fmt}/{exchange}/{level}: {report}"


def test_clean_value_view_session():
    sess = _session("bcsstm09", "selective").with_value_map(np.abs)
    for level in ("structure", "strict", "full"):
        report = lint_session(sess, level=level)
        assert report.ok, str(report)
        _lint_session_both(sess, level)


def test_clean_patched_session():
    sess = _session("bcsstm09", "overlap:2")
    a = sess.matrix
    delta = SparseDelta.upserts(a.shape, a.row[:5], a.col[:5], a.val[:5] * 2.0)
    patched = sess.update(delta)
    for level in ("structure", "strict", "full"):
        report = lint_session(patched, level=level)
        assert report.ok, str(report)
        _lint_session_both(patched, level)
    assert patched.verify("full").ok


def test_verify_api_and_raise(overlap_sess):
    report = overlap_sess.verify(level="full")
    assert report.ok and "OK" in str(report)
    dp = overlap_sess.device_plan
    tiles = dp.tiles.copy()
    u = int(np.argmax(dp.real_tiles > 0))
    tiles[u, 0, 0, 0] += 1.0
    bad = dataclasses.replace(dp, tiles=tiles)
    broken = SparseSession(
        overlap_sess.matrix,
        overlap_sess.topology,
        overlap_sess.partition,
        bad,
        exchange=overlap_sess.exchange,
        selective=overlap_sess.selective,
        executor=overlap_sess.executor,
        device=overlap_sess.device,
    )
    with pytest.raises(PlanLintError) as ei:
        broken.verify(level="strict")
    assert "conservation" in str(ei.value) or "rebuild" in str(ei.value)
    assert str(ei.value.report) == str(_lint_session_both(broken, "strict"))


def test_distribute_validate_strict():
    a = generate(PAPER_SUITE["bcsstm09"], seed=0)
    sess = distribute(a, topology=TOPO, exchange="overlap:2", validate="strict", device=CPU)
    assert sess.verify(level="strict").ok


# ------------------------------------------------------------ mutation corpus


def _findings(dp, ex, level="strict", matrix=None, **kw):
    report = _lint_both(dp, ex, level=level, matrix=matrix, **kw)
    assert not report.ok, "mutation not flagged"
    return {f.pass_name for f in report.findings}


def test_mutation_dropped_tile(overlap_sess):
    dp = overlap_sess.device_plan
    rt = dp.real_tiles.copy()
    rt[0] -= 1
    names = _findings(dataclasses.replace(dp, real_tiles=rt), overlap_sess.selective)
    assert names & {"device/padding", "overlap/counts"}


def test_mutation_duplicated_tile(overlap_sess):
    dp = overlap_sess.device_plan
    u = int(np.argmax(dp.real_tiles >= 2))
    tr, tc = dp.tile_row.copy(), dp.tile_col.copy()
    tr[u, 1], tc[u, 1] = tr[u, 0], tc[u, 0]
    names = _findings(
        dataclasses.replace(dp, tile_row=tr, tile_col=tc), overlap_sess.selective
    )
    assert "device/tile-order" in names


def test_mutation_stale_tile_col_local(overlap_sess):
    op = overlap_sess.selective
    sel = op.selective
    tcl = sel.tile_col_local.copy()
    tcl[0, 0] = (tcl[0, 0] + 1) % max(2, int(tcl.max()) + 1)
    bad = dataclasses.replace(op, selective=dataclasses.replace(sel, tile_col_local=tcl))
    names = _findings(overlap_sess.device_plan, bad)
    assert "exchange/tile-col-local" in names


def test_mutation_mis_owned_block(overlap_sess):
    op = overlap_sess.selective
    sel = op.selective
    ow = sel.owned.copy()
    ow[0, 0], ow[1, 0] = ow[1, 0], ow[0, 0]
    bad = dataclasses.replace(op, selective=dataclasses.replace(sel, owned=ow))
    names = _findings(overlap_sess.device_plan, bad)
    assert names & {"exchange/owned", "exchange/delivery"}


def test_mutation_undelivered_block(overlap_sess):
    op = overlap_sess.selective
    sel = op.selective
    si = sel.send_idx.copy()
    s, d, lane = np.argwhere(si >= 0)[0]
    si[s, d, lane] = -1
    bad = dataclasses.replace(op, selective=dataclasses.replace(sel, send_idx=si))
    names = _findings(overlap_sess.device_plan, bad)
    assert "exchange/delivery" in names


def _dup_wave_send(op):
    wsi = op.wave_send_idx.copy()
    u_n, nw = wsi.shape[0], wsi.shape[1]
    for s in range(u_n):
        for k in range(nw):
            for d in range(u_n):
                lanes = wsi[s, k, d]
                used = np.nonzero(lanes >= 0)[0]
                free = np.nonzero(lanes < 0)[0]
                if used.size and free.size:
                    wsi[s, k, d, free[0]] = lanes[used[0]]
                    return wsi
    raise AssertionError("no (src, wave, dst) with a free lane")


def test_mutation_duplicated_halo_entry(overlap_sess):
    bad = dataclasses.replace(overlap_sess.selective,
                              wave_send_idx=_dup_wave_send(overlap_sess.selective))
    names = _findings(overlap_sess.device_plan, bad, level="structure")
    assert "overlap/waves" in names


def test_mutation_wave_overlap(overlap_sess):
    op = overlap_sess.selective
    wsi = op.wave_send_idx.copy()
    s, d, lane = np.argwhere(wsi[:, 0] >= 0)[0]
    free = np.nonzero(wsi[s, 1, d] < 0)[0]
    assert free.size, "wave 1 has a free lane for this pair on the thermal plan"
    wsi[s, 1, d, free[0]] = wsi[s, 0, d, lane]
    bad = dataclasses.replace(op, wave_send_idx=wsi)
    names = _findings(overlap_sess.device_plan, bad, level="structure")
    assert "overlap/waves" in names


def test_mutation_bad_counts(overlap_sess):
    op = overlap_sess.selective
    lc = op.local_counts.copy()
    lc[0] += 1
    names = _findings(overlap_sess.device_plan, dataclasses.replace(op, local_counts=lc),
                      level="structure")
    assert "overlap/counts" in names


def test_mutation_value_divergence(overlap_sess):
    dp = overlap_sess.device_plan
    tiles = dp.tiles.copy()
    u = int(np.argmax(dp.real_tiles > 0))
    tiles[u, 0, 0, 0] += 0.5
    names = _findings(dataclasses.replace(dp, tiles=tiles), overlap_sess.selective,
                      matrix=overlap_sess.matrix)
    assert names & {"matrix/conservation", "overlap/rebuild"}


def test_mutation_repack_divergence(overlap_sess):
    dp = overlap_sess.device_plan
    elem_unit = np.asarray(overlap_sess.partition.elem_unit).copy()
    elem_unit[0] = (elem_unit[0] + 1) % dp.num_units
    report = _lint_both(dp, overlap_sess.selective, matrix=overlap_sess.matrix,
                        elem_unit=elem_unit, level="full")
    assert not report.ok
    assert "session/repack" in {f.pass_name for f in report.findings}


# ------------------------------------------------------------ archive corpus


def _save(tmp_path, name="plan-c.npz", fmt=2, exchange="overlap:2"):
    sess = _session("bcsstm09", exchange)
    return save_session(sess, str(tmp_path / name), format_version=fmt)


def _member_range(path, member):
    info = archive_members(path)[member]
    return info["payload_offset"], info["size"]


def test_archive_truncated_ragged_member(tmp_path):
    path = _save(tmp_path)
    off, size = _member_range(path, "dp.tiles")
    with open(path, "r+b") as fh:
        fh.truncate(off + size // 2)
    report = _archive_both(path)
    assert not report.ok
    joined = str(report)
    assert "dp.tiles" in joined or "truncated" in joined


def test_archive_flipped_payload_byte(tmp_path):
    path = _save(tmp_path)
    off, size = _member_range(path, "dp.tile_col")
    with open(path, "r+b") as fh:
        fh.seek(off + size - 1)
        b = fh.read(1)
        fh.seek(off + size - 1)
        fh.write(bytes([b[0] ^ 0xFF]))
    report = _archive_both(path)
    assert not report.ok
    msg = str(report)
    assert "dp.tile_col" in msg and "offset" in msg


def test_archive_missing_member(tmp_path):
    path = _save(tmp_path)
    clone = str(tmp_path / "plan-m.npz")
    with zipfile.ZipFile(path) as zin, zipfile.ZipFile(clone, "w") as zout:
        for info in zin.infolist():
            if info.filename == "sp.owned.npy":
                continue
            zout.writestr(info, zin.read(info.filename))
    report = _archive_both(clone)
    assert not report.ok
    assert "sp.owned" in str(report)


def test_archive_tampered_counts(tmp_path):
    path = _save(tmp_path)
    clone = str(tmp_path / "plan-t.npz")
    with zipfile.ZipFile(path) as zin:
        names = zin.namelist()
        payload = {n: zin.read(n) for n in names}
    counts = np.lib.format.read_array(
        io.BytesIO(payload["op.local_counts.npy"]), allow_pickle=False
    ).copy()
    counts[0] += 1
    out = io.BytesIO()
    np.lib.format.write_array(out, counts, allow_pickle=False)
    payload["op.local_counts.npy"] = out.getvalue()
    with zipfile.ZipFile(clone, "w") as zout:
        for n in names:
            zout.writestr(n, payload[n])
    report = _archive_both(clone)
    assert not report.ok
    assert "archive/counts" in {f.pass_name for f in report.findings}


def test_load_failure_names_member_and_offset(tmp_path):
    path = _save(tmp_path)
    off, size = _member_range(path, "dp.tile_row")
    with open(path, "r+b") as fh:
        fh.seek(off)
        fh.write(b"\xde\xad\xbe\xef")
    with pytest.raises(ValueError) as ei:
        verify_archive_payload(path)
    msg = str(ei.value)
    assert "dp.tile_row" in msg and str(off) in msg
    with pytest.raises(ValueError) as ej:
        jx_plancache.verify_archive_payload(path)
    assert msg == str(ej.value)


def test_lint_store_walks_directory(tmp_path):
    good = _save(tmp_path, "plan-good.npz")
    bad = _save(tmp_path, "plan-bad.npz")
    off, size = _member_range(bad, "dp.tiles")
    with open(bad, "r+b") as fh:
        fh.seek(off)
        fh.write(b"\x00" * 4)
    (tmp_path / "notes.txt").write_text("x")
    results = dict(lint_store(str(tmp_path)))
    assert set(results) == {good, bad}
    assert results[good].ok and not results[bad].ok
    for path, report in jx_lint.lint_store(str(tmp_path)):
        _same(results[path], report)


def test_cli_main(tmp_path, capsys):
    good = _save(tmp_path, "plan-good.npz")
    assert main([str(tmp_path)]) == 0
    assert main([str(tmp_path), "--level", "full"]) == 0
    with open(good, "r+b") as fh:
        off, _ = _member_range(good, "dp.tiles")
        fh.seek(off)
        fh.write(b"\xff\xff")
    capsys.readouterr()
    assert main([str(tmp_path)]) == 1
    out = capsys.readouterr().out
    assert "finding" in out
    assert jx_main([str(tmp_path)]) == 1
    assert capsys.readouterr().out == out
