"""The port's engine snapshots, restore, ``resume_engine`` and request
journal against the reference (the config, weights, policy, helpers and
tolerances of ``tests/test_torch_serve_durable.py``).

Within the port a restored run is bit for bit (FF scores included) the
uninterrupted one, as the reference's restart tests hold it; the
uninterrupted runs are the reference's tokens; a snapshot written by
either package resumes in the other.  Local generators only.
"""

import os
import warnings

import numpy as np
import pytest

import repro_torch.ff as port_ff
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro.serve import resume_engine as ref_resume_engine
from repro_torch.serve import (OK, SNAPSHOT_SCHEMA, TIMEOUT, JournalWarning,
                               Request, ServeEngine, resume_engine)
from test_torch_serve_durable import (FIELDS, PORT_CFG, REF_CFG,  # noqa: F401
                                      _assert_bitwise, _assert_like_reference,
                                      _port_engine, _port_run, _prompts,
                                      _ref_engine, _ref_run, _ref_scope,
                                      _reqs, weights)


def _restart_reqs(seed, n=3, max_new=6, **kw):
    rng = np.random.default_rng(seed)
    lens = rng.integers(5, 14, size=n)
    return _reqs([rng.integers(1, FIELDS["vocab_size"], size=int(s))
                  .astype(np.int32) for s in lens], max_new=max_new, **kw)


RESTART = dict(max_batch=2, page_size=4, max_ctx=32)


@pytest.mark.parametrize("kv_mode", ["bf16", "f32", "ff_bf16"])
def test_snapshot_restore_exact_replay(weights, kv_mode):
    """Interrupted after 3 steps and restored into a fresh engine: tokens
    and FF limb pairs bit for bit the uninterrupted run, whose tokens are
    the reference's."""
    ref_w, port_w = weights
    reqs = _restart_reqs(782)
    kw = dict(RESTART, kv_mode=kv_mode)
    _, ref_res = _ref_run(ref_w, reqs, **kw)
    _, base = _port_run(port_w, reqs, **kw)
    _assert_like_reference(base, ref_res)
    src = _port_engine(port_w, **kw)
    for r in reqs:
        src.submit(Request(**r))
    for _ in range(3):
        src.step()
    arrays, meta = src.snapshot()
    assert meta["schema"] == SNAPSHOT_SCHEMA
    assert all(isinstance(a, np.ndarray) for a in arrays.values())
    dst = _port_engine(port_w, **kw)
    dst.restore(arrays, meta, downtime_s=0.0)
    _assert_bitwise(dst.run(), base)


def test_disk_roundtrip_resume_engine(weights, tmp_path):
    """save_snapshot -> resume_engine through the checkpoint files, with
    the journal attached: bit for bit the uninterrupted run, and the
    journal empty once every request retired."""
    _, port_w = weights
    reqs = _restart_reqs(783)
    _, base = _port_run(port_w, reqs, **RESTART)
    wal, snap = str(tmp_path / "wal.jsonl"), str(tmp_path / "snap")
    src = _port_engine(port_w, journal=wal, **RESTART)
    for r in reqs:
        src.submit(Request(**r))
    for _ in range(3):
        src.step()
    src.save_snapshot(snap)
    del src
    with port_ff.policy("ff_reduce", attention="pallas"):
        eng = resume_engine(port_w, PORT_CFG, snap, journal=wal,
                            device="cpu", **RESTART)
    _assert_bitwise(eng.run(), base)
    assert os.path.getsize(wal) == 0, "journal must truncate once clean"


def test_restore_rejects_schema_and_fingerprint_mismatch(weights):
    _, port_w = weights
    reqs = _restart_reqs(784, n=2)
    src = _port_engine(port_w, **RESTART)
    for r in reqs:
        src.submit(Request(**r))
    src.step()
    arrays, meta = src.snapshot()
    with pytest.raises(ValueError, match="schema"):
        _port_engine(port_w, **RESTART).restore(
            arrays, dict(meta, schema=SNAPSHOT_SCHEMA + 1))
    with pytest.raises(ValueError, match="kv_mode"):
        _port_engine(port_w, kv_mode="f32", **RESTART).restore(arrays, meta)
    with pytest.raises(ValueError, match="policy_repr"):
        ServeEngine(port_w, PORT_CFG, device="cpu",
                    **RESTART).restore(arrays, meta)
    busy = _port_engine(port_w, **RESTART)
    busy.submit(Request(**reqs[0]))
    with pytest.raises(RuntimeError, match="freshly constructed"):
        busy.restore(arrays, meta)


@pytest.mark.parametrize("knobs", [
    {}, dict(kv_mode="ff_bf16", reserve="prompt", sync_every=3,
             num_pages=9, max_queue=4, guard="check"),
    dict(eos_id=5, kv_mode="f32")])
def test_fingerprint_matches_reference(weights, knobs):
    """The same engine fingerprints alike in both packages (the policy's
    repr included), so snapshots cross between them."""
    ref_w, port_w = weights
    kw = dict(RESTART, **knobs)
    assert _port_engine(port_w, **kw)._fingerprint() == \
        _ref_engine(ref_w, **kw)._fingerprint()


def test_guard_state_survives_restore(weights):
    """guard_stats ride the snapshot; a guard-mode mismatch raises."""
    _, port_w = weights
    src = _port_engine(port_w, guard="check", **RESTART)
    for r in _restart_reqs(785, n=2):
        src.submit(Request(**r))
    for _ in range(2):
        src.step()
    src.guard_stats["flagged_rows"] += 3
    src.guard_stats["preempted"] += 1
    arrays, meta = src.snapshot()
    with pytest.raises(ValueError, match="guard"):
        _port_engine(port_w, guard="off", **RESTART).restore(arrays, meta)
    dst = _port_engine(port_w, guard="check", **RESTART)
    dst.restore(arrays, meta, downtime_s=0.0)
    assert dst.guard_stats["flagged_rows"] == 3
    assert dst.guard_stats["preempted"] == 1
    dst.guard_stats["flagged_rows"] += 2
    assert dst.snapshot()[1]["guard_stats"]["flagged_rows"] == 5
    assert all(r.status == OK for r in dst.run().values())


def test_wall_clock_deadline_expires_across_downtime(weights):
    """A running request whose deadline_s passed during the downtime
    retires TIMEOUT at restore with its partial tokens; the other one
    completes."""
    _, port_w = weights
    p = _prompts((6, 9), seed=786)
    src = _port_engine(port_w, **RESTART)
    src.submit(Request(uid=0, prompt=p[0], max_new=6, deadline_s=30.0))
    src.submit(Request(uid=1, prompt=p[1], max_new=6))
    for _ in range(3):
        src.step()
    arrays, meta = src.snapshot()
    dst = _port_engine(port_w, **RESTART)
    dst.restore(arrays, meta, downtime_s=120.0)
    assert dst.results[0].status == TIMEOUT
    assert "downtime" in dst.results[0].detail
    assert 0 < len(dst.results[0].tokens) < 6
    res = dst.run()
    assert res[1].status == OK and len(res[1].tokens) == 6


def test_step_deadline_unaffected_by_downtime(weights):
    _, port_w = weights
    src = _port_engine(port_w, **RESTART)
    for r in _restart_reqs(787, n=2, deadline_steps=64):
        src.submit(Request(**r))
    for _ in range(3):
        src.step()
    arrays, meta = src.snapshot()
    dst = _port_engine(port_w, **RESTART)
    dst.restore(arrays, meta, downtime_s=3600.0)
    res = dst.run()
    assert all(r.status == OK and len(r.tokens) == 6 for r in res.values())


def test_journal_replays_crash_lost_submissions_in_order(weights, tmp_path):
    """Submissions journaled but never snapshotted are re-admitted in
    order on resume and give the uninterrupted tokens."""
    _, port_w = weights
    reqs = _restart_reqs(788)
    _, base = _port_run(port_w, reqs, **RESTART)
    wal = str(tmp_path / "wal.jsonl")
    crashed = _port_engine(port_w, journal=wal, **RESTART)
    for r in reqs:
        crashed.submit(Request(**r))
    del crashed                      # a crash before any snapshot
    with port_ff.policy("ff_reduce", attention="pallas"):
        eng = resume_engine(port_w, PORT_CFG, str(tmp_path / "no-snap"),
                            journal=wal, device="cpu", **RESTART)
    assert [q["req"].uid for q in eng.queue] == [r["uid"] for r in reqs]
    _assert_bitwise(eng.run(), base)
    assert os.path.getsize(wal) == 0


def test_journal_skips_torn_tail_line(weights, tmp_path):
    _, port_w = weights
    wal = str(tmp_path / "wal.jsonl")
    crashed = _port_engine(port_w, journal=wal, **RESTART)
    for r in _restart_reqs(789, n=2):
        crashed.submit(Request(**r))
    del crashed
    with open(wal, "a") as f:
        f.write('{"op": "submit", "uid": 9, "prom')     # torn mid-record
    with pytest.warns(JournalWarning):
        with port_ff.policy("ff_reduce", attention="pallas"):
            eng = resume_engine(port_w, PORT_CFG, str(tmp_path / "none"),
                                journal=wal, device="cpu", **RESTART)
    assert [q["req"].uid for q in eng.queue] == [0, 1]
    assert sorted(eng.run()) == [0, 1]


def test_run_snapshot_every_and_write_errors(weights, tmp_path):
    """run(snapshot_dir=, snapshot_every=) leaves verifiable generations
    (the last after the drain) that resume to the finished results; a
    failing write warns, counts in snapshot_errors and serving goes on."""
    from repro_torch.checkpoint import available_steps
    _, port_w = weights
    reqs = _restart_reqs(790)
    snap = str(tmp_path / "snap")
    eng = _port_engine(port_w, **RESTART)
    for r in reqs:
        eng.submit(Request(**r))
    res = eng.run(snapshot_dir=snap, snapshot_every=2)
    steps = available_steps(snap)
    assert steps and steps[-1] == eng.decode_steps and len(steps) <= 3
    with port_ff.policy("ff_reduce", attention="pallas"):
        back = resume_engine(port_w, PORT_CFG, snap, device="cpu")
    _assert_bitwise(back.results, res)

    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "step_00000002.tmp").write_text("in the way")
    eng = _port_engine(port_w, **RESTART)
    for r in reqs:
        eng.submit(Request(**r))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = eng.run(snapshot_dir=str(bad), snapshot_every=2)
    assert eng.guard_stats["snapshot_errors"] >= 1
    assert any("snapshot write failed" in str(x.message) for x in w)
    _assert_bitwise(got, res)


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
@pytest.mark.parametrize("kv_mode", ["bf16", "ff_bf16"])
def test_snapshot_crosses_packages(weights, tmp_path, direction, kv_mode):
    """A snapshot written by one package after 3 steps resumes in the
    other (its checkpoint files, its journal) and ends with the tokens of
    the writer's uninterrupted run."""
    ref_w, port_w = weights
    reqs = _restart_reqs(791)
    kw = dict(RESTART, kv_mode=kv_mode)
    snap, wal = str(tmp_path / "snap"), str(tmp_path / "wal.jsonl")
    if direction == "ref_to_port":
        _, base = _ref_run(ref_w, reqs, **kw)
        with _ref_scope():
            src = RefEngine(ref_w, REF_CFG, journal=wal, **kw)
            for r in reqs:
                src.submit(RefRequest(**r))
            for _ in range(3):
                src.step()
            src.save_snapshot(snap)
        with port_ff.policy("ff_reduce", attention="pallas"):
            eng = resume_engine(port_w, PORT_CFG, snap, journal=wal,
                                device="cpu")
        res = eng.run()
    else:
        _, base = _port_run(port_w, reqs, **kw)
        src = _port_engine(port_w, journal=wal, **kw)
        for r in reqs:
            src.submit(Request(**r))
        for _ in range(3):
            src.step()
        src.save_snapshot(snap)
        with _ref_scope():
            eng = ref_resume_engine(ref_w, REF_CFG, snap, journal=wal)
            res = eng.run()
    assert eng.decode_steps > 3
    _assert_like_reference(res, base)
    assert os.path.getsize(wal) == 0
