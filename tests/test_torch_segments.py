"""The port's segmented event log, ``pio segments`` and ``pio fsck`` held
against the JAX package's, on the CPU.

Twin directories, each written by one package with the same events (ids
and times of their own) and a small rollover threshold:

- rollover, compaction and the manifest leave byte-equal files, and the
  sidecar-served scans (every filter, a creationTime window) equal a
  single-file scan of the same events, bitwise, in both packages;
- the local cold tier: shipped segments, a tombstone into a cold segment
  and a restart give the same reads and files, and each package reads the
  other's cold home;
- a restart after a torn tail: both engines quarantine the same bytes
  and read the same events;
- ``segments [--json]`` (status, compact, roll; the port's ``show`` is
  ``status``) and ``fsck [--json]
  [--repair]`` through both CLIs print the same lines and JSON (paths
  normalised) with the same exit codes: 0 clean, 2 for a flipped byte in
  a sealed segment (also after ``--repair``: frames are report-only), 2
  then 3 for a flipped byte in a compaction sidecar and for a torn active
  tail;
- both event servers spread an app's appends over ``quotas.json``'s
  writer shards alike and start the maintenance thread; each event-log
  fault site gives the same refusals; the port's vectorised fsck scanner
  gives the JAX scanner's reports on damaged logs.
"""

import json
import os
import shutil

import pytest

from tests.test_torch_eventlog import (
    APP,
    PKG,
    cols_tuple,
    js,
    log_files,
    log_store,
    rate_events,
    storage,
)


def write_rolled(pkg, directory, n=900, seg_bytes=4096, batch=150):
    s = log_store(pkg, directory, seg_bytes=seg_bytes)
    for lo in range(0, n, batch):
        s.insert_batch(rate_events(pkg, batch, start=lo, users=31, items=17,
                                   names=("rate", "buy", "view")), APP)
    return s


SCANS = [
    dict(value_key="rating"),
    dict(event_names=["buy"]),
    dict(event_names=["view", "rate"], value_key="rating"),
    dict(entity_type="user", target_entity_type="item"),
    dict(entity_type="item"),
    dict(created_after_us=1767312000_000000 + 200_000000,
         created_until_us=1767312000_000000 + 700_000000, value_key="rating"),
]


def test_roll_compact_and_sidecar_scans_match_jax(tmp_path):
    out, files = {}, {}
    for pkg in PKG:
        flat = write_rolled(pkg, tmp_path / f"{pkg}_flat", seg_bytes=0)
        want = [cols_tuple(flat.scan_columnar(APP, **kw)) for kw in SCANS]
        flat.close()
        s = write_rolled(pkg, tmp_path / pkg)
        ns = s._ns(APP, None)
        assert len(ns.sealed) >= 3
        raw = [cols_tuple(s.scan_columnar(APP, **kw)) for kw in SCANS]
        for seg in list(ns.sealed):
            ns.compact(seg)
        ns.finalize_all()
        assert all(seg.meta.cols for seg in ns.sealed)
        s.scan_workers = 3
        served = [cols_tuple(s.scan_columnar(APP, **kw)) for kw in SCANS]
        assert raw == want
        assert served == want
        out[pkg] = (want, js(s.find(APP)), s.creation_stats(APP))
        s.close()
        files[pkg] = log_files(tmp_path / pkg)
    assert out["port"] == out["jax"]
    assert files["port"] == files["jax"]
    assert any(f.endswith(".cols.npz") for f in files["port"])


def test_local_cold_tier_tombstones_and_restart(tmp_path, monkeypatch):
    out = {}
    for pkg in PKG:
        monkeypatch.setenv("PIO_SEGMENT_COLD", f"local:{tmp_path / pkg}_cold")
        s = write_rolled(pkg, tmp_path / pkg)
        ns = s._ns(APP, None)
        ns.roll()
        ns.finalize_all()
        assert all(ns.ship(seg) for seg in list(ns.sealed))
        assert all(seg.meta.state == "cold" for seg in ns.sealed)
        s.close()
        s = log_store(pkg, tmp_path / pkg, seg_bytes=4096)
        assert s.delete("ev00005", APP)  # lives in a cold segment
        over = rate_events(pkg, 1, start=400)[0]
        s.insert_batch([over], APP)      # an overwrite of a cold id
        s.close()
        s = log_store(pkg, tmp_path / pkg, seg_bytes=4096)
        out[pkg] = (js(s.find(APP)), s.get("ev00005", APP),
                    s.get("ev00400", APP).to_json_str(),
                    cols_tuple(s.scan_columnar(APP, value_key="rating")),
                    [seg.meta.state for seg in s._ns(APP, None).sealed])
        s.close()
        out[pkg] += (sorted(log_files(f"{tmp_path / pkg}_cold")),)
    assert out["port"] == out["jax"]
    assert out["port"][1] is None and len(out["port"][0]) == 899
    assert "cold" in out["port"][4]
    # each package reads the other's cold home
    for reader, writer in (("port", "jax"), ("jax", "port")):
        monkeypatch.setenv("PIO_SEGMENT_COLD", f"local:{tmp_path / writer}_cold")
        s = log_store(reader, tmp_path / writer, seg_bytes=4096)
        assert js(s.find(APP)) == out[writer][0]
        s.close()


def test_restart_after_a_torn_tail(tmp_path):
    base = tmp_path / "base"
    s = write_rolled("jax", base, n=300, seg_bytes=0)
    s.close()
    with open(base / "events_1.pel", "ab") as f:
        f.write(b"\x40\x00\x00\x00\x00torn-frame")  # a frame cut short
    out = {}
    for pkg in PKG:
        shutil.copytree(base, tmp_path / pkg)
        s = log_store(pkg, tmp_path / pkg)
        out[pkg] = (js(s.find(APP)), s.creation_stats(APP))
        s.insert_batch(rate_events(pkg, 5, start=300), APP)
        out[pkg] += (js(s.find(APP)),)
        s.close()
        out[pkg] += (log_files(tmp_path / pkg),)
    assert out["port"] == out["jax"]
    assert len(out["port"][0]) == 300 and len(out["port"][2]) == 305
    assert any(".quarantine-" in f for f in out["port"][3])


def cli(pkg, home, argv, capsys):
    """One verb of ``pkg``'s CLI on an EVENTLOG home: (code, output);
    ``{home}`` in an argument is the home."""
    reg, main = PKG[pkg][4], PKG[pkg][5].main
    reg.set_storage(storage(pkg, home))
    try:
        main([a.format(home=home) for a in argv])
        code = 0
    except SystemExit as e:
        code = e.code
    finally:
        st = reg.get_storage()
        reg.set_storage(None)
        if st._events is not None:
            st._events.close()
    return code, capsys.readouterr().out.replace(str(home), "{home}")


def both(homes, argv, capsys):
    """Run ``argv`` on each twin home; assert equal codes and output."""
    got = {pkg: cli(pkg, homes[pkg], argv, capsys) for pkg in PKG}
    assert got["port"] == got["jax"], argv
    return got["port"]


def flip(path, at=None):
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2 if at is None else at] ^= 0xFF
    open(path, "wb").write(blob)


def test_segments_and_fsck_through_both_clis(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("PIO_SCAN_CACHE_DIR", raising=False)
    monkeypatch.setenv("PIO_SEGMENT_BYTES", "4096")
    homes = {pkg: tmp_path / pkg for pkg in PKG}
    both(homes, ("app", "new", "App1", "--access-key", "K1"), capsys)
    for part in range(2):  # each import is one append that then rolls
        dump = tmp_path / f"dump{part}.jsonl"
        with open(dump, "w", encoding="utf-8") as f:
            for e in rate_events("port", 300, start=300 * part, users=23, items=11,
                                 names=("rate", "buy")):
                f.write(e.to_json_str() + "\n")
        both(homes, ("import", "--app-name", "App1", "--input", str(dump)), capsys)
    both(homes, ("segments", "roll"), capsys)
    code, text = both(homes, ("segments", "--json"), capsys)
    doc = json.loads(text)
    assert code == 0 and len(doc["namespaces"][0]["sealed"]) >= 2
    code, text = both(homes, ("segments", "compact", "--json"), capsys)
    assert json.loads(text)["compacted"] >= 2
    status = both(homes, ("segments",), capsys)
    assert both(homes, ("segments", "status"), capsys) == status
    # the port's `show` is its name for the JAX package's `status`
    assert cli("port", homes["port"], ("segments", "show"), capsys) == status
    code, text = both(homes, ("fsck", "--home", "{home}", "--json"), capsys)
    assert code == 0 and json.loads(text)["corrupt"] == 0
    code, _ = both(homes, ("fsck", "--home", "{home}"), capsys)
    assert code == 0

    def damaged(kind):
        out = {}
        for pkg in PKG:
            d = tmp_path / f"{pkg}_{kind}"
            shutil.copytree(homes[pkg], d)
            seg_dir = d / "eventlog" / "events_1.peld"
            if kind == "frame":
                flip(sorted(seg_dir.glob("seg-*.pel"))[0])
            elif kind == "sidecar":
                flip(sorted(seg_dir.glob("seg-*.cols.npz"))[0])
            else:
                with open(d / "eventlog" / "events_1.pel", "ab") as f:
                    f.write(b"\x40\x00\x00\x00\x00torn")
            out[pkg] = d
        return out

    for kind, repaired in (("frame", 2), ("sidecar", 3), ("torn", 3)):
        twins = damaged(kind)
        code, text = both(twins, ("fsck", "--home", "{home}", "--json"), capsys)
        assert code == 2, kind
        assert json.loads(text)["corrupt"] == 1
        code, _ = both(twins, ("fsck", "--home", "{home}"), capsys)
        assert code == 2
        code, text = both(twins, ("fsck", "--home", "{home}", "--repair", "--json"), capsys)
        assert code == repaired, kind
        if repaired == 3:
            code, _ = both(twins, ("fsck", "--home", "{home}"), capsys)
            assert code == 0, kind
    # fsck of a home that does not exist is an operational error
    code, _ = both({p: tmp_path / "absent" for p in PKG},
                   ("fsck", "--home", "{home}"), capsys)
    assert code == 1


def test_segments_refuses_other_backends(tmp_path, capsys):
    for pkg in PKG:
        reg, main = PKG[pkg][4], PKG[pkg][5].main
        reg.set_storage(storage(pkg, tmp_path / pkg, events="SQLITE"))
        try:
            with pytest.raises(SystemExit) as e:
                main(["segments"])
            assert e.value.code == 1
        finally:
            reg.set_storage(None)
    err = capsys.readouterr().err
    assert err.count("requires the EVENTLOG backend") == 2


FAULTS = {"jax": __import__("predictionio_tpu.utils.faults", fromlist=["FAULTS"]).FAULTS,
          "port": __import__("predictionio_tpu_torch.utils.faults",
                             fromlist=["FAULTS"]).FAULTS}


@pytest.fixture
def disarmed():
    yield
    for registry in FAULTS.values():
        registry.disarm()


def test_fault_sites_of_the_event_log_match_jax(tmp_path, monkeypatch, disarmed):
    """Each event-log fault site armed alike in both packages: the same
    refusals, reports and files."""
    from predictionio_tpu.data import pel_integrity as jax_pel
    from predictionio_tpu_torch.data import pel_integrity as port_pel

    pel = {"jax": jax_pel, "port": port_pel}
    out = {}
    for pkg in PKG:
        registry, got = FAULTS[pkg], []
        # segments.shard.hot: every append on writer shard 0
        s = log_store(pkg, tmp_path / pkg / "hot")
        s.set_shard_policy(lambda app_id: 4)
        registry.arm("segments.shard.hot", error="hot partition drill")
        s.insert_batch(rate_events(pkg, 40), APP)
        registry.disarm()
        s.close()
        got.append({f: len(b) for f, b in log_files(tmp_path / pkg / "hot").items()})
        # segments.cold and data.corrupt.segment on a cold fetch
        for site in ("segments.cold", "data.corrupt.segment"):
            home = tmp_path / pkg / site
            monkeypatch.setenv("PIO_SEGMENT_COLD", f"local:{home}_cold")
            s = write_rolled(pkg, home, n=600)
            ns = s._ns(APP, None)
            ns.finalize_all()
            assert all(ns.ship(seg) for seg in list(ns.sealed))
            s.close()
            s = log_store(pkg, home, seg_bytes=4096)
            registry.arm(site, error="cold tier down")
            with pytest.raises(Exception) as e:
                list(s.find(APP))
            got.append((site, type(e.value).__name__))
            registry.disarm()
            assert len(list(s.find(APP))) == 600
            s.close()
        # data.corrupt.eventlog and data.corrupt.model under fsck
        registry.arm("data.corrupt.eventlog")
        rep = pel[pkg].scan_pel(str(tmp_path / pkg / "hot" / "events_1.pel"))
        got.append({k: v for k, v in rep.items() if k != "path"})
        registry.disarm()
        blob = tmp_path / pkg / "models" / "inst" / "model.bin"
        blob.parent.mkdir(parents=True)
        blob.write_bytes(b"model bytes" * 10)
        (blob.parent / "model.bin.sha256").write_text(
            __import__("hashlib").sha256(blob.read_bytes()).hexdigest())
        registry.arm("data.corrupt.model")
        got.append(pel[pkg].check_model(str(blob))["status"])
        registry.disarm()
        got.append(pel[pkg].check_model(str(blob))["status"])
        # data.corrupt.snapshot: the snapshot is refused and rebuilt
        snap = __import__(f"{'predictionio_tpu' if pkg == 'jax' else 'predictionio_tpu_torch'}"
                          ".data.snapshot", fromlist=["save_snapshot"])
        s = log_store(pkg, home, seg_bytes=4096)
        cols = s.scan_columnar(APP, value_key="rating")
        s.close()
        assert snap.save_snapshot(str(tmp_path / pkg / "snap"), "fp", cols, 100, cols.n)
        registry.arm("data.corrupt.snapshot")
        got.append(snap.load_snapshot(str(tmp_path / pkg / "snap"), "fp"))
        registry.disarm()
        got.append(cols_tuple(snap.load_snapshot(str(tmp_path / pkg / "snap"), "fp")[0]))
        out[pkg] = got
    assert out["port"] == out["jax"]
    sizes = out["port"][0]  # every event on shard 0, the others empty
    assert sizes["events_1.pel"] > 1000
    assert {sizes[f"events_1.s{k}.pel"] for k in (1, 2, 3)} == {len(b"PELOGv2\n")}
    assert [x[1] for x in out["port"][1:3]] == ["FaultError", "IntegrityError"]
    assert out["port"][3]["corrupt"] == 1 and out["port"][4:6] == ["corrupt", "ok"]
    assert out["port"][6] is None


def test_vectorised_scan_reports_equal_the_jax_scanner(tmp_path, monkeypatch):
    """The port's fsck walks frames in one loop and checks every record's
    crc32c and structure at once in numpy; on clean, v1, torn and
    damaged logs its reports are the JAX package's, byte flip by byte
    flip, and so are the segment reports its worker processes give."""
    import dataclasses

    import numpy as np

    from predictionio_tpu.data import pel_integrity as jax_pel
    from predictionio_tpu_torch.data import pel_integrity as port_pel

    logs = []
    for fmt in ("2", "1"):
        monkeypatch.setenv("PIO_EVENTLOG_FORMAT", fmt)
        s = log_store("port", tmp_path / f"v{fmt}")
        evs = rate_events("port", 300, users=13, items=7)
        # long and odd-sized payloads: the scalar crc path and both parities
        evs[5] = dataclasses.replace(evs[5], properties={"blob": "x" * 40_000})
        evs[6] = dataclasses.replace(evs[6], properties={"b": "y" * 17})
        s.insert_batch(evs, APP)
        s.delete("ev00009", APP)
        s.close()
        logs.append(tmp_path / f"v{fmt}" / "events_1.pel")
    rng = np.random.default_rng(0)
    cases = []
    for log in logs:
        blob = log.read_bytes()
        cases.append(blob)
        cases.append(blob + b"\x07\x00\x00")                 # torn
        cases.append(blob[:len(blob) - 11])                  # cut mid-frame
        for at in [0, 3, 8, 9, 12, 13, 20, 40] + rng.integers(
                0, len(blob), 40).tolist():
            b = bytearray(blob)
            b[at] ^= 0xFF if at % 2 else 0x01
            cases.append(bytes(b))
    for i, blob in enumerate(cases):
        p = tmp_path / f"case{i}.pel"
        p.write_bytes(blob)
        assert port_pel.scan_pel(str(p)) == jax_pel.scan_pel(str(p)), i
    # sealed segments, scanned in worker processes
    s = write_rolled("port", tmp_path / "seg" / "eventlog", n=900)
    s.close()
    seg_dir = tmp_path / "seg" / "eventlog" / "events_1.peld"
    flip(sorted(seg_dir.glob("seg-*.pel"))[1])
    want = jax_pel.check_segment_dir(str(seg_dir))
    monkeypatch.setattr(port_pel, "PARALLEL_SCAN_BYTES", 0)
    assert port_pel._scan_all_sealed([str(p) for p in seg_dir.glob("seg-*.pel")])
    assert port_pel.check_segment_dir(str(seg_dir)) == want
    assert [r["status"] for r in want].count("corrupt") == 1


def test_event_server_writer_shards_and_maintenance(tmp_path, capsys):
    """Both event servers on twin EVENTLOG homes: `app quota
    --writer-shards 3` fans the app's appends across three writer shards
    (the same files, byte for byte), and `--segment-maintenance` starts
    the store's maintenance thread."""
    from predictionio_tpu.server.event_server import EventServer as JaxEventServer
    from predictionio_tpu_torch.server.event_server import EventServer
    from tests.test_torch_event_server import ServerThread, request

    servers = {"jax": lambda st: JaxEventServer(storage=st, host="127.0.0.1", port=0,
                                                plugins=[], segment_maintenance=True),
               "port": lambda st: EventServer(storage=st, host="127.0.0.1", port=0,
                                              segment_maintenance=True)}
    body = [json.loads(e.to_json_str()) for e in rate_events("port", 50, users=17)]
    out = {}
    for pkg in PKG:
        home = tmp_path / pkg
        for argv in (("app", "new", "A", "--access-key", "K"),
                     ("app", "quota", "A", "--writer-shards", "3")):
            assert cli(pkg, home, argv, capsys)[0] == 0, argv
        st = storage(pkg, home)
        try:
            with ServerThread(servers[pkg](st)) as srv:
                status, answer, _ = request(srv.port, "POST",
                                            "/batch/events.json?accessKey=K", body)
                alive = st.events._maintenance.is_alive()
        finally:
            st.events.close()
        out[pkg] = (status, answer, alive, log_files(home / "eventlog"))
    assert out["port"] == out["jax"]
    status, answer, alive, files = out["port"]
    assert status == 200 and [a["status"] for a in answer] == [201] * 50 and alive
    assert {f for f, b in files.items() if len(b) > len(b"PELOGv2\n")} == {
        "events_1.pel", "events_1.s1.pel", "events_1.s2.pel"}
