"""The port's fileset tools (m3_tpu_torch/tools: fileset_tools and the
`python -m m3_tpu_torch.tools` CLI) against the reference's
(m3_tpu/tools), on the CPU.

Mirrors tests/test_services_tools.py's TestTools. Each package's tools
also run on a data dir written by the other (the packages write
byte-identical filesets), and the outputs and the CLI exit codes are
equal. The port's stated divergences are held too: verify_index_files
lets a device fault propagate where the reference reports it as
corruption, and also checks each bloom (a bloom that diverges past the
digests is corrupt in the port and passes in the reference);
read_index_files reports the index entries the file holds where the
reference raises AttributeError, and the verify_commitlogs CLI prints
its namespaces as text where the reference's json.dumps of bytes
raises."""

import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

from m3_tpu.parallel.sharding import ShardSet as JShardSet
from m3_tpu.persist import fs as jfs
from m3_tpu.persist.commitlog import CommitLog as JCommitLog
from m3_tpu.storage.database import Database as JDatabase
from m3_tpu.storage.namespace import NamespaceOptions as JNamespaceOptions
from m3_tpu.tools import __main__ as jcli
from m3_tpu.tools import fileset_tools as jft
from m3_tpu_torch.parallel import guard
from m3_tpu_torch.parallel.sharding import ShardSet
from m3_tpu_torch.persist import fs as pfs
from m3_tpu_torch.persist.commitlog import CommitLog
from m3_tpu_torch.storage.database import Database
from m3_tpu_torch.storage.namespace import NamespaceOptions
from m3_tpu_torch.testing.cluster import SettableClock
from m3_tpu_torch.tools import __main__ as cli
from m3_tpu_torch.tools import fileset_tools as ft

S = 1_000_000_000
T0 = 1_600_000_000 * S
NS = b"default"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _seed(root, writer, n_series=3, points=30, commitlog_dir=None):
    """tests/test_services_tools.py TestTools._seed in either package:
    one namespace of 600 s blocks, `points` writes round-robin over
    `n_series` series, sealed and flushed under root/data."""
    clock = SettableClock(T0)
    if writer == "ref":
        cl = JCommitLog(commitlog_dir) if commitlog_dir else None
        db = JDatabase(JShardSet(4), commitlog=cl, clock=clock)
        db.create_namespace(NS, JNamespaceOptions(index_enabled=False,
                                                  block_size_ns=600 * S))
        pm = jfs.PersistManager(str(root / "data"))
    else:
        cl = CommitLog(commitlog_dir) if commitlog_dir else None
        db = Database(ShardSet(4), commitlog=cl, clock=clock, device="cpu")
        db.create_namespace(NS, NamespaceOptions(index_enabled=False,
                                                 block_size_ns=600 * S))
        pm = pfs.PersistManager(str(root / "data"))
    for i in range(points):
        clock.advance(10 * S)
        db.write(NS, b"tool.series.%d" % (i % n_series), clock(),
                 float(i) * 1.25 - 3.0)
    clock.advance(1800 * S)
    db.tick()
    assert db.flush(pm) > 0
    db.close()
    return str(root / "data")


@pytest.fixture(params=["ref", "port"])
def data(request, tmp_path):
    """(data root, writer package) of a seeded dir."""
    return _seed(tmp_path, request.param), request.param


def _shards(root):
    return [s for s in range(4) if pfs.PersistManager(root).list_filesets(
        NS, s)]


def _rows(it):
    return [(sid, t.tobytes(), v.tobytes()) for sid, t, v in it]


def _run(main, argv):
    """(exit code, stdout) of a CLI main called in process."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


class TestTools:
    def test_read_and_verify(self, data):
        root, _ = data
        shards = _shards(root)
        assert shards
        for shard in shards:
            ids = ft.read_ids(root, NS, shard, device="cpu")
            assert ids and all(i.startswith(b"tool.series") for i in ids)
            assert ids == jft.read_ids(root, NS, shard)
            rows = _rows(ft.read_data_files(root, NS, shard, device="cpu"))
            assert rows and all(len(t) > 0 for _, t, _ in rows)
            assert rows == _rows(jft.read_data_files(root, NS, shard))
            out = ft.verify_index_files(root, NS, shard, device="cpu")
            assert out["ok"] and not out["corrupt"]
            assert out == jft.verify_index_files(root, NS, shard)

    def test_every_written_point_reads_back(self, data):
        root, _ = data
        got = {}
        for shard in _shards(root):
            for sid, t, v in ft.read_data_files(root, NS, shard,
                                                device="cpu"):
                got.setdefault(sid, ([], []))
                got[sid][0].extend(t.tolist())
                got[sid][1].extend(v.tolist())
        want = {}
        for i in range(30):
            sid = b"tool.series.%d" % (i % 3)
            want.setdefault(sid, ([], []))
            want[sid][0].append(T0 + (i + 1) * 10 * S)
            want[sid][1].append(float(i) * 1.25 - 3.0)
        assert got == want

    def test_block_start_filter(self, data):
        root, _ = data
        shard = _shards(root)[0]
        starts = [bs for bs, _ in pfs.PersistManager(root).list_filesets(
            NS, shard)]
        for bs in starts + [starts[0] + 1]:
            assert _rows(ft.read_data_files(root, NS, shard, bs,
                                            device="cpu")) == \
                _rows(jft.read_data_files(root, NS, shard, bs))

    def test_clone_and_corruption_detection(self, data, tmp_path):
        root, _ = data
        shard = _shards(root)[0]
        clone = str(tmp_path / "clone")
        cloned = ft.clone_fileset(root, clone, NS, shard)
        assert cloned
        assert [os.path.relpath(p, clone) for p in cloned] == [
            os.path.relpath(p, str(tmp_path / "jclone"))
            for p in jft.clone_fileset(root, str(tmp_path / "jclone"), NS,
                                       shard)]
        out = ft.verify_index_files(clone, NS, shard, device="cpu")
        assert out["ok"]
        data_file = os.path.join(cloned[0], "data.bin")
        with open(data_file, "r+b") as f:
            f.seek(0)
            f.write(b"\xff\xff\xff\xff")
        out = ft.verify_index_files(clone, NS, shard, device="cpu")
        assert out["corrupt"] and out["corrupt"][0][0] == cloned[0]
        assert out == jft.verify_index_files(clone, NS, shard)

    def test_corrupt_index_row_reported_by_both(self, data):
        """A row checksum that diverges past the digests is corrupt in
        both packages (the port finds it verifying rows, the reference
        when it decodes the row)."""
        root, _ = data
        shard = _shards(root)[0]
        path = pfs.PersistManager(root).list_filesets(NS, shard)[0][1]
        idx = os.path.join(path, pfs.INDEX_FILE)
        raw = bytearray(open(idx, "rb").read())
        raw[16] ^= 0xFF
        open(idx, "wb").write(bytes(raw))
        _rechain(path, pfs.INDEX_FILE)
        out = ft.verify_index_files(root, NS, shard, device="cpu")
        want = jft.verify_index_files(root, NS, shard)
        assert [p for p, _ in out["corrupt"]] == [p for p, _ in
                                                  want["corrupt"]] == [path]

    def test_bloom_divergence_corrupt_only_in_the_port(self, data):
        root, _ = data
        shard = _shards(root)[0]
        path = pfs.PersistManager(root).list_filesets(NS, shard)[0][1]
        bloom = os.path.join(path, pfs.BLOOM_FILE)
        raw = bytearray(open(bloom, "rb").read())
        raw[0] ^= 0x01
        open(bloom, "wb").write(bytes(raw))
        _rechain(path, pfs.BLOOM_FILE)
        out = ft.verify_index_files(root, NS, shard, device="cpu")
        assert [p for p, _ in out["corrupt"]] == [path]
        assert "bloom" in out["corrupt"][0][1]
        want = jft.verify_index_files(root, NS, shard)
        assert path in want["ok"] and not want["corrupt"]
        assert sorted(out["ok"] + [path]) == sorted(want["ok"])

    @pytest.mark.parametrize("fault", [
        guard.KernelFault("decode", "injected"),
        RuntimeError("m3_tpu_torch: no CUDA device is available")])
    def test_device_fault_propagates(self, data, monkeypatch, fault):
        """The stated divergence: a device fault is not a corrupt
        fileset. The reference reports the same raise as corruption."""
        root, _ = data
        shard = _shards(root)[0]

        def boom(self):
            raise fault

        monkeypatch.setattr(pfs.FilesetReader, "verify_rows", boom)
        with pytest.raises(type(fault)):
            ft.verify_index_files(root, NS, shard, device="cpu")
        monkeypatch.setattr(jfs.FilesetReader, "to_block", boom)
        assert jft.verify_index_files(root, NS, shard)["corrupt"]

    def test_read_index_files(self, data):
        root, _ = data
        shard = _shards(root)[0]
        out = ft.read_index_files(root, NS, shard)
        assert sorted({e["id"] for fs in out for e in fs["entries"]}) == \
            ft.read_ids(root, NS, shard, device="cpu")
        reader = pfs.FilesetReader(out[0]["path"], device="cpu")
        assert [e["checksum"] for e in out[0]["entries"]] == [
            e.checksum for e in reader.entries]
        with pytest.raises(AttributeError):
            jft.read_index_files(root, NS, shard)

    def test_verify_commitlogs_equal(self, tmp_path):
        for writer in ("ref", "port"):
            d = str(tmp_path / f"cl-{writer}")
            _seed(tmp_path / writer, writer, commitlog_dir=d)
            assert ft.verify_commitlogs(d) == jft.verify_commitlogs(d)
            out = ft.verify_commitlogs(d)
            assert out["entries"] == 30 and out["num_series"] == 3
            assert not out["errors"]

    def test_readers_refuse_without_a_card(self, data, monkeypatch):
        import torch

        root, _ = data
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        for call in (lambda: ft.read_data_files(root, NS, 0),
                     lambda: ft.read_ids(root, NS, 0),
                     lambda: ft.verify_index_files(root, NS, 0)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


def _rechain(path, name):
    """Recompute the digest chain around an edited component so the
    file-level checks pass (tests/test_torch_fileset.py)."""
    digests = json.load(open(os.path.join(path, pfs.DIGEST_FILE)))
    digests[name] = pfs._adler(os.path.join(path, name))
    with open(os.path.join(path, pfs.DIGEST_FILE), "w") as f:
        json.dump(digests, f)
    with open(os.path.join(path, pfs.CHECKPOINT_FILE), "w") as f:
        json.dump({"digest": pfs._adler(os.path.join(path, pfs.DIGEST_FILE))},
                  f)


class TestCLI:
    @pytest.mark.parametrize("tool", ["read_data_files", "read_ids",
                                      "verify_index_files"])
    def test_decoding_tools_equal_reference(self, data, tool):
        root, _ = data
        for shard in range(4):
            argv = [tool, "--root", root, "--namespace", "default",
                    "--shard", str(shard)]
            assert _run(cli.main, argv + ["--device", "cpu"]) == \
                _run(jcli.main, argv)

    def test_corrupt_copy_exits_1_in_both(self, data, tmp_path):
        root, _ = data
        shard = _shards(root)[0]
        clone = str(tmp_path / "clone")
        argv = ["clone_fileset", "--root", root, "--namespace", "default",
                "--shard", str(shard), "--dst", clone]
        rc, out = _run(cli.main, argv)
        assert rc == 0 and out.split() == _run(jcli.main, argv)[1].split()
        path = out.split()[0]
        with open(os.path.join(path, "data.bin"), "r+b") as f:
            f.seek(3)
            b = f.read(1)
            f.seek(3)
            f.write(bytes([b[0] ^ 0x10]))
        argv = ["verify_index_files", "--root", clone, "--namespace",
                "default", "--shard", str(shard)]
        rc, out = _run(cli.main, argv + ["--device", "cpu"])
        assert (rc, out) == _run(jcli.main, argv)
        assert rc == 1 and json.loads(out)["corrupt"][0][0] == path

    def test_verify_commitlogs_and_index_files_cli(self, tmp_path):
        d = str(tmp_path / "cl")
        root = _seed(tmp_path, "port", commitlog_dir=d)
        argv = ["verify_commitlogs", "--dir", d]
        rc, out = _run(cli.main, argv)
        assert rc == 0 and json.loads(out) == {
            **ft.verify_commitlogs(d), "namespaces": ["default"]}
        with pytest.raises(TypeError):  # the reference dumps bytes
            _run(jcli.main, argv)
        rc, out = _run(cli.main, ["read_index_files", "--root", root,
                                  "--namespace", "default", "--shard",
                                  str(_shards(root)[0])])
        assert rc == 0 and json.loads(out.splitlines()[0])["entries"]

    @pytest.mark.parametrize("tool", ["read_index_files", "clone_fileset"])
    def test_host_tools_take_no_device(self, data, tool, capsys):
        """Only the decoding tools take --device; a host-only tool refuses
        it as the reference's CLI does."""
        root, _ = data
        argv = [tool, "--root", root, "--namespace", "default", "--shard",
                "0", "--device", "cpu"]
        if tool == "clone_fileset":
            argv += ["--dst", root + "-clone"]
        for main in (cli.main, jcli.main):
            with pytest.raises(SystemExit) as err:
                main(argv)
            assert err.value.code == 2
        assert "--device" in capsys.readouterr().err

    def test_subprocess_cli_on_cpu_and_without_a_card(self, data):
        """`python -m m3_tpu_torch.tools` as operators run it: with
        --device cpu it prints what the reference prints; without a card
        and without --device it exits non-zero with the resolve message."""
        root, _ = data
        shard = _shards(root)[0]
        argv = ["read_data_files", "--root", root, "--namespace", "default",
                "--shard", str(shard)]
        env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
        res = subprocess.run(
            [sys.executable, "-m", "m3_tpu_torch.tools", *argv, "--device",
             "cpu"], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=120)
        assert res.returncode == 0, res.stderr
        assert res.stdout == _run(jcli.main, argv)[1]
        # The last stderr line: this process's kernel launches (none on
        # the CPU, where the wrappers run their plain versions).
        head, _, counts = res.stderr.strip().splitlines()[-1].partition(
            " kernel launches ")
        assert head == "m3_tpu_torch read_data_files" and json.loads(
            counts) == {"pack": 0, "decode": 0, "hash": 0, "window": 0}
        res = subprocess.run(
            [sys.executable, "-m", "m3_tpu_torch.tools", *argv], cwd=ROOT,
            env=env, capture_output=True, text=True, timeout=120)
        assert res.returncode != 0 and res.stdout == ""
        assert "no CUDA device" in res.stderr


def test_carbon_load_lines_equal_reference():
    """carbon_load's lines (fixed clock and values) equal the
    reference's."""
    got = {}
    for name, mod in (("ref", jft), ("port", ft)):
        srv = socket.create_server(("127.0.0.1", 0))
        buf = bytearray()

        def serve():
            conn, _ = srv.accept()
            with conn:
                while chunk := conn.recv(65536):
                    buf.extend(chunk)

        th = threading.Thread(target=serve, daemon=True)
        th.start()
        try:
            endpoint = "%s:%d" % srv.getsockname()
            sent = mod.carbon_load(endpoint, [b"a.b", b"c.d"], qps=2000,
                                   duration_s=0.05, value_fn=lambda i: i * 0.5,
                                   clock=lambda: 1_600_000_000)
            th.join(timeout=10)
        finally:
            srv.close()
        lines = bytes(buf).splitlines()
        assert len(lines) == sent > 0
        got[name] = lines
    n = min(len(got["ref"]), len(got["port"]))
    assert got["port"][:n] == got["ref"][:n]
    assert got["port"][0] == b"a.b 0.000000 1600000000"


def test_written_by_the_other_package_reads_equal(tmp_path):
    """A dir written by each package: the port's tools read the
    reference's dir to the rows the reference's tools read from the
    port's, and the other way round."""
    ref_root = _seed(tmp_path / "r", "ref", n_series=7, points=70)
    port_root = _seed(tmp_path / "p", "port", n_series=7, points=70)
    for shard in range(4):
        a = _rows(ft.read_data_files(ref_root, NS, shard, device="cpu"))
        b = _rows(jft.read_data_files(port_root, NS, shard))
        assert a == b
        assert ft.read_ids(port_root, NS, shard, device="cpu") == \
            jft.read_ids(ref_root, NS, shard)
    assert np.array_equal(
        sorted(os.listdir(os.path.join(ref_root, "default"))),
        sorted(os.listdir(os.path.join(port_root, "default"))))
