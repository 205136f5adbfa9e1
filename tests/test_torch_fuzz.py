"""Port of tests/test_fuzz.py on m3_tpu_torch: the same cases on the
port's modules, with device None resolving to the CPU
(tests/test_torch_cpu_default.py).

Cheap structured fuzzing of the parse/ingest boundaries (the closest
Python analog of the reference's go-fuzz corpus targets): random inputs
must produce clean, typed errors — never hangs, crashes, or silent
acceptance of garbage."""

import json
import string

import numpy as np
import pytest

from m3_tpu_torch.query import promql
from test_torch_cpu_default import cpu_default  # noqa: F401


class FakeSock:
    """List-backed socket stand-in: raises ConnectionError at exhaustion so
    reader loops can never hang in a test."""

    def __init__(self, data):
        self.data = data

    def recv(self, n):
        out, self.data = self.data[:n], self.data[n:]
        if not out:
            raise ConnectionError("eof")
        return out


class TestPromqlParserFuzz:
    def test_random_token_soup_never_crashes(self):
        rng = np.random.default_rng(7)
        atoms = ["metric", "rate", "sum", "by", "(", ")", "[", "]", "{", "}",
                 "5m", ":", "@", "offset", "1h", "+", "-", "*", "/", "==",
                 "bool", "on", ",", '"v"', "0.5", "or", "unless", "!~", "=",
                 "1e9", "nan", "inf", "group_left", "}"]
        ok = errs = 0
        for _ in range(3000):
            n = int(rng.integers(1, 12))
            q = " ".join(str(atoms[i]) for i in rng.integers(0, len(atoms), n))
            try:
                promql.parse(q)
                ok += 1
            except promql.ParseError:
                errs += 1
            # anything else (IndexError, RecursionError, hang) fails the test
        assert ok + errs == 3000
        assert errs > 0  # the soup does hit error paths

    def test_random_bytes_never_crash(self):
        rng = np.random.default_rng(11)
        chars = string.printable
        for _ in range(2000):
            n = int(rng.integers(1, 40))
            q = "".join(chars[i] for i in rng.integers(0, len(chars), n))
            try:
                promql.parse(q)
            except promql.ParseError:
                pass

    def test_deep_nesting_bounded(self):
        # pathological nesting must error or parse, not blow the stack
        q = "(" * 400 + "x" + ")" * 400
        try:
            promql.parse(q)
        except (promql.ParseError, RecursionError):
            # RecursionError is acceptable ONLY if raised promptly as an
            # error (python guards the stack); a segfault/hang is not.
            pass


class TestMigrationReaderFuzz:
    def test_random_streams_error_cleanly(self):
        """Random byte streams through the dual-format reader: every
        outcome must be a typed error or a decoded record — never a hang
        (the reader's _fill would block on a socket; a list-backed fake
        raising ConnectionError on exhaustion makes hangs impossible) and
        never an unbounded allocation."""
        from m3_tpu_torch.aggregator import migration

        rng = np.random.default_rng(13)
        outcomes = {"records": 0, "recoverable": 0, "fatal": 0}
        for _ in range(800):
            n = int(rng.integers(4, 80))
            blob = bytes(rng.integers(0, 256, n, dtype=np.uint8))
            r = migration.MigrationReader(FakeSock(blob))
            try:
                r.read_entries()
                outcomes["records"] += 1
            except migration.RecoverableRecordError:
                outcomes["recoverable"] += 1
            except (ValueError, ConnectionError, KeyError, EOFError):
                outcomes["fatal"] += 1
        assert outcomes["fatal"] > 0
        assert sum(outcomes.values()) == 800

    def test_legacy_json_line_fuzz(self):
        from m3_tpu_torch.aggregator import migration

        rng = np.random.default_rng(17)
        for _ in range(300):
            # random json-ish objects on the legacy line protocol
            obj = {k: int(v) for k, v in
                   zip(rng.choice(list("abcdef"), 3), rng.integers(0, 9, 3))}
            line = json.dumps(obj).encode() + b"\n"
            r = migration.MigrationReader(FakeSock(line))
            try:
                r.read_entries()
            except (migration.RecoverableRecordError, ValueError,
                    ConnectionError):
                pass


class TestWireFuzz:
    def test_random_buffers_raise_valueerror_only(self):
        """wire.decode on arbitrary bytes: ValueError (or its subclasses,
        e.g. UnicodeDecodeError from string fields) for every malformed
        buffer — struct.error from truncated fixed-width fields is
        normalized so protocol handlers catch ONE exception type."""
        from m3_tpu_torch.rpc import wire

        rng = np.random.default_rng(5)
        ok = bad = 0
        for _ in range(1500):
            blob = bytes(rng.integers(0, 256, int(rng.integers(0, 80)),
                                      dtype=np.uint8))
            try:
                wire.decode(blob)
                ok += 1
            except ValueError:
                bad += 1
        assert ok + bad == 1500 and bad > 0

    def test_roundtrip_survives_fuzzed_payloads(self):
        from m3_tpu_torch.rpc import wire

        rng = np.random.default_rng(19)
        for _ in range(200):
            payload = {
                "b": bytes(rng.integers(0, 256, 8, dtype=np.uint8)),
                "i": int(rng.integers(-2**62, 2**62)),
                "f": float(rng.standard_normal()),
                "l": [int(x) for x in rng.integers(0, 100, 3)],
            }
            assert wire.decode(wire.encode(payload)) == payload


    def test_deep_nesting_rejected(self):
        from m3_tpu_torch.rpc import wire

        # ~3000 nested lists: must be a ValueError (depth cap), not a
        # RecursionError killing a handler thread
        blob = b"\x07\x01\x00\x00\x00" * 3000 + b"\x00"
        with pytest.raises(ValueError):
            wire.decode(blob)
        # legitimate shallow nesting still decodes
        v = [[[{"k": [1, 2]}]]]
        assert wire.decode(wire.encode(v)) == v

    def test_non_dict_frame_drops_connection_not_thread(self):
        """A well-formed frame whose top value isn't a dict must close the
        connection without a handler traceback (node_server shape check)."""
        import io
        import socket
        import struct
        import sys

        from m3_tpu_torch.parallel.sharding import ShardSet
        from m3_tpu_torch.rpc import wire
        from m3_tpu_torch.rpc.node_server import NodeServer, NodeService
        from m3_tpu_torch.storage.database import Database

        db = Database(ShardSet(2), clock=lambda: 0)
        db.mark_bootstrapped()
        srv = NodeServer(NodeService(db)).start()
        host, port = srv.address
        errbuf = io.StringIO()
        old = sys.stderr
        sys.stderr = errbuf
        try:
            for payload in (wire.encode(None), wire.encode(123),
                            wire.encode([1, 2])):
                with socket.create_connection((host, port), timeout=5) as s:
                    s.sendall(struct.pack("<I", len(payload)) + payload)
                    s.settimeout(5)
                    with pytest.raises((ConnectionError, socket.timeout,
                                        ValueError)):
                        wire.read_frame(s)
            with socket.create_connection((host, port), timeout=5) as s:
                wire.write_frame(s, {"id": 1, "m": "health", "a": {}})
                assert wire.read_frame(s)["ok"]
        finally:
            sys.stderr = old
            srv.close()
        assert "Traceback" not in errbuf.getvalue()


    def test_non_dict_frame_all_servers(self):
        """The shared read_dict_frame guard covers every server loop: a
        valid frame with a non-dict top value drops the connection on the
        KV service too (was an AttributeError traceback)."""
        import io
        import socket
        import struct
        import sys

        from m3_tpu_torch.cluster.kv import MemStore
        from m3_tpu_torch.cluster.kv_service import KVServer
        from m3_tpu_torch.rpc import wire

        srv = KVServer(MemStore()).start()
        host, _, port = srv.endpoint.rpartition(":")
        port = int(port)
        errbuf = io.StringIO()
        old = sys.stderr
        sys.stderr = errbuf
        try:
            payload = wire.encode(123)
            with socket.create_connection((host, port), timeout=5) as s:
                s.sendall(struct.pack("<I", len(payload)) + payload)
                s.settimeout(5)
                with pytest.raises((ConnectionError, socket.timeout,
                                    ValueError)):
                    wire.read_frame(s)
        finally:
            sys.stderr = old
            srv.close()
        assert "Traceback" not in errbuf.getvalue()

    def test_encode_depth_cap_fails_at_sender(self):
        from m3_tpu_torch.rpc import wire

        v = None
        for _ in range(80):
            v = [v]
        with pytest.raises(ValueError):
            wire.encode(v)

    def test_truncated_frames_raise_wire_truncated(self):
        """A peer dying at ANY byte offset inside a frame (header or
        body) surfaces as the single typed WireTruncated — never a
        struct.error or short-read garbage — so retriers classify it as
        a retryable transport failure."""
        import socket
        import struct

        from m3_tpu_torch.rpc import wire
        from m3_tpu_torch.rpc.wire import WireTruncated

        body = wire.encode({"k": [1, 2.5, b"x" * 20, "s"],
                            "arr": np.arange(4, dtype=np.int64)})
        frame = struct.pack("<I", len(body)) + body
        rng = np.random.default_rng(23)
        cuts = {1, 2, 3, 4, len(frame) - 1} | {
            int(c) for c in rng.integers(1, len(frame), 30)}
        for cut in sorted(cuts):
            a, b = socket.socketpair()
            a.sendall(frame[:cut])
            a.close()
            b.settimeout(5)
            with pytest.raises(WireTruncated):
                wire.read_frame(b)
            b.close()

    def test_oversized_frame_length_rejected(self):
        """A corrupt length prefix past MAX_FRAME is a typed ValueError
        BEFORE any allocation or read of the announced body."""
        import socket
        import struct

        from m3_tpu_torch.rpc import wire

        for n in (wire.MAX_FRAME + 1, 0xFFFFFFFF):
            a, b = socket.socketpair()
            a.sendall(struct.pack("<I", n))
            b.settimeout(5)
            with pytest.raises(ValueError):
                wire.read_frame(b)
            a.close()
            b.close()

    def test_frame_mutations_only_typed_errors(self):
        """Random frame mutations (bit flips, length corruption, tail
        truncation) through a real socket: read_frame yields a decoded
        value, ValueError, or ConnectionError — nothing else, ever."""
        import socket
        import struct

        from m3_tpu_torch.rpc import wire

        rng = np.random.default_rng(31)
        base = wire.encode({"m": "w", "a": {"ids": [b"a", b"b"],
                                            "vals": [1.0, 2.0]}})
        outcomes = {"ok": 0, "value": 0, "conn": 0}
        for _ in range(120):
            blob = bytearray(struct.pack("<I", len(base)) + base)
            mode = int(rng.integers(0, 3))
            if mode == 0:    # flip a byte anywhere
                i = int(rng.integers(0, len(blob)))
                blob[i] ^= int(rng.integers(1, 256))
            elif mode == 1:  # corrupt the length prefix
                blob[int(rng.integers(0, 4))] ^= int(rng.integers(1, 256))
            else:            # truncate the tail
                blob = blob[: int(rng.integers(1, len(blob)))]
            a, b = socket.socketpair()
            a.sendall(bytes(blob))
            a.close()
            b.settimeout(5)
            try:
                wire.read_frame(b)
                outcomes["ok"] += 1
            except ConnectionError:
                outcomes["conn"] += 1
            except ValueError:
                outcomes["value"] += 1
            finally:
                b.close()
        assert sum(outcomes.values()) == 120
        assert outcomes["conn"] > 0 and outcomes["value"] > 0


class TestTbatchDispatchFuzz:
    """Malformed columnar timed-batch frames through dispatch_entry: every
    outcome is a typed error counted by the server's per-entry handler or
    a clean (possibly partial-free) ingest — never a crash that kills the
    connection thread, and NEVER a partial ingest on a frame that errors
    (all-or-nothing contract, server.py dispatch_timed_batch)."""

    def _agg(self):
        from m3_tpu_torch.aggregator import Aggregator, CaptureHandler

        S = 1_000_000_000
        return Aggregator(num_shards=4, clock=lambda: 1_700_000_000 * S,
                          flush_handler=CaptureHandler())

    def test_fuzzed_tbatch_frames(self):
        from m3_tpu_torch.aggregator.server import dispatch_entry

        S = 1_000_000_000
        t0 = 1_700_000_000 * S
        rng = np.random.default_rng(29)
        mutations = [
            lambda f: f.pop("ids"),
            lambda f: f.pop("times"),
            lambda f: f.pop("values"),
            lambda f: f.update(ids=f["ids"][:-1]),          # ragged
            lambda f: f.update(times=f["times"][:-1]),      # ragged
            lambda f: f.update(mtype=99),                   # bad type
            lambda f: f.update(policy="nonsense"),          # bad policy
            lambda f: f.update(policy=123),                 # wrong type
            lambda f: f.update(ids=[*f["ids"][:-1], "str"]),  # non-bytes id
            lambda f: f.update(times="not-an-array"),
            lambda f: f.update(values=None),
            # element-level shapes the pre-round-6 validator admitted and
            # then crashed on (or silently mis-ingested) MID-LOOP:
            lambda f: f.update(times=[*map(int, f["times"][:-1]), "x"]),
            lambda f: f.update(values=[*map(float, f["values"][:-1]), None]),
            lambda f: f.update(times=[*map(int, f["times"][:-1]), [1, 2]]),
            lambda f: f.update(values=object()),            # no len/iter
        ]
        for i in range(len(mutations) * 3):
            agg = self._agg()
            n = int(rng.integers(1, 8))
            frame = {"t": "tbatch", "mtype": 1, "policy": "10s:2d",
                     "agg_id": 0,
                     "ids": [b"fz.%d" % j for j in range(n)],
                     "times": np.full(n, t0, np.int64),
                     "values": np.arange(n, dtype=np.float64)}
            mutations[i % len(mutations)](frame)
            try:
                dispatch_entry(agg, frame)
            except Exception:  # noqa: BLE001 - typed by the server handler
                # the all-or-nothing contract: an erroring frame must not
                # have staged ANY entries
                assert agg.num_entries() == 0, (
                    f"partial ingest from mutation {i % len(mutations)}")

    def test_valid_tbatch_through_dispatch(self):
        from m3_tpu_torch.aggregator.server import dispatch_entry

        S = 1_000_000_000
        t0 = 1_700_000_000 * S
        agg = self._agg()
        dispatch_entry(agg, {
            "t": "tbatch", "mtype": 1, "policy": "10s:2d", "agg_id": 0,
            "ids": [b"ok.1", b"ok.2"], "times": np.full(2, t0, np.int64),
            "values": np.array([1.0, 2.0])})
        assert agg.num_entries() == 2

    def test_mixed_buffer_ids_ingest_fully(self):
        """bytearray/memoryview metric IDs are valid wire buffers: a
        mixed-type id column must ingest EVERY row (normalized to bytes
        during validation), not crash on the first non-bytes id after a
        prefix was aggregated (the round-5 partial-ingest hazard)."""
        from m3_tpu_torch.aggregator.server import dispatch_entry

        S = 1_000_000_000
        t0 = 1_700_000_000 * S
        agg = self._agg()
        dispatch_entry(agg, {
            "t": "tbatch", "mtype": 1, "policy": "10s:2d", "agg_id": 0,
            "ids": [b"mix.a", bytearray(b"mix.b"), memoryview(b"mix.c")],
            "times": np.full(3, t0, np.int64),
            "values": np.array([1.0, 2.0, 3.0])})
        assert agg.num_entries() == 3
        # same id through different buffer types lands on ONE entry
        agg2 = self._agg()
        dispatch_entry(agg2, {
            "t": "tbatch", "mtype": 1, "policy": "10s:2d", "agg_id": 0,
            "ids": [b"mix.same", bytearray(b"mix.same")],
            "times": np.full(2, t0, np.int64),
            "values": np.array([1.0, 2.0])})
        assert agg2.num_entries() == 1

    def test_non_numeric_mid_array_rejected_whole(self):
        """List-typed columns with a bad element PAST the first position
        must reject with zero entries staged — the length check alone
        used to admit them and raise mid-loop."""
        import pytest as _pytest

        from m3_tpu_torch.aggregator.server import dispatch_entry

        S = 1_000_000_000
        t0 = 1_700_000_000 * S
        for col, bad in (("times", [t0, "x", t0]),
                         ("values", [0.5, None, 1.5]),
                         ("values", [0.5, [1.0], 1.5])):
            agg = self._agg()
            frame = {"t": "tbatch", "mtype": 1, "policy": "10s:2d",
                     "agg_id": 0,
                     "ids": [b"nn.1", b"nn.2", b"nn.3"],
                     "times": [t0, t0, t0], "values": [1.0, 2.0, 3.0]}
            frame[col] = bad
            with _pytest.raises(ValueError):
                dispatch_entry(agg, frame)
            assert agg.num_entries() == 0
