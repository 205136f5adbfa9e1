"""Carbon TCP ingestion server (reference: the coordinator's carbon listener,
src/cmd/services/m3coordinator + docker-integration-tests/carbon/test.sh
behavior): plaintext 'path value timestamp' lines over TCP, each mapped to
__gN__ path-component tags and written through the ingest dual path.

Port of m3_tpu/coordinator/carbon_ingest.py."""

from __future__ import annotations

import socketserver
import threading
from typing import Optional

from ..metrics import carbon
from .ingest import DownsamplerAndWriter

S = 1_000_000_000


class CarbonServer:
    def __init__(self, writer: DownsamplerAndWriter,
                 host: str = "127.0.0.1", port: int = 0):
        self._writer = writer
        self.lines_ingested = 0
        self.lines_malformed = 0
        outer = self

        class _Handler(socketserver.StreamRequestHandler):
            def handle(self):
                for line in self.rfile:
                    parsed = carbon.parse_line(line)
                    if parsed is None:
                        if line.strip():
                            outer.lines_malformed += 1
                        continue
                    path, value, ts = parsed
                    tags = carbon.path_to_tags(path)
                    outer._writer.write(tags, ts * S, value)
                    outer.lines_ingested += 1

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server((host, port), _Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def endpoint(self) -> str:
        h, p = self._server.server_address
        return f"{h}:{p}"

    def start(self) -> "CarbonServer":
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def close(self):
        self._server.shutdown()
        self._server.server_close()
