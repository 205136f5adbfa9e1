"""Process watchdog (host copy of m3_tpu/utils/panicmon.py; reference:
src/x/panicmon/executor.go — exec a child, report its exit status/signal
to handlers, restart on crash if asked)."""

from __future__ import annotations

import subprocess
import threading
import time
from typing import Callable, List, Optional, Sequence


class Panicmon:
    def __init__(self, argv: Sequence[str],
                 on_exit: Optional[Callable[[int], None]] = None,
                 restart_on_crash: bool = False,
                 max_restarts: int = 3,
                 backoff_s: float = 0.5):
        self.argv = list(argv)
        self.on_exit = on_exit
        self.restart_on_crash = restart_on_crash
        self.max_restarts = max_restarts
        self.backoff_s = backoff_s
        self.restarts = 0
        self.exit_codes: List[int] = []
        self._proc: Optional[subprocess.Popen] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Panicmon":
        self._proc = subprocess.Popen(self.argv)
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()
        return self

    def _watch(self):
        while not self._stop.is_set():
            rc = self._proc.wait()
            self.exit_codes.append(rc)
            if self.on_exit is not None:
                self.on_exit(rc)
            crashed = rc != 0
            if (self._stop.is_set() or not crashed
                    or not self.restart_on_crash
                    or self.restarts >= self.max_restarts):
                return
            self.restarts += 1
            # Interruptible backoff + re-check: stop() during the sleep
            # must not be answered with a fresh child it never sees.
            if self._stop.wait(self.backoff_s):
                return
            self._proc = subprocess.Popen(self.argv)

    def alive(self) -> bool:
        return self._proc is not None and self._proc.poll() is None

    def stop(self, grace_s: float = 5.0):
        self._stop.set()
        if self._proc is not None and self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=grace_s)
            except subprocess.TimeoutExpired:
                self._proc.kill()
        if self._thread is not None:
            self._thread.join(timeout=grace_s)
