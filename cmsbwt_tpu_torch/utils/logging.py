"""Structured logging — the port's copy of cmsbwt_tpu/utils/logging.py
(replaces the reference's cerr-to-file redirection, ref main.cpp:118-119)."""
from __future__ import annotations

import json
import logging
import sys
import time


def get_logger(name: str = "cmsbwt_tpu_torch", logfile: str | None = None,
               level=logging.INFO) -> logging.Logger:
    log = logging.getLogger(name)
    if not log.handlers:
        fmt = logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s")
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(fmt)
        log.addHandler(h)
        log.setLevel(level)
    if logfile:
        fh = logging.FileHandler(logfile)
        fh.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s: %(message)s"))
        log.addHandler(fh)
    return log


def log_event(log: logging.Logger, event: str, **fields) -> None:
    """One-line JSON event (progress = blocks processed, Mchars/s, ...)."""
    log.info("%s %s", event, json.dumps(fields, default=str))


class Progress:
    """Throughput progress reporting: chars processed per second."""

    def __init__(self, log: logging.Logger, total_chars: int,
                 every_s: float = 10.0):
        self.log = log
        self.total = total_chars
        self.every = every_s
        self.t0 = time.time()
        self.last = self.t0
        self.done = 0

    def update(self, chars: int) -> None:
        self.done += chars
        now = time.time()
        if now - self.last >= self.every:
            rate = self.done / 1e6 / max(now - self.t0, 1e-9)
            log_event(self.log, "progress", chars=self.done,
                      total=self.total, mchars_per_s=round(rate, 2))
            self.last = now
