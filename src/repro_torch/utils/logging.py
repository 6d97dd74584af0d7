"""Minimal structured logger (no external deps, rank-0 aware): one JSON
record a line, emitted by rank 0 of the default process group only (every
process is rank 0 when no group is initialised)."""
from __future__ import annotations

import json
import sys
import time

import torch.distributed as dist


def process_rank() -> int:
    """This process's rank in the default group; 0 without one."""
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


class Logger:
    def __init__(self, name: str = "repro", stream=None):
        self.name = name
        self.stream = stream or sys.stderr
        self.t0 = time.time()

    def _emit(self, level: str, msg: str, **kv):
        if process_rank() != 0:
            return
        rec = {"t": round(time.time() - self.t0, 3), "lvl": level, "name": self.name, "msg": msg}
        rec.update(kv)
        print(json.dumps(rec, default=str), file=self.stream, flush=True)

    def info(self, msg, **kv):
        self._emit("info", msg, **kv)

    def warn(self, msg, **kv):
        self._emit("warn", msg, **kv)

    def metric(self, msg, **kv):
        self._emit("metric", msg, **kv)


def get_logger(name: str = "repro") -> Logger:
    return Logger(name)
