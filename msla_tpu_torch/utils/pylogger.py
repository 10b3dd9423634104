"""Rank-aware console logger (the port's copy of msla_tpu/utils/pylogger.py;
reference: src/utils/pylogger.py:9-51).

The port runs one process, rank 0, until the parallel opt-ins (ROADMAP.md
queue item 7), so no rank is looked up: messages carry ``[rank: 0]`` as the
reference's do.
"""
from __future__ import annotations

import logging
from typing import Mapping, Optional

RANK = 0


class RankedLogger(logging.LoggerAdapter):
    """A multi-process-friendly command line logger: prefixes messages with
    the process rank and can restrict logging to rank zero or one rank."""

    def __init__(self, name: str = __name__, rank_zero_only: bool = False,
                 extra: Optional[Mapping[str, object]] = None) -> None:
        super().__init__(logger=logging.getLogger(name), extra=extra)
        self.rank_zero_only = rank_zero_only

    def log(self, level: int, msg: str, rank: Optional[int] = None, *args, **kwargs) -> None:
        if not self.isEnabledFor(level):
            return
        msg, kwargs = self.process(msg, kwargs)
        msg = f"[rank: {RANK}] {msg}"
        if self.rank_zero_only:
            if RANK == 0:
                self.logger.log(level, msg, *args, **kwargs)
        elif rank is None or RANK == rank:
            self.logger.log(level, msg, *args, **kwargs)
