"""What a driver hands back from its window: every request with its
timing."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional


def now() -> float:
    return time.perf_counter()


@dataclass
class Request:
    """One request: sent at ``due``, answered in hand at ``done`` (None
    if it never was), ``work`` units of work (the rows converted), its
    error if it failed."""

    name: str
    due: float
    done: Optional[float] = None
    work: int = 1
    error: Optional[str] = None


@dataclass
class Window:
    """A measured window: it opened at ``start``, took no new request
    after ``close``, and its rate is taken over [start, end] from the
    requests done by ``end``."""

    start: float
    close: float
    end: float = 0.0
    requests: List[Request] = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def counted(self) -> List[Request]:
        return [r for r in self.requests
                if r.done is not None and r.error is None
                and r.done <= self.end]
