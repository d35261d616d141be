"""Structured sweep logging.

Replaces the runner's ad-hoc ``print`` progress with three levels:

* ``quiet``  -- nothing;
* ``info``   -- the default: the plan line, ONE line per fused dispatch
  (:func:`dispatch_line`, rendered from the dispatch's trace span), and a
  final campaign summary;
* ``debug``  -- additionally the per-member apportioned timings and cache
  diagnostics (the pre-structured-logger output, for scripts that watched
  individual grid cells).

A :class:`SweepLogger` writes to a ``sink`` callable (default ``print``),
so tests and embedding scripts can capture lines without touching stdout.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

_LEVELS = {"quiet": 0, "info": 1, "debug": 2}


class SweepLogger:
    def __init__(self, level: str = "info",
                 sink: Optional[Callable[[str], None]] = None):
        if level not in _LEVELS:
            raise ValueError(f"unknown log level {level!r}; "
                             f"expected one of {sorted(_LEVELS)}")
        self.level = level
        self._sink = sink if sink is not None else print

    def _emit(self, lvl: str, msg: str) -> None:
        if _LEVELS[self.level] >= _LEVELS[lvl]:
            self._sink(msg)

    def info(self, msg: str) -> None:
        self._emit("info", msg)

    def debug(self, msg: str) -> None:
        self._emit("debug", msg)

    @property
    def verbose(self) -> bool:
        return _LEVELS[self.level] >= _LEVELS["debug"]


def dispatch_line(span: Dict, total: int) -> str:
    """The default one-line-per-dispatch progress format, rendered from the
    dispatch's trace span (so log output and trace never disagree)."""
    trees = span.get("trees", [])
    ks = (f"k={trees[0]}" if len(trees) == 1
          else "k={" + ",".join(str(k) for k in trees) + "}")
    bits = [f"[{span['dispatch'] + 1}/{total}]",
            f"{span['engine']:>4s}",
            ",".join(span.get("schemes", [])),
            ks,
            f"x{span['n_points']}",
            f"fill={span.get('pkt_fill', 0.0):.2f}"]
    if "impl" in span:
        bits.append(f"impl={span['impl']}")
    if "slots_run" in span:
        bits.append(f"slots={span['slots_run']}")
    if "wall_s" in span:
        bits.append(f"{span['wall_s']:.2f}s")
    if "compile_s" in span:
        bits.append(f"(compile {span['compile_s']:.2f}s)")
    if span.get("cache") == "hit":
        bits.append("[cached]")
    return "  " + " ".join(bits)
