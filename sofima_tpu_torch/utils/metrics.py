"""Lightweight counters and timers for pipeline observability.

Twin of sofima_tpu/utils/metrics.py: an in-process, thread-safe registry
of counters and timers that can be exported and merged. The port keeps a
registry of its own, separate from the reference's. `trace` wraps a block
in a `torch.profiler.record_function` range (visible in torch.profiler
traces of the card) and times it on the host clock.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Iterator


class _Registry:
  """Thread-safe counter + timer store."""

  def __init__(self):
    self._lock = threading.Lock()
    self._counters: dict[tuple[str, str], int] = collections.defaultdict(int)
    self._timings: dict[tuple[str, str], float] = collections.defaultdict(
        float)

  def inc(self, namespace: str, name: str, value: int = 1) -> None:
    with self._lock:
      self._counters[(namespace, name)] += value

  def add_time(self, namespace: str, name: str, seconds: float) -> None:
    with self._lock:
      self._timings[(namespace, name)] += seconds

  def get_counter(self, namespace: str, name: str) -> int:
    with self._lock:
      return self._counters.get((namespace, name), 0)

  def get_time(self, namespace: str, name: str) -> float:
    with self._lock:
      return self._timings.get((namespace, name), 0.0)

  def snapshot(self) -> dict[str, dict[str, float]]:
    with self._lock:
      return {
          'counters': {f'{ns}/{n}': v
                       for (ns, n), v in self._counters.items()},
          'timings_s': {f'{ns}/{n}': round(v, 6)
                        for (ns, n), v in self._timings.items()},
      }

  def merge(self, other: dict) -> None:
    """Merges a snapshot() dict from another worker."""
    with self._lock:
      for key, v in other.get('counters', {}).items():
        ns, _, n = key.partition('/')
        self._counters[(ns, n)] += int(v)
      for key, v in other.get('timings_s', {}).items():
        ns, _, n = key.partition('/')
        self._timings[(ns, n)] += float(v)

  def reset(self) -> None:
    with self._lock:
      self._counters.clear()
      self._timings.clear()


_registry = _Registry()


def registry() -> _Registry:
  return _registry


class counter:  # noqa: N801 - the reference's call style
  """`counter(ns, name).inc()` compatible helper."""

  def __init__(self, namespace: str, name: str):
    self._ns = namespace
    self._name = name

  def inc(self, value: int = 1) -> None:
    _registry.inc(self._ns, self._name, value)


@contextlib.contextmanager
def timer_counter(namespace: str, name: str) -> Iterator[None]:
  """Times a block, accumulating into `<ns>/<name>` (+ a call counter)."""
  start = time.perf_counter()
  try:
    yield
  finally:
    _registry.add_time(namespace, name, time.perf_counter() - start)
    _registry.inc(namespace, name + '-calls')


@contextlib.contextmanager
def trace(name: str) -> Iterator[None]:
  """torch.profiler range + wall-clock timing."""
  import torch
  with torch.profiler.record_function(name), timer_counter('trace', name):
    yield
