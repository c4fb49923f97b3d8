"""95th percentile of every section's latency in the window, from its
hand-over to the entry to its synchronized return (interpolated between
order statistics, Python's inclusive quantiles)."""

import statistics

UNIT = 'ms'
BETTER = 'lower'
SOURCE = 'host_clock'


def p95(values) -> float:
  if len(values) < 2:
    return float(values[0])
  return statistics.quantiles(values, n=100, method='inclusive')[94]


def read(ctx):
  lat = ctx.window.latencies
  return 1e3 * p95(lat) if lat else None
