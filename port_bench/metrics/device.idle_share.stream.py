"""`device.idle_share` in cells whose end-to-end metric is the per-section
latency tail (closed-loop streams): the same reading, which moves
`section_p95_ms` there."""

from port_bench.harness import spec

_BASE = spec.metric_reader('device.idle_share')
LAYER, UNIT, SOURCE = _BASE.LAYER, _BASE.UNIT, _BASE.SOURCE
MOVES = 'section_p95_ms'
read = _BASE.read
