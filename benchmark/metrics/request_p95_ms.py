"""95th percentile of the requests in the traced run's untraced window
(host_clock), send to ids on the host, in ms. Where it spreads too widely
from run to run to carry an end-to-end bound (PERF.md), it stands here as
``request_p95_ms.<mix>``, unbounded, beside the rate it moves."""


def read(t):
    return t.window_metrics.get("serve_p95_ms") if t.kind == "serve" else None
