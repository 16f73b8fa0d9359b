"""Traffic driver ``serve_closed``: the configuration's model serves
top-k lists for ``users_per_request`` users at a time, one caller in a
closed loop, the users in a seeded random order over all users
(cycling). Each request is timed from its send to its ids on the host.

Traffic parameters: ``users_per_request``, ``k``, ``warmup_requests``
(set-up), ``trace_seconds`` (the traced stretch) and ``check_users`` (how
many users' lists the check samples, drawn from the seed, with the
request whose users have the longest rated rows).
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import compare


class Driver:
    kind = "serve"

    def __init__(self, ctx):
        self.ctx = ctx  # runner.Context
        self.model = ctx.adapter

    def setup(self) -> None:
        c = self.ctx
        t = c.traffic
        self.B = int(t["users_per_request"])
        self.k = int(t["k"])
        rng = np.random.default_rng(c.seed)
        self.order = rng.permutation(c.num_users).astype(np.int32)
        self.served: List[np.ndarray] = []
        for j in range(int(t["warmup_requests"])):
            self._request(j)
        c.sync()

    def _users(self, j: int) -> np.ndarray:
        U = self.ctx.num_users
        return self.order[(j * self.B + np.arange(self.B)) % U]

    def _request(self, j: int) -> np.ndarray:
        with torch.profiler.record_function("bench.request"):
            return self.model.recommend(self.ctx, self._users(j), self.k)

    def window(self, seconds: float) -> Dict:
        lat = []
        j = 0
        t0 = time.perf_counter()
        while True:
            t_send = time.perf_counter()
            self.served.append(self._request(j))
            t_done = time.perf_counter()
            lat.append(t_done - t_send)
            j += 1
            if t_done - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        self.request_s = wall / j
        flops = sum(self.model.request_flops(self.ctx, self._users(i))
                    for i in range(j))
        return dict(wall=wall, units=j, failed=0, flops=flops, metrics={
            "serve_users_per_s": j * self.B / wall,
            "serve_p95_ms": 1e3 * float(np.percentile(lat, 95)),
        })

    def traced(self, seconds: float):
        self.traced_requests = max(1, math.ceil(seconds / self.request_s))
        return (lambda: [self._request(j)
                         for j in range(self.traced_requests)],
                self.traced_requests)

    def census_run(self) -> float:
        for j in range(self.traced_requests):
            self._request(j)
        return 1.0

    def check_sample(self) -> List[int]:
        """The requests checked: a sample drawn from the seed, with the
        request whose users have the longest rated rows."""
        c = self.ctx
        n = len(self.served)
        want = max(1, int(c.traffic["check_users"]) // self.B)
        rng = np.random.default_rng([c.seed, 0xC4EC])
        pick = set(rng.choice(n, size=min(want, n), replace=False).tolist())
        longest = max(range(min(n, -(-c.num_users // self.B))),
                      key=lambda j: int(c.lengths[self._users(j)].max()))
        pick.add(longest)
        return sorted(pick)

    def reference_lists(self, device, tf32: bool = False
                        ) -> Dict[int, np.ndarray]:
        """The reference's own top-k ids for the sampled requests (with
        ``tf32``, the control's answers)."""
        scores = self.model.reference_scores(self.ctx, device, tf32=tf32)
        return {j: torch.topk(scores(self._users(j)), self.k,
                              dim=1).indices.cpu().numpy()
                for j in self.check_sample()}

    def check(self, device, served=None) -> Dict[str, float]:
        """The widest gap of a served item below the reference's score at
        its rank, over the sampled requests. ``served``: the answers to
        judge by request (default: the window's)."""
        served = self.served if served is None else served
        scores = self.model.reference_scores(self.ctx, device)
        worst = 0.0
        for j in self.check_sample():
            gaps = compare.topk_gaps(scores(self._users(j)), served[j])
            worst = max(worst, float(gaps.max()))
        return {"topk_gap": worst}
