"""Evaluation orchestration (port of cdae_tpu/solver/solver.py: the test
pass and its log line; training is the next slice)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from cdae_tpu_torch.data.dataset import Interactions
from cdae_tpu_torch.evaluation import Evaluation
from cdae_tpu_torch.utils.logging import get_logger
from cdae_tpu_torch.utils.timer import Timer

logger = get_logger()


def _fmt_metrics(res: Dict[str, float]) -> str:
    return " ".join(
        f"{k}={v:.5f}" for k, v in res.items() if k != "TestTime"
    ) + f" TestTime={res.get('TestTime', 0.0):.2f}s"


class Solver:
    """Drives a model through the protocol of models/base.py."""

    def __init__(self, model, verbose: bool = True):
        self.model = model
        self.verbose = verbose
        self.state = None

    def _log(self, msg: str) -> None:
        if self.verbose:
            logger.info(msg)

    def train(self, *args, **kwargs):
        raise NotImplementedError(
            "Solver.train is not ported to cdae_tpu_torch yet; it comes "
            "with the training slice (ROADMAP.md)"
        )

    def test(self, test_data: Interactions, eval_types: Sequence = (),
             train_data: Optional[Interactions] = None) -> Dict[str, float]:
        """One evaluation pass over ``test_data`` for every eval type."""
        t = Timer()
        out: Dict[str, float] = {}
        for ev in (Evaluation.create(k) for k in eval_types):
            res = ev.evaluate(self.model, self.state, test_data, train_data)
            self._log(f"{ev.kind.value}: {_fmt_metrics(res)}")
            out.update(res)
        out["time"] = t.elapsed()
        self._log(
            f"{t.elapsed():8.3f}|"
            + " ".join(f"{k}={v:.5f}" for k, v in out.items() if k != "time")
        )
        return out
