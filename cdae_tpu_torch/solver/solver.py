"""Training and evaluation orchestration (port of
cdae_tpu/solver/solver.py).

``Solver`` owns the outer loop: reset -> pre_train -> [iteration 0 eval] ->
loop {train_one_iteration, current_loss, eval every ``eval_iterations``},
logging a fixed-width table row per eval (Iters | Time | Train Loss |
<evaluator columns...>); every row also lands in ``history``.

``SGDSolver`` carries the learn-rate schedule: constant by default, or
the inverse-time decay lr0 / (1 + lr0*lambda*steps) with ``adaptive``; it
hands the current rate to models that have ``set_learn_rate``.

Differences from cdae_tpu: the model's state is updated in place; the
random draws of an iteration derive from the solver ``seed`` and
``state.step`` (models/cdae.py ``step_seed``), so a checkpoint needs no
stored random stream to resume exactly.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import torch

from cdae_tpu_torch.data.dataset import Interactions
from cdae_tpu_torch.evaluation import Evaluation
from cdae_tpu_torch.solver.optimizer import inverse_time_decay
from cdae_tpu_torch.utils.logging import get_logger
from cdae_tpu_torch.utils.timer import Timer

logger = get_logger()


def _params_finite(params) -> bool:
    """Every floating-point parameter is finite (one device readback)."""
    flags = [torch.isfinite(x).all() for x in params.values()
             if torch.is_floating_point(x)]
    return bool(torch.stack(flags).all()) if flags else True


def _fmt_metrics(res: Dict[str, float]) -> str:
    return " ".join(
        f"{k}={v:.5f}" for k, v in res.items() if k != "TestTime"
    ) + f" TestTime={res.get('TestTime', 0.0):.2f}s"


class Solver:
    """Drives a model through the protocol of models/base.py."""

    def __init__(
        self,
        model,
        max_iteration: int = 1,
        eval_iterations: int = 1,
        seed: int = 0,
        verbose: bool = True,
        trace_dir: Optional[str] = None,
        guard: bool = False,
        guard_max_restores: int = 1,
        loss_sample_size: int = 0,
    ):
        self.model = model
        self.max_iteration = int(max_iteration)
        self.eval_iterations = max(int(eval_iterations), 1)
        self.seed = int(seed)
        self.verbose = verbose
        self.trace_dir = trace_dir  # torch.profiler trace output
        # with ``guard`` on, every iteration checks the params finite; a
        # non-finite state restores the last checkpoint (params,
        # accumulators, step) and replays from there, at most
        # ``guard_max_restores`` times, so a deterministic divergence still
        # surfaces instead of looping
        self.guard = bool(guard)
        self.guard_max_restores = int(guard_max_restores)
        # forwarded to model.current_loss: 0 = the full dataset
        self.loss_sample_size = int(loss_sample_size)
        self.state = None
        self.history: List[Dict[str, float]] = []

    def pre_train(self, train_data: Interactions, validation_data) -> None:
        pass

    def train_one_iteration(self, train_data: Interactions) -> None:
        self.state = self.model.train_one_iteration(self.state, self.seed)

    def post_resume(self, start_iteration: int, train_data) -> None:
        """Hook: realign any solver-side schedule state after a resume."""

    def _log(self, msg: str) -> None:
        if self.verbose:
            logger.info(msg)

    def _eval_row(self, iteration, t, train_loss, evaluations,
                  validation_data, train_data) -> Dict[str, float]:
        row: Dict[str, float] = {
            "iter": float(iteration),
            "time": t.elapsed(),
            "train_loss": float(train_loss),
        }
        parts = [f"{iteration:5d}|{t.elapsed():8.3f}|{train_loss:10.5g}|"]
        if validation_data is not None and len(validation_data) > 0:
            for ev in evaluations:
                res = ev.evaluate(self.model, self.state, validation_data,
                                  train_data)
                row.update(res)
                parts.append(_fmt_metrics(res) + "|")
        self._log("".join(parts))
        self.history.append(row)
        return row

    def train(
        self,
        train_data: Interactions,
        validation_data: Optional[Interactions] = None,
        eval_types: Sequence = (),
        resume_from: Optional[str] = None,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 0,
    ):
        """The training loop. ``resume_from`` restores a checkpoint (params,
        accumulators, step; its fingerprint must match), after which the run
        equals an unbroken one bit for bit; ``checkpoint_path`` /
        ``checkpoint_every`` write checkpoints mid-run, and one at the end
        when a path is given. Returns the final state."""
        from cdae_tpu_torch.utils import checkpoint as ckpt
        from cdae_tpu_torch.utils.profiling import trace

        evaluations = [Evaluation.create(t) for t in eval_types]
        self.history = []

        self.state = self.model.reset(train_data, seed=self.seed)
        self.pre_train(train_data, validation_data)
        start_iteration = 0
        fingerprint = ckpt.config_fingerprint(self.model, self.state)
        if resume_from:
            ckpt.load_checkpoint(resume_from, self.state,
                                 expect_fingerprint=fingerprint)
            start_iteration = self.state.step
            self.post_resume(start_iteration, train_data)
            self._log(f"resumed {resume_from} at iteration {start_iteration}")

        def write_ckpt():
            if checkpoint_path:
                ckpt.save_checkpoint(
                    checkpoint_path, self.state,
                    extra={"model": type(self.model).__name__},
                    fingerprint=fingerprint,
                )

        t = Timer()
        self._log("-" * 110)
        header = f"{'Iters':>5}|{'Time':>8}|{'Train Loss':>10}|"
        if validation_data is not None and len(validation_data) > 0:
            header += "".join(" ".join(ev.columns) + "|" for ev in evaluations)
        self._log(header)

        train_loss = 0.0
        self._eval_row(start_iteration, t, train_loss, evaluations,
                       validation_data, train_data)

        iteration = start_iteration
        restores = 0
        with trace(self.trace_dir):
            while iteration < self.max_iteration:
                self.train_one_iteration(train_data)
                if self.guard and not _params_finite(self.state.params):
                    if (checkpoint_path and os.path.exists(checkpoint_path)
                            and restores < self.guard_max_restores):
                        restores += 1
                        ckpt.load_checkpoint(checkpoint_path, self.state,
                                             expect_fingerprint=fingerprint)
                        iteration = self.state.step
                        self.post_resume(iteration, train_data)
                        self._log(
                            f"non-finite params at iteration "
                            f"{iteration + 1}; restored {checkpoint_path} "
                            f"(restore {restores}/"
                            f"{self.guard_max_restores})"
                        )
                        continue
                    raise RuntimeError(
                        f"non-finite parameters detected at iteration "
                        f"{iteration + 1}"
                        + ("" if not checkpoint_path else
                           f" after {restores} restore(s)")
                    )
                train_loss = self.model.current_loss(self.state,
                                                     self.loss_sample_size)
                iteration += 1
                if iteration % self.eval_iterations == 0:
                    self._eval_row(iteration, t, train_loss, evaluations,
                                   validation_data, train_data)
                if checkpoint_every and iteration % checkpoint_every == 0:
                    write_ckpt()
        write_ckpt()
        self._log("-" * 110)
        return self.state

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


class SGDSolver(Solver):
    """The solver that owns the learn rate: ``learn_rate`` is pushed into
    the model before training, and with ``adaptive`` it decays as
    inverse_time_decay(lr0, lambda_, instances seen)."""

    def __init__(
        self,
        model,
        max_iteration: int = 1,
        eval_iterations: int = 1,
        learn_rate: Optional[float] = None,
        lambda_: float = 0.0,
        adaptive: bool = False,
        seed: int = 0,
        verbose: bool = True,
        trace_dir: Optional[str] = None,
        guard: bool = False,
        guard_max_restores: int = 1,
        loss_sample_size: int = 0,
    ):
        super().__init__(model, max_iteration, eval_iterations, seed, verbose,
                         trace_dir, guard, guard_max_restores,
                         loss_sample_size)
        self.learn_rate0 = learn_rate
        self.lambda_ = lambda_
        self.adaptive = adaptive
        self._steps = 0

    def pre_train(self, train_data, validation_data) -> None:
        if (self.learn_rate0 is not None
                and hasattr(self.model, "set_learn_rate")):
            self.model.set_learn_rate(self.learn_rate0)
        self._steps = 0

    def train_one_iteration(self, train_data) -> None:
        super().train_one_iteration(train_data)
        self._steps += len(train_data)
        self._apply_schedule()

    def post_resume(self, start_iteration: int, train_data) -> None:
        # the schedule depends only on the instances seen: replay it so a
        # resumed run sees the unbroken run's rate
        self._steps = start_iteration * len(train_data)
        self._apply_schedule()

    def _apply_schedule(self) -> None:
        if (self.adaptive and self.learn_rate0 is not None
                and hasattr(self.model, "set_learn_rate")):
            self.model.set_learn_rate(inverse_time_decay(
                self.learn_rate0, self.lambda_, self._steps))
