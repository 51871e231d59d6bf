"""Training loop with checkpoint/restart, simulated failures and
straggler counting (``repro/train/loop.py``).

  * checkpoint/restart -- asynchronous checkpoints every K steps; on
    (re)start the loop resumes from the newest COMMITTED step and
    regenerates the data stream from there (step N's batch is a pure
    function of N);
  * simulated failures -- ``failure_prob`` raises mid-run like a
    preempted worker; ``run_with_recovery`` restarts the loop, which
    recovers from the last checkpoint;
  * straggler counting -- a per-step wall-time EMA; steps slower than
    ``straggler_factor`` x EMA are counted.

On restart the parameters and moments come from the checkpoint, the
optimizer's step is the checkpoint's, and the error-feedback residuals
are the fresh state's (they are not checkpointed), as in the reference.
In a process group every rank runs the loop; ``LoopConfig.save`` is
False on all but rank 0 (``launch.train``), so one rank writes the
checkpoints and every rank resumes from them.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as CKPT
from repro_torch.configs.base import ModelConfig
from repro_torch.train import optimizer as OPT
from repro_torch.train import train_step as TS


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    log_every: int = 10
    failure_prob: float = 0.0            # simulated preemption probability
    failure_seed: int = 0
    straggler_factor: float = 3.0
    save: bool = True                    # False: resume, but write nothing
    lossy: CKPT.LossyPolicy = dataclasses.field(default_factory=CKPT.LossyPolicy)


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class LoopResult:
    losses: Dict[int, float]
    final_step: int
    straggler_steps: int
    restarts: int


def run(
    cfg: ModelConfig,
    state: TS.TrainState,
    step_fn: Callable,
    data_iter: Callable[[int], Dict[str, torch.Tensor]],
    loop: LoopConfig,
    losses_out: Optional[Dict[int, float]] = None,
) -> tuple[TS.TrainState, LoopResult]:
    """Run from the latest checkpoint (if any) to ``total_steps``.

    ``losses_out``: optional shared dict that survives SimulatedFailure
    (``run_with_recovery`` passes one to keep the full loss history)."""
    ckpt = CKPT.AsyncCheckpointer(loop.ckpt_dir, loop.lossy) \
        if loop.save else None
    start = CKPT.latest_step(loop.ckpt_dir)
    restarts = 0
    if start is not None:
        # one atomic tree per step: params + optimizer moments together
        tree = {"params": state.params, "mu": state.opt.mu,
                "nu": state.opt.nu}
        loaded = CKPT.load(loop.ckpt_dir, start, tree)
        state = TS.TrainState(
            params=loaded["params"],
            opt=OPT.OptState(step=torch.tensor(start, dtype=torch.int32),
                             mu=loaded["mu"], nu=loaded["nu"]),
            ef=state.ef,
        )
        restarts = 1
    begin = (start or 0)

    rng = np.random.default_rng(loop.failure_seed)
    losses: Dict[int, float] = losses_out if losses_out is not None else {}
    ema = None
    stragglers = 0
    try:
        for step in range(begin, loop.total_steps):
            if loop.failure_prob and rng.random() < loop.failure_prob \
                    and step > begin + 2:
                raise SimulatedFailure(f"worker preempted at step {step}")
            t0 = time.perf_counter()
            batch = data_iter(step)      # deterministic per-step stream
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            ema = dt if ema is None else 0.9 * ema + 0.1 * dt
            if dt > loop.straggler_factor * ema and step > begin + 3:
                stragglers += 1
            losses[step] = loss
            if ckpt is not None and ((step + 1) % loop.ckpt_every == 0
                                     or step + 1 == loop.total_steps):
                ckpt.submit(step + 1, {"params": state.params,
                                       "mu": state.opt.mu,
                                       "nu": state.opt.nu})
    finally:
        if ckpt is not None:
            ckpt.wait()
            ckpt.close()
    return state, LoopResult(losses, loop.total_steps, stragglers, restarts)


def run_with_recovery(cfg, make_state, step_fn, data_iter, loop: LoopConfig,
                      max_restarts: int = 5):
    """Driver: restart on simulated failures, resuming from checkpoints."""
    all_losses: Dict[int, float] = {}
    restarts = 0
    for attempt in range(max_restarts + 1):
        state = make_state()
        try:
            state, res = run(cfg, state, step_fn, data_iter, loop,
                             losses_out=all_losses)
            return state, LoopResult(all_losses, res.final_step,
                                     res.straggler_steps, restarts)
        except SimulatedFailure:
            restarts += 1
            continue
    raise RuntimeError("exceeded max_restarts")
