"""Fault tolerance for training on one card (``repro.train.fault_tolerance``'s
port): ``ResilientLoop`` (restore on start, periodic async checkpoints,
bounded retry with backoff around a failed step, a health callback) and
``StragglerMitigator``.

Where the reference blocks on ``jax.block_until_ready`` the port
synchronises the device the loss lives on, so a step's wall time covers its
device work.  The state is restored in place (``checkpoint.restore``).
The final checkpoint of ``run`` is skipped when the last step was just
checkpointed (the reference writes the same step twice).  Checkpoints go
under the checkout's ``build/train_ckpt`` unless ``FTConfig.ckpt_dir`` says
otherwise (the reference's default is a fixed ``/tmp`` path, which two
checkouts would share).
``elastic_remesh`` needs a mesh and waits for the multi-card slice
(``ROADMAP.md`` A5).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch

from . import checkpoint as ckpt_mod
from ..core.retry import retry_call


DEFAULT_CKPT_DIR = str(Path(__file__).resolve().parents[3] / "build"
                       / "train_ckpt")


@dataclasses.dataclass
class FTConfig:
    ckpt_dir: str = DEFAULT_CKPT_DIR
    ckpt_every: int = 50
    keep_last: int = 3
    max_retries: int = 3
    backoff_s: float = 1.0
    straggler_ratio: float = 2.0
    straggler_window: int = 20


class StragglerMitigator:
    def __init__(self, cfg: FTConfig):
        self.cfg = cfg
        self.times: deque = deque(maxlen=cfg.straggler_window)

    def record(self, dt: float) -> bool:
        """Returns True when this step was a straggler."""
        straggler = False
        if len(self.times) >= 5:
            p50 = float(np.median(self.times))
            straggler = dt > self.cfg.straggler_ratio * p50
        self.times.append(dt)
        return straggler


def _sync(x) -> None:
    if torch.is_tensor(x) and x.is_cuda:
        torch.cuda.synchronize(x.device)


def _merge(state, restored):
    """``state`` with its restored values: tensors (and parameter modules)
    were filled in place, anything else is taken from ``restored``."""
    if isinstance(state, dict):
        return {k: _merge(v, restored[k]) for k, v in state.items()}
    if torch.is_tensor(state) or isinstance(state, (list, tuple,
                                                    torch.nn.Module)):
        return state
    return restored


class ResilientLoop:
    """Checkpointed, retrying train loop driver."""

    def __init__(self, step_fn: Callable, state: Any, ft: FTConfig,
                 health_cb: Optional[Callable[[str], None]] = None):
        self.step_fn = step_fn
        self.ft = ft
        self.health_cb = health_cb or (lambda msg: None)
        self.ckpt = ckpt_mod.AsyncCheckpointer(ft.ckpt_dir, ft.keep_last)
        self.straggler = StragglerMitigator(ft)

        # restore-on-start
        latest = ckpt_mod.latest_step(ft.ckpt_dir)
        if latest is not None:
            restored, extra = ckpt_mod.restore(ft.ckpt_dir, state)
            state = _merge(state, restored)
            self.start_step = int(extra.get("global_step", latest))
            self.health_cb(f"restored checkpoint at step {self.start_step}")
        else:
            self.start_step = 0
        self.state = state

    def run(self, batches: Callable[[int], Any], n_steps: int,
            metrics_cb: Optional[Callable] = None):
        step = self.start_step
        saved = None
        while step < n_steps:
            batch = batches(step)
            t0 = time.monotonic()

            def one_step(batch=batch):
                state, metrics = self.step_fn(self.state, batch)
                _sync(metrics["loss"])
                return state, metrics

            self.state, metrics = retry_call(
                one_step, max_retries=self.ft.max_retries,
                backoff_s=self.ft.backoff_s,
                on_retry=lambda attempt, e, _d, step=step: self.health_cb(
                    f"step {step} attempt {attempt} failed: {e!r}; "
                    f"backing off"),
                on_exhausted=lambda e: self.ckpt.wait())
            dt = time.monotonic() - t0
            if self.straggler.record(dt):
                self.health_cb(f"straggler step {step}: {dt:.3f}s")
            if metrics_cb:
                metrics_cb(step, metrics, dt)
            step += 1
            if step % self.ft.ckpt_every == 0:
                self.ckpt.save(self.state, step,
                               extra={"global_step": step})
                saved = step
        if saved != step:
            self.ckpt.save(self.state, step, extra={"global_step": step})
        self.ckpt.wait()
        return self.state
