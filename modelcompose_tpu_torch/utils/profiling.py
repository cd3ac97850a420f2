"""Profiling and step-metrics utilities (counterpart of
modelcompose_tpu/utils/profiling.py, on ``torch.profiler``).

``trace`` writes a Chrome trace of the host and, where there is one, the
CUDA card; ``annotate`` names a region in it; ``StepTimer`` meters step
time and throughput; ``MetricsLogger`` appends jsonl scalars.  The JAX
module's ``enable_compile_cache`` has no counterpart: there is no XLA
compile cache here.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block into ``log_dir/trace.json`` (Chrome / Perfetto
    format); CUDA activity is recorded when a card is present."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named region that shows up in traces."""
    return torch.profiler.record_function(name)


def train_step_flops(cfg, batch_tokens: int) -> float:
    """Approximate train-step FLOPs: 6 * params_active * tokens (fwd+bwd),
    counting the dense backbone + the routed adapter branches."""
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    L = cfg.num_hidden_layers
    kv = cfg.num_key_value_heads * cfg.head_dim
    dense = L * (2 * H * H + 2 * H * kv + 3 * H * I) + V * H
    n_adapters = len(cfg.adapter_names())
    # attn adapters: q (2H) + k (H+kv) + v (H+kv) + o (2H) = 6H + 2kv
    lora = L * n_adapters * cfg.lora_r * (6 * H + 2 * kv + 3 * (H + I))
    return 6.0 * (dense + lora) * batch_tokens


class StepTimer:
    """Rolling step-time / throughput meter.

    >>> timer = StepTimer(cfg)
    >>> with timer.step(batch_tokens=8192): state, loss = train_step(...)
    >>> print(timer.summary())

    CUDA launches return before the card finishes, so a step on a card
    ends with ``torch.cuda.synchronize()``: the meter times steps, not
    launches.
    """

    def __init__(self, cfg=None, window: int = 50):
        self.cfg = cfg
        self.window = window
        self.times: list = []
        self.tokens: list = []

    @contextlib.contextmanager
    def step(self, batch_tokens: int = 0):
        t0 = time.perf_counter()
        yield
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        self.times.append(dt)
        self.tokens.append(batch_tokens)
        if len(self.times) > self.window:
            self.times.pop(0)
            self.tokens.pop(0)

    def summary(self) -> Dict[str, Any]:
        if not self.times:
            return {}
        dt = float(np.mean(self.times))
        tokens = float(np.mean(self.tokens))
        out = {"step_time_s": round(dt, 4),
               "steps_per_sec": round(1.0 / dt, 3),
               "tokens_per_sec": round(tokens / dt, 1) if tokens else None}
        if self.cfg is not None and tokens:
            out["tflops_per_sec"] = round(
                train_step_flops(self.cfg, int(tokens)) / dt / 1e12, 2)
        return out


class MetricsLogger:
    """Append-only JSONL metrics (the wandb-scalar role, offline)."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "a")

    def log(self, step: int, **metrics):
        rec = {"step": step, "time": time.time(), **metrics}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self):
        self._fh.close()
