"""The port's profiling utilities (``utils/profiling``, on
``torch.profiler``) against the JAX module's: the step meter's summary,
``train_step_flops`` equal to the JAX count, the jsonl metrics lines, and
a Chrome trace written on the CPU with a named region in it."""

import importlib
import json
import time

import pytest
import torch

from modelcompose_tpu.config import tiny_test_config

import modelcompose_tpu_torch.config as tconfig
from modelcompose_tpu_torch.utils import profiling

jprof = importlib.import_module("modelcompose_tpu.utils.profiling")


@pytest.mark.parametrize("kw", [
    dict(mm_vision_encoder="x", mm_hidden_size=8),
    dict(mm_vision_encoder="x", mm_hidden_size=8, mm_audio_encoder="y",
         mm_audio_hidden_size=8, lora_r=16, num_key_value_heads=2),
    dict(lora_strategy="none")])
def test_train_step_flops_matches_jax(kw):
    jcfg = tiny_test_config(**kw)
    tcfg = tconfig.ModelConfig.from_dict(jcfg.to_dict())
    for tokens in (1, 100, 8192):
        assert profiling.train_step_flops(tcfg, tokens) \
            == jprof.train_step_flops(jcfg, tokens)


def test_step_timer_summary_matches_jax():
    cfg = tconfig.ModelConfig.from_dict(tiny_test_config(
        mm_vision_encoder="x", mm_hidden_size=8).to_dict())
    timers = (profiling.StepTimer(cfg, window=3),
              jprof.StepTimer(cfg, window=3))
    for timer in timers:
        for tokens in (64, 128, 128, 256):  # the first leaves the window
            with timer.step(batch_tokens=tokens):
                time.sleep(0.005)
        # hold the meter to fixed times to compare the arithmetic
        timer.times = [0.25, 0.5, 0.25]
    got, want = (t.summary() for t in timers)
    assert got == want
    assert got["tokens_per_sec"] == round((128 + 128 + 256) / 3 / (1 / 3),
                                          1)
    assert set(got) == {"step_time_s", "steps_per_sec", "tokens_per_sec",
                        "tflops_per_sec"}
    assert profiling.StepTimer().summary() == {}


def test_step_timer_times_the_step():
    timer = profiling.StepTimer()
    with timer.step():
        time.sleep(0.01)
    s = timer.summary()
    assert s["step_time_s"] >= 0.01 and s["tokens_per_sec"] is None


def test_metrics_logger_lines(tmp_path):
    lines = []
    for name, mod in (("jax", jprof), ("port", profiling)):
        path = str(tmp_path / f"{name}.jsonl")
        logger = mod.MetricsLogger(path)
        logger.log(1, loss=0.5)
        logger.log(2, loss=0.4, lr=1e-4)
        logger.close()
        with open(path) as f:
            recs = [json.loads(line) for line in f]
        for r in recs:
            assert isinstance(r.pop("time"), float)
        lines.append(recs)
    assert lines[0] == lines[1] == [{"step": 1, "loss": 0.5},
                                    {"step": 2, "loss": 0.4, "lr": 1e-4}]


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(32, 32)
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.annotate("mc-region"):
            (x @ x).sum()
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "mc-region" for e in events)
    assert not hasattr(profiling, "enable_compile_cache")
