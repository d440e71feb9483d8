"""The port's profiling module against the JAX package's on the same
samples, and its torch.profiler trace on the CPU."""
import json
import os

import numpy as np
import pytest
import torch

from openpbso_tpu.runtime import profiling as jp
from openpbso_tpu_torch.runtime import profiling as tp


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: intra-op threads only slow them down, and
    under the suite's parallel workers they oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n,capacity", [(0, 16), (10, 16), (40, 16)])
def test_block_profiler_statistics_equal_the_jax_modules(n, capacity):
    """Empty, partly filled and wrapped rings of one-block dispatches."""
    samples = np.random.default_rng(0).gamma(2.0, 2e-3, n)
    a = jp.BlockProfiler(512, 44100, capacity=capacity)
    b = tp.BlockProfiler(512, 44100, capacity=capacity)
    for x in samples:
        a.record(x)
        b.record(x)
    sa, sb = a.stats(), b.stats()
    if n == 0:
        assert sa is None and sb is None
        return
    assert sb.count == n and sb.deadline_ms == pytest.approx(512e3 / 44100)
    for f in ("count", "mean_ms", "p50_ms", "p95_ms", "p99_ms", "max_ms",
              "deadline_ms", "deadline_miss_rate", "rtf"):
        assert getattr(sa, f) == getattr(sb, f), f
    assert sb.dispatches == min(n, capacity)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with tp.device_trace(logdir) as prof:
        x = torch.randn(64, 64)
        (x @ x).sum().item()
    path = os.path.join(logdir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in k.key for k in prof.key_averages())
