"""The smoke test's yardsticks, on the CPU: the library call that a histogram
kernel is timed against computes the function on every repetition (a fresh
zeroed output, not sums piled up in one buffer), and a kernel's ``kernels``
line entry carries its main shape's stats with the largest error of all."""
import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch.kernels import histogram


@pytest.fixture
def timed_calls(monkeypatch):
    """Run each timed function three times instead of timing it; collect
    the results; no device time is taken."""
    calls = []

    def fake_cuda_ms(fn, reps=20, warmup=2):
        calls.append([fn() for _ in range(3)])
        return 0.0

    monkeypatch.setattr(chip_smoke, "cuda_ms", fake_cuda_ms)
    monkeypatch.setattr(chip_smoke, "_PENDING", [])
    return calls


@pytest.mark.parametrize("n_nodes,subset", [(1, False), (8, True)])
def test_library_yardstick_computes_the_histogram_each_call(timed_calls, n_nodes, subset):
    rng = np.random.default_rng(n_nodes)
    n, f, b = 300, 7, 16
    bins = torch.from_numpy(rng.integers(0, b, (n, f)).astype(np.int32))
    node = torch.from_numpy(rng.integers(-1, n_nodes, n).astype(np.int32))
    grad = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    hess = torch.from_numpy(rng.random(n).astype(np.float32))
    active = torch.tensor([6, 1, 3], dtype=torch.int32) if subset else None
    rows = n_nodes if active is None else active.shape[0]
    want = histogram.histogram_plain(bins, node, grad, hess, n_nodes, b, active)
    # The cells as the smoke test builds them, before the timer starts.
    row_of = torch.full((n_nodes,), -1, dtype=torch.int64)
    row_of[torch.arange(n_nodes) if active is None else active.long()] = torch.arange(rows)
    r = torch.where(node >= 0, row_of[node.long().clamp(min=0)], -1)
    keep = r >= 0
    cell = ((r[:, None] * f + torch.arange(f)) * b + bins.long())[keep]
    seg = torch.cat([cell.reshape(-1), (cell + rows * f * b).reshape(-1)])
    vals = torch.cat([grad[keep][:, None].expand(-1, f).reshape(-1),
                      hess[keep][:, None].expand(-1, f).reshape(-1)])
    into = chip_smoke.library_times(seg, vals, 2 * rows * f * b, {})
    assert {"library_ms", "library_device_ms", "library_accumulating_ms"} <= set(into)
    library, accumulating = timed_calls
    for out in library:  # every repetition: the whole function, zeros included
        torch.testing.assert_close(out.reshape(want.shape), want, rtol=1e-5, atol=1e-6)
    # The PR-14 figure: one buffer, so the sums pile up across repetitions.
    torch.testing.assert_close(accumulating[-1].reshape(want.shape),
                               len(accumulating) * want, rtol=1e-5, atol=1e-5)


def test_line_stats_take_the_main_shape_and_the_largest_error():
    shapes = {"level0": {"ms": 1.0, "device_ms": 0.5, "max_abs_err": 3e-4,
                         "device_kernels": {"k": 0.5}, "entries_hit": 7},
              "level8": {"ms": 2.0, "device_ms": 1.5, "max_abs_err": 1e-4,
                         "device_kernels": {"k": 1.5}, "entries_hit": 3}}
    line = chip_smoke.line_stats(shapes, "level8", drop=("entries_hit",))
    assert line == {"ms": 2.0, "device_ms": 1.5, "max_abs_err": 3e-4}
