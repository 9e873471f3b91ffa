"""The frozen yardstick equals the port's today (``ops/kernel_checks``),
at the shapes of PERF.md's kernel table, and the trace's arithmetic."""
import pytest
import torch

from benchmark.harness import trace, work
from bilevel_gait_gen_tpu_torch.ops import kernel_checks as kc

GTWG = [(512, 1280, 256), (128, 1280, 256), (128, 1792, 256),
        (512, 640, 128), (4, 1280, 256), (1, 1280, 256), (256, 1280, 256),
        (128, 1792, 512)]
SWEEP = [(512, 1280, 256, 16), (128, 1280, 256, 16), (128, 1792, 256, 16),
         (512, 640, 128, 28), (4, 1280, 256, 56), (128, 1792, 512, 256)]
BMV = [((128, 30, 30), (128, 1, 30)), ((128, 44, 30), (128, 1, 30)),
       ((128, 18, 12), (128, 1, 12)), ((3, 3), (1664, 1, 3)),
       ((128, 13, 3, 3), (128, 13, 1, 3)), ((128, 640, 128), (128, 1, 128)),
       ((128, 1792, 512), (128, 1, 512))]


def test_peaks():
    assert work.PEAK_FP32_FLOPS == kc.PEAK_FP32_FLOPS
    assert work.PEAK_BYTES_PER_S == kc.PEAK_BYTES_PER_S


@pytest.mark.parametrize("B,m,n", GTWG)
def test_gtwg_work_and_bound(B, m, n):
    assert work.gtwg_work(B, m, n) == kc.gtwg_work(B, m, n)
    assert work.bound_ms(*work.gtwg_work(B, m, n)) == kc.bound_ms(
        *kc.gtwg_work(B, m, n))


@pytest.mark.parametrize("B,m,n,p", SWEEP)
@pytest.mark.parametrize("ns", [0, 2])
def test_sweep_work(B, m, n, p, ns):
    assert work.sweep_work(B, m, n, p, ns) == kc.sweep_work(B, m, n, p, ns)


@pytest.mark.parametrize("xs,ys", BMV)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bmv_work(xs, ys, dtype):
    X = torch.empty(xs, dtype=dtype, device="meta")
    Y = torch.empty(ys, dtype=dtype, device="meta")
    assert work.bmv_work(xs, ys, X.element_size()) == kc.bmv_work(X, Y)


def test_busy_union_and_gaps():
    spans = [(0, 10), (5, 12), (20, 30), (29, 31), (40, 41)]
    assert trace.busy_union(spans) == 12 + 11 + 1
    host = [(0, 100, "outer"), (11, 25, "inner"), (31, 45, "other")]
    gaps = dict(trace.idle_gaps(spans, host))
    assert gaps == {"inner": 8 / 1e6, "other": 9 / 1e6}
