"""The rwkv6 family's cost module against counts made by hand and the
program's own scan costs, and the readers of its four per-layer metrics on
synthetic traces and spans (each reads nothing where its kernels or spans
are missing, as in a run of a program that lacks them)."""
import json
import types
from pathlib import Path

import pytest

from perfbench import bench, spans
from perfbench.costs import peaks, rwkv6
from repro_torch.obs import Span

CONF = Path(__file__).resolve().parents[1] / "configs"
A = json.loads((CONF / "rwkv6-finch-7b-16l.json").read_text())["model"]
SPANS = ("rwkv.time_mix.share.train", "rwkv.lora.share.train")
ROOFS = ("rwkv6_scan_roofline.train", "rwkv6_scan_bwd_roofline.train")


def test_prefill_and_train_flops_by_hand():
    # per layer: r, k, v, g, out 5 x 4096^2; the mixes' LoRA 2 x 5 x 4096
    # x 64; the decay LoRA 2 x 4096 x 128; the channel mix 2 x 4096 x
    # 14336 + 4096^2; the head 4096 x 65536; the scan 5 x 64^2 + 5 x 64
    # a token and head, 64 heads
    layer = 5 * 4096 ** 2 + 2 * 5 * 4096 * 64 + 2 * 4096 * 128 \
        + 2 * 4096 * 14336 + 4096 ** 2
    assert layer == 221_773_824
    dense = 2 * (16 * layer + 4096 * 65536) * 4096
    scan = 16 * 4096 * 64 * (5 * 64 * 64 + 5 * 64)
    assert rwkv6.prefill_flops(A, 1, 4096) == dense + scan
    assert rwkv6.train_flops(A, 1, 4096) == 3 * (dense + scan)
    assert rwkv6.train_flops(A, 1, 4096) / 1e12 == pytest.approx(94.064,
                                                                 abs=1e-3)


def test_scan_costs_are_the_program_s():
    from repro_torch.kernels.rwkv6_scan import ops
    for shape in ((1, 4096, 64, 64, 4), (2, 333, 3, 16, 2)):
        assert rwkv6.scan_fwd_cost(*shape) == ops.rwkv6_scan_cost(*shape)
        assert rwkv6.scan_bwd_cost(*shape) == ops.rwkv6_scan_bwd_cost(*shape)
    # at the cell's shape both are bound by bytes at 3.35 TB/s (at 495
    # TFLOP/s their operations take 0.011 and 0.031 ms)
    for cost, ms in ((rwkv6.scan_fwd_cost, 0.10017), (rwkv6.scan_bwd_cost,
                                                     0.18030)):
        ops, nbytes = cost(1, 4096, 64, 64, 4)
        assert peaks.bound_s(ops, nbytes) == nbytes / 3.35e12
        assert peaks.bound_s(ops, nbytes) * 1e3 == pytest.approx(ms,
                                                                 abs=1e-5)


@pytest.mark.parametrize("name,base", [
    ("void (anonymous namespace)::wkv_out<float, 64>(float const*, int)",
     "wkv_out"),
    ("void (anonymous namespace)::wkv_bwd_state<64>(float const*, float*)",
     "wkv_bwd_state"),
    ("void wkv_out<float, 64>(float const*, float const*, int)", "wkv_out"),
    ("wkv_bwd_du(float const*, float*, int, int, int, int)", "wkv_bwd_du"),
    ("wkv_state", "wkv_state"),
    ("ampere_sgemm_128x64_nn", "ampere_sgemm_128x64_nn"),
])
def test_kernel_names_are_read_whole(name, base):
    assert rwkv6.kernel_name(name) == base


ANON = "void (anonymous namespace)::"
KERNELS = {
    ANON + "wkv_state<float, 64>(float const*, float const*)": (32, 0.0064),
    ANON + "wkv_out<float, 64>(float const*, float const*)": (32, 0.0096),
    ANON + "wkv_bwd_state<64>(float const*, float const*)": (16, 0.0032),
    ANON + "wkv_bwd<64>(float const*, float const*)": (16, 0.0256),
    ANON + "wkv_bwd_du(float const*, float*, int, int, int, int)": (16,
                                                                  0.0002),
    "ampere_sgemm_128x64_nn": (999, 1.0),
}


def ctx(kernels=KERNELS, busy_s=2.0):
    return types.SimpleNamespace(kernels=kernels, model=A, busy_s=busy_s,
                                 mix={"batch": 1, "seq": 4096})


def test_roofline_readers_on_a_synthetic_trace():
    fwd = bench.metric_reader("rwkv6_scan_roofline.train").read(ctx())
    bound = peaks.bound_s(*rwkv6.scan_fwd_cost(1, 4096, 64, 64, 4))
    assert fwd == pytest.approx(100.0 * 32 * bound / 0.016)
    bwd = bench.metric_reader("rwkv6_scan_bwd_roofline.train").read(ctx())
    bound = peaks.bound_s(*rwkv6.scan_bwd_cost(1, 4096, 64, 64, 4))
    assert bwd == pytest.approx(100.0 * 16 * bound / 0.029)
    # each kernel counts for its own pass only
    assert rwkv6.launches_and_seconds(KERNELS, rwkv6.FWD_KERNELS,
                                      rwkv6.FWD_COUNTED) == \
        (32, pytest.approx(0.016))


@pytest.mark.parametrize("metric", ROOFS)
def test_roofline_readers_read_nothing_without_their_kernels(metric):
    read = bench.metric_reader(metric).read
    assert read(ctx({"ampere_sgemm_128x64_nn": (9, 1.0)})) is None
    assert read(ctx({})) is None


def _span(name, t0, t1, **attrs):
    return Span(name=name, trace_id="t", span_id=f"{name}@{t0}",
                parent_id=None, proc="p", thread="m", t_start=t0, t_end=t1,
                attrs=attrs)


LAYER = [_span("rwkv.time_mix", 0.0, 0.1, tokens=4096, heads=64,
               device_s=0.3),
         _span("rwkv.lora", 0.0, 0.01, tokens=4096, heads=64, device_s=0.02),
         _span("rwkv.time_mix", 0.2, 0.3, tokens=4096, heads=64,
               device_s=0.1),
         _span("rwkv.lora", 0.2, 0.21, tokens=4096, heads=64,
               device_s=0.03),
         _span("optim.adamw", 0.4, 0.5, device_s=1.0)]


@pytest.mark.parametrize("metric,want", [
    ("rwkv.time_mix.share.train", 20.0), ("rwkv.lora.share.train", 2.5)])
def test_span_readers_on_synthetic_spans(monkeypatch, metric, want):
    read = bench.metric_reader(metric).read
    monkeypatch.setattr(spans, "window", lambda: LAYER)
    assert read(ctx()) == pytest.approx(want, rel=1e-12)
    host_only = [_span("rwkv.time_mix", 0, 1, tokens=1, heads=1),
                 _span("rwkv.lora", 0, 1, tokens=1, heads=1)]
    for listed in ([s for s in LAYER if s.name == "optim.adamw"], [],
                   host_only):
        monkeypatch.setattr(spans, "window", lambda: listed)
        assert read(ctx()) is None


def test_a_program_without_the_process_tracer_reads_nothing(monkeypatch):
    from repro_torch import obs
    monkeypatch.delattr(obs, "PROCESS_TRACER")
    for m in SPANS:
        assert bench.metric_reader(m).read(ctx()) is None
