"""The trace arithmetic on hand-made profiler events: busy time, kernels by
the span their launch ran in, and the idle gaps by the span the host was in."""

import pytest
import torch

from slambench import manifest, trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Event:
    def __init__(self, name, device, start_us, dur_us, corr=0, annotation=False):
        self._v = (name, device, int(start_us * 1e3), int(dur_us * 1e3), corr, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def _events():
    return [
        Event("tracker/frontend", CPU, 0, 100), Event("tracker/track_core", CPU, 100, 100),
        Event("tracker/frontend", CPU, 300, 50), Event("tracker/process", CPU, 350, 400),
        Event("tracker/frontend", CUDA, 0, 100, annotation=True),
        Event("cudaLaunchKernel", CPU, 10, 1, corr=1), Event("cudaLaunchKernel", CPU, 150, 1, corr=2),
        Event("cudaLaunchKernel", CPU, 400, 1, corr=3), Event("cudaLaunchKernel", CPU, 310, 1, corr=4),
        Event("fast_nms_kernel(Params)", CUDA, 20, 10, corr=1), Event("gemm", CUDA, 160, 30, corr=2),
        Event("reduce", CUDA, 410, 40, corr=3), Event("Memcpy HtoD", CUDA, 180, 20, corr=9),
        Event("add", CUDA, 320, 5, corr=4),
    ]


def test_busy_kernels_and_breakdown():
    t = trace.TraceData(_events(), wall_s=1e-3)
    assert t.frames == 2
    assert t.busy_s == pytest.approx((10 + 40 + 5 + 40) / 1e6)   # gemm and the copy overlap: 160-200
    mask = t.kernels_launched_in(("tracker/frontend", "tracker/track_core"))
    assert [n for n, m in zip(t.op_names, mask) if m] == ["fast_nms_kernel(Params)", "gemm", "add"]
    b = t.breakdown()
    assert b["device_ops"][0][0] in ("reduce",) and len(b["device_ops"]) == 5
    gaps = dict(b["idle_gaps"])
    # 30-160 (mid 95: the host in the front-end), 200-320 (mid 260: in no span), 325-410 (mid 367.5: process)
    assert gaps["tracker/frontend"] == pytest.approx(130e-6)
    assert gaps["outside tracker spans"] == pytest.approx(120e-6)
    assert gaps["tracker/process"] == pytest.approx(85e-6)


def test_readers_on_the_trace():
    import types

    t = trace.TraceData(_events(), wall_s=1e-3)
    ctx = types.SimpleNamespace(trace=t, pyramid_pixels=2_888_194)
    kernels = manifest.load_reader("track.kernels_per_frame")(ctx)
    device_ms = manifest.load_reader("track.device_ms_per_frame")(ctx)
    idle = manifest.load_reader("device.idle_pct")(ctx)
    roof = manifest.load_reader("fast_nms_roofline")(ctx)
    assert kernels == 1.5 and device_ms == pytest.approx((10 + 30 + 5) / 1e3 / 2)
    assert idle == pytest.approx(100 * (1 - 95e-6 / 1e-3))
    assert roof == pytest.approx(100 * 8.879e-6 / 10e-6, rel=1e-3)
    assert manifest.load_reader("device.idle_pct")(types.SimpleNamespace(trace=None)) is None
