"""The reduction of a chrome trace: busy time, idle share, per-frame
device time, the top operations and the idle gaps by host activity."""

from benchmark import tracing


def _x(name, cat, ts, dur):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur)


def test_reduce_by_hand():
    events = [
        _x("frame_tensor", "user_annotation", 100.0, 20.0),
        _x("aten::empty", "cpu_op", 105.0, 2.0),
        _x("k1", "kernel", 110.0, 50.0),
        _x("frame_tensor", "user_annotation", 125.0, 20.0),
        _x("wait", "user_annotation", 146.0, 80.0),
        _x("fill", "gpu_memset", 160.0, 10.0),
        _x("k1", "kernel", 200.0, 50.0),
    ]
    out = tracing.reduce(events, frames=2)
    assert out["window_s"] == (250.0 - 100.0) * 1e-6
    assert abs(out["busy_s"] - 110e-6) < 1e-12
    assert abs(out["device_ms_per_frame"] - 0.055) < 1e-12
    assert out["device_ops"][0][0] == "k1"
    assert abs(out["device_ops"][0][1] - 100e-6) < 1e-12
    gaps = dict(out["idle_gaps"])
    # 100-110 under frame_tensor (innermost at 105: frame_tensor >
    # aten::empty is over by 107, so the span itself), 170-200 in wait
    assert abs(sum(gaps.values()) - 40e-6) < 1e-12
    assert abs(gaps["wait"] - 30e-6) < 1e-12


def test_reduce_without_device_ops():
    out = tracing.reduce([_x("frame_tensor", "user_annotation", 0.0, 5.0)],
                         frames=1)
    assert out["busy_s"] == 0.0 and out["device_ms_per_frame"] is None
    assert tracing.reduce([], frames=1)["window_s"] == 0.0
