"""The traced window's reduction: busy time as a union of intervals, the
idle gaps and what names them, and the window where the profiler records
no annotation of it."""

from shapbench.trace import Trace


def _trace():
    tr = Trace(ops=[("k1", 10, 30), ("k2", 20, 40), ("k3", 60, 70), ("k4", 88, 95)],
               host=[("cudaStreamSynchronize", 42, 58), ("cudaLaunchKernel", 44, 46)],
               window=(0, 100))
    return tr


def test_busy_is_a_union_and_gaps_are_its_holes():
    tr = _trace()
    assert tr.busy_intervals() == [(10, 40), (60, 70), (88, 95)]
    assert tr.busy_s == 47 / 1e9
    assert tr.gaps() == [(0, 10), (40, 60), (70, 88), (95, 100)]
    assert tr.device_ms(["k1", "k2"]) == 40 / 1e6 and tr.count(["k"]) == 4


def test_gaps_are_named_by_the_innermost_host_call_or_the_next_operation():
    gaps = dict((g, name) for name, g in _trace().breakdown()["idle_gaps"])
    assert gaps[20 / 1e9] == "cudaStreamSynchronize"  # 50 lies in it, not in the launch
    assert gaps[18 / 1e9] == "host, before k4"
    assert gaps[10 / 1e9] == "host, before k1"
    assert gaps[5 / 1e9] == "host, before the window's end"


def test_the_window_falls_back_to_the_span_of_what_was_recorded():
    from shapbench import trace

    class Ev:
        def __init__(self, name, start, dur, dev, kind):
            self._v = (name, start, dur, dev, kind)

        def name(self):
            return self._v[0]

        def start_ns(self):
            return self._v[1]

        def duration_ns(self):
            return self._v[2]

        def device_type(self):
            return self._v[3]

        def activity_type(self):
            return self._v[4]

    tr = trace.read_events([Ev("cudaLaunchKernel", 5, 2, "DeviceType.CPU", "cuda_runtime"),
                            Ev("k", 10, 20, "DeviceType.CUDA", "kernel"),
                            Ev("cudaStreamSynchronize", 12, 25, "DeviceType.CPU",
                               "cuda_runtime")])
    assert tr.window == (5, 37) and tr.busy_s == 20 / 1e9
    tr = trace.read_events([Ev(trace.WINDOW, 0, 50, "DeviceType.CPU", "user_annotation"),
                            Ev("k", 10, 20, "DeviceType.CUDA", "kernel")])
    assert tr.window == (0, 50)
