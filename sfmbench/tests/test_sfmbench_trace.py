"""The traced run's reduction: busy time from overlapping device intervals,
idle gaps given to the innermost host span, and the per-layer readers on a
record made by hand."""

import importlib.util

import torch

from conftest import HERE
from sfmb import peaks
from sfmb.trace import DeviceRecord, merged

MS = 1_000_000  # ns


def reader(name):
    spec = importlib.util.spec_from_file_location(f"t_metrics_{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def record():
    # a 100 ms window: kernels over [10, 30) and [20, 40) ms overlap, one over [70, 80) ms
    events = [("attention_tc_kernel<64>", 10 * MS, 20 * MS), ("gemm", 20 * MS, 20 * MS),
              ("bini_diag_kernel", 70 * MS, 10 * MS)]
    spans = [("scene", 0, 100 * MS), ("pipe.extract_mono", 0, 50 * MS), ("reg.next_image", 40 * MS, 60 * MS)]
    return DeviceRecord(events, spans, 0, 100 * MS)


def test_busy_and_idle_by_span():
    assert merged([(3, 5), (1, 2), (4, 9)]) == [[1, 2], [3, 9]]
    r = record()
    assert abs(r.busy_s - 0.040) < 1e-12 and abs(r.window_s - 0.1) < 1e-12
    # gaps [0, 10) in the prior's phase, [40, 70) in reg.next_image (the innermost at 55 ms), [80, 100) in the scene
    idle = dict(r.idle_by_span)
    assert abs(idle["pipe.extract_mono"] - 0.010) < 1e-12
    assert abs(idle["reg.next_image"] - 0.030) < 1e-12
    assert abs(idle["scene"] - 0.020) < 1e-12
    b = r.breakdown()
    assert b["device_ops"][0][0] == "attention_tc_kernel<64>" and len(b["idle_gaps"]) == 3
    assert abs(reader("idle_share").read(type("R", (), {"device": r})) - 60.0) < 1e-9


class FakeRun:
    """What the readers see: a device record, the recorded calls, scenes."""

    def __init__(self):
        self.device, self.window_s = record(), 0.1
        mask = torch.ones((1, 4096), dtype=torch.bool)
        self.calls = {"k4": [{"shape": (1, 4096, 4096, 4, 64), "precision": "bfloat16", "itemsize": 2,
                              "mask": mask}]}
        self.scenes = [{"images": 3, "registered": 3, "wall_s": 12.0, "extract_s": 3.0}]

    def roofline(self, name):
        from sfmb.bench import Run

        class Spec:
            @staticmethod
            def module(kind, n):
                spec = importlib.util.spec_from_file_location(f"t_{kind}_{n}", HERE / kind / f"{n}.py")
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                return mod

        return Run(Spec, {"counted": ["k4"]}, self.scenes, self.calls, self.device, self.window_s).roofline(name)


def test_readers():
    run = FakeRun()
    least = max(4 * 4 * 64 * 4096 * 4096 / peaks.FLOPS["bfloat16"], 2 * 4 * 64 * 4 * 4096 / peaks.BYTES_PER_S)
    assert abs(reader("k4_roofline").read(run) - 100 * least / 0.020) < 1e-9
    assert reader("k3_roofline").read(run) is None  # no K3 call recorded: nothing to read, no 0
    assert reader("extract_s_per_frame").read(run) == 1.0
    assert reader("map_s_per_frame").read(run) == 3.0
