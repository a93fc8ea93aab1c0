"""The control on the card: the reference one precision lower in the
program's place fails the tiny cell's check (the published cells' control
readings are made by readings.py --control at their own size; PERF.md)."""

import argparse
import time

import pytest

from sfmb import bench


@pytest.mark.cuda
def test_control_fails_the_check(tiny_checkout, cuda):
    args = argparse.Namespace(workload="tiny.rgb3", seed=2**31 + 9, seconds=0.5, trace=0, t0=time.perf_counter())
    code, res = bench.run(args, "cuda", tiny_checkout, control=True)
    assert code == 0 and res["correct"] is False, res["checked"]
