"""Runs of the tiny cell on the CPU (the look for a card skipped): the last
line's keys, correct on a sound run, and correct false under each fault
the cell can have, planted under the timed path."""

import argparse
import json
import time

import pytest

from sfmb import bench


def run_tiny(checkout, faults=(), workload="tiny.rgb3"):
    args = argparse.Namespace(workload=workload, seed=2**31 + 5, seconds=0.5, trace=0, t0=time.perf_counter())
    return bench.run(args, "cpu", checkout, faults=faults)


@pytest.mark.parametrize("workload", ["tiny.rgb3", "tiny-mast3r.rgb3"])
def test_result_keys_and_sound_run(tiny_checkout, workload):
    code, res = run_tiny(tiny_checkout, workload=workload)
    assert code == 0
    assert list(res)[-1] == "checked" and {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in res["metrics"].values())
    assert res["attempted"] >= 3 and res["failed"] == 0
    assert res["correct"], res["checked"]
    json.dumps(res)


@pytest.mark.parametrize("fault", ["pcg_unchanged", "bini_pcg_unchanged", "attention_half_batch",
                                   "lightglue_half_pairs", "depth_altered", "match_altered", "pose_altered"])
def test_fault_makes_correct_false(tiny_checkout, fault):
    code, res = run_tiny(tiny_checkout, faults=(fault,))
    assert code == 0 and res["correct"] is False, res["checked"]
