"""A run with the timed path broken underneath comes out not correct, once
for each fault the cell can have; a sound run comes out correct. Tiny
frames on the CPU, the harness's look for a card skipped."""

import json
import time

import pytest
import torch

from portbench import harness, scenes

CASES = {"config4-render-1080p-d4": ("config4_mesh", 128, 72, 4),
         "config4-train-1080p-d4": ("config4_mesh", 64, 36, 3)}
FAULTS = [("config4-render-1080p-d4", ""),
          ("config4-render-1080p-d4", "stale_frame"),
          ("config4-render-1080p-d4", "half_frame"),
          ("config4-render-1080p-d4", "altered"),
          ("config4-train-1080p-d4", ""),
          ("config4-train-1080p-d4", "stale_state"),
          ("config4-train-1080p-d4", "half_batch")]


def run_cell(cell, faults=(), seed=2**31 + 11):
    name, w, h, depth = CASES[cell]
    cfg = scenes.resized(scenes.load_config(name), w, h, depth)
    # a window of one frame or step after set-up: the judged frame is the
    # window's first, whatever the host's speed
    run = harness.Run(cell, seed, 0.0, False, torch.device("cpu"), time.perf_counter(),
                      cfg=cfg, faults=faults)
    return harness.execute(run)


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_caught(cell, fault):
    result, checks = run_cell(cell, [fault] if fault else [])
    assert result["correct"] is (not fault), checks
    json.dumps(result)   # the result line is plain JSON
    e2e, _ = harness.metrics_of(harness.benchmark(), cell)
    assert list(result["metrics"]) == [m["name"] for m in e2e]
