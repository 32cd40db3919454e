"""The check comes out false for the control and for the timed path
broken underneath, and true for the program as it is."""

import dataclasses

import pytest
import torch

from conftest import run_small
from esdfbench import control, spec


def test_control_in_bfloat16_is_not_correct(small_root):
    for name in ("small_cow", "small_demo"):
        cell = spec.load_cell(name, small_root)
        checks, ok = control.readings(cell, 11, 20, torch.device("cpu"))
        assert not ok
        by = {c.name: c for c in checks}
        assert by["logodds"].value > 0


def _unchanged_once(real):
    calls = {"n": 0}

    def step(cfg, state, *a, **k):
        from fiesta_tpu_torch import copy_state

        calls["n"] += 1
        if calls["n"] == 7:       # one tick returns its state unchanged
            _, stats = real(cfg, copy_state(state), *a, **k)
            return state, stats
        return real(cfg, state, *a, **k)
    return step


def _half_batch(real):
    def step(cfg, state, points, valids, transforms, *a, **k):
        keep = transforms.shape[0] - transforms.shape[0] // 2
        if isinstance(points, (tuple, list)):
            points = tuple(p[:keep] for p in points)
        else:
            points = points[:keep]
        return real(cfg, state, points, valids[:keep], transforms[:keep],
                    *a, **k)
    return step


def _answer_altered(real):
    def step(cfg, state, *a, **k):
        state, stats = real(cfg, state, *a, **k)
        d2 = state.d2.clone()
        d2.view(-1)[d2.numel() // 2] += 1
        return dataclasses.replace(state, d2=d2), stats
    return step


@pytest.mark.parametrize("cell", ["small_cow", "small_demo",
                                  "small_cow_incr"])
@pytest.mark.parametrize("fault", [None, _unchanged_once, _half_batch,
                                   _answer_altered])
def test_faults_under_the_timed_path_fail_the_check(small_root, monkeypatch,
                                                    cell, fault):
    from fiesta_tpu_torch import pipeline

    if fault is not None:
        monkeypatch.setattr(pipeline, "fused_batch_step",
                            fault(pipeline.fused_batch_step))
    result = run_small(small_root, cell)
    assert result["correct"] is (fault is None), result["checks"]
