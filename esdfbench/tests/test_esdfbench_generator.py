"""The generator repeats exactly for a seed and differs across seeds."""

import json

import pytest
import torch

from esdfbench import generator, spec


@pytest.mark.parametrize("cell", ["small_cow", "small_demo"])
def test_same_seed_same_stream_other_seed_other_scene(small_root, cell):
    c = spec.load_cell(cell, small_root)
    dev = torch.device("cpu")
    seed = 2 ** 31 + 12345          # past 32 signed bits
    a = generator.make_stream(c.fields, c.traffic, seed, dev)
    b = generator.make_stream(c.fields, c.traffic, seed, dev)
    other = generator.make_stream(c.fields, c.traffic, seed + 1, dev)
    data = "points" if c.traffic["input"] == "cloud" else "depths"
    for name in (data, "transforms", "positions"):
        x, y = getattr(a, name), getattr(b, name)
        assert torch.equal(torch.nan_to_num(x, nan=-1.0),
                           torch.nan_to_num(y, nan=-1.0)), name
    assert (a.boxes == b.boxes).all()
    assert not (a.boxes == other.boxes).all()
    x, z = getattr(a, data), getattr(other, data)
    assert not torch.equal(torch.nan_to_num(x, nan=-1.0),
                           torch.nan_to_num(z, nan=-1.0))
    # every seed gives the same amount of work: same frames and shapes
    assert x.shape == z.shape and a.frames == other.frames


def test_negative_and_huge_seeds_draw_boxes(small_root):
    c = spec.load_cell("small_cow", small_root)
    for seed in (-5, 0, 2 ** 70 + 3):
        boxes = generator.make_boxes(c.fields, c.traffic, seed)
        assert boxes.shape == (5 + c.traffic["boxes"]["count"], 2, 3)


def test_orbit_is_closed_and_frames_split_into_ticks():
    t = json.loads((spec.BENCH_DIR / "traffic"
                    / "orbit_clouds_30hz.json").read_text())
    c = spec.load_json(spec.BENCH_DIR / "configs" / "cow_and_lady.json")
    rot, pos = generator.orbit(c, t)
    assert rot.shape[0] == 360 and rot.shape[0] % t["scans_per_tick"] == 0
    # the step from the last frame back to the first is an ordinary step
    step = pos[1] - pos[0]
    wrap = pos[0] - pos[-1]
    assert abs((step ** 2).sum() - (wrap ** 2).sum()) < 1e-9
