"""Fixtures of the benchmark's own tests (run on the CPU: ``python3 -m
pytest esdfbench/tests``; the ``card`` tests skip without a CUDA card).

``small_root`` is a temporary copy of the benchmark (``BENCHMARK.json``
and ``esdfbench/``) with more cells at a size the CPU runs in
seconds: the program's plain PyTorch versions take the kernels' place
there, and the check is the same.
"""

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

#: the small cells: (cell, configuration it shrinks, traffic it shrinks,
#: fields changed besides the size, the cell whose end-to-end metrics it
#: reports)
SMALL = (("small_cow", "cow_and_lady", "orbit_clouds_30hz", {},
          "cow_global_stream"),
         ("small_demo", "demo_onboard", "orbit_depth_30hz", {},
          "demo_local_stream"),
         ("small_cow_read", "cow_and_lady", "orbit_clouds_read", {},
          "cow_global_read"),
         ("small_cow_eager", "cow_and_lady", "orbit_clouds_30hz",
          {"closest_mode": "eager"}, "cow_global_stream"))
H, W = 24, 32


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def make_small_root(dest: Path) -> Path:
    """A copy of the benchmark at ``dest`` with the small cells added as
    new files and entries, as a later change would add them."""
    shutil.copytree(REPO / "esdfbench", dest / "esdfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, config, traffic, changed, like in SMALL:
        c = json.loads((REPO / "esdfbench" / "configs"
                        / f"{config}.json").read_text())
        c.update(resolution=0.1, origin=[-2.0, -2.0, -0.6],
                 map_size=[4.0, 4.0, 1.6], max_ray_length=1.5,
                 trunc_dist=0.5, edt_fine_dist=0.5, radius=[1.0, 1.0, 0.5],
                 center_x=c["center_x"] * W / 640,
                 center_y=c["center_y"] * H / 480,
                 focal_x=c["focal_x"] * W / 640,
                 focal_y=c["focal_y"] * H / 480, **changed)
        (dest / "esdfbench" / "configs" / f"{name}.json").write_text(
            json.dumps(c))
        t = json.loads((REPO / "esdfbench" / "traffic"
                        / f"{traffic}.json").read_text())
        t.update(height=H, width=W, max_depth=6.0, sample_every=3,
                 min_occupied=10,
                 orbit={"radius": 0.8, "z": 0.2, "period_s": 0.4})
        t["boxes"].update(count=3, extent=[0.2, 0.5], keep_clear=0.3,
                          orbit_clearance=0.2)
        if t["boxes"]["focus"]:
            t["boxes"]["focus"] = [0.3, 1.6]
        if t.get("reads"):
            # long steps, so that some samples leave the map's box
            t["reads"].update(horizon=10, rollouts=64, dt=0.3,
                              refine_steps=2)
        (dest / "esdfbench" / "traffic" / f"small_{traffic}.json"
         ).write_text(json.dumps(t))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"esdfbench/configs/{name}.json",
                                 "reduced": [], "why": "test"})
        bench["workloads"].append({"name": name, "config": name,
                                   "traffic": f"small_{traffic}",
                                   "chips": 1, "why": "test"})
        for m in bench["end_to_end"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(name)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


@pytest.fixture(scope="session")
def small_root(tmp_path_factory) -> Path:
    return make_small_root(tmp_path_factory.mktemp("bench"))


def run_small(root: Path, cell_name: str, seed: int = 2 ** 31 + 7,
              seconds: float = 0.6) -> dict:
    """One run of a small cell on the CPU, through the harness."""
    import time

    import torch

    from esdfbench import harness, spec

    cell = spec.load_cell(cell_name, root)
    return harness.run(cell, seed, seconds, False, torch.device("cpu"),
                       time.perf_counter())
