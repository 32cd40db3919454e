"""The result line, the import check, and where the parts are found."""

import ast
import json
import subprocess
import sys

import pytest

from conftest import REPO, run_small
from esdfbench import harness, run, spec


def test_last_line_keys_and_checks_last(small_root, capsys):
    result = run_small(small_root, "small_cow")
    run.emit(result)
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["metrics"]) == {"tick_ms", "tick_p95_ms", "setup_s"}
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert line["device"]["count"] == 1
    # each number compared, beside its limit, as the last lines of stderr
    err = out.err.strip().splitlines()
    assert err[-len(line["checks"]):] == [
        f"check {k} {v['value']} {'<=' if 'max' in v else '>='} "
        f"{v.get('max', v.get('min'))}" for k, v in line["checks"].items()]


def test_forbidden_modules_by_whole_top_level_names():
    mods = ["fiesta_tpu_torch", "fiesta_tpu_torch.ops.edt", "jaxtyping",
            "flaxen", "fiesta_tpu_extra", "jax", "jax.numpy", "jaxlib.xla",
            "flax.linen", "fiesta_tpu", "fiesta_tpu.ops.edt"]
    assert harness.forbidden_modules(mods) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla", "flax.linen", "fiesta_tpu",
         "fiesta_tpu.ops.edt"])


def test_a_run_loads_no_jax_and_the_reference_no_program(small_root):
    code = f"""
import sys, time, torch
sys.path.insert(0, {str(REPO)!r})
from esdfbench import harness, spec
cell = spec.load_cell("small_demo", {str(small_root)!r})
before = set(sys.modules)
ref = spec.reference(cell)
loaded = set(sys.modules) - before
assert not [m for m in loaded if m.split(".")[0] == "fiesta_tpu_torch"], \
    loaded
r = harness.run(cell, 5, 0.3, False, torch.device("cpu"), time.perf_counter())
assert r["correct"], r["checks"]
print(harness.forbidden_modules(sys.modules))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_no_jax_and_references_no_program():
    for path in (REPO / "esdfbench").rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax",
                                     "fiesta_tpu"}, path
    for path in (REPO / "esdfbench" / "references").glob("*.py"):
        assert _imports(path) <= {"__future__", "math", "numpy",
                                  "torch"}, path


def test_new_config_traffic_and_metric_are_found_as_new_files(small_root):
    """A later change adds a configuration, a traffic mix and a per-layer
    metric as files beside the others and a workloads entry: the harness
    finds them by name, and no file that was there changes."""
    root = small_root
    before = {p: p.read_bytes() for p in (root / "esdfbench").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "esdfbench/configs/small_cow.json").read_text())
    cfg["p_hit"] = 0.75
    (root / "esdfbench/configs/small_cow_hit75.json").write_text(
        json.dumps(cfg))
    t = json.loads((root / "esdfbench/traffic/small_orbit_clouds_30hz.json")
                   .read_text())
    t["orbit"]["z"] = 0.1
    (root / "esdfbench/traffic/small_low_orbit.json").write_text(
        json.dumps(t))
    (root / "esdfbench/metrics/ticks_traced.py").write_text(
        "def read(reading):\n    return float(reading.slice.ticks)\n")
    bench["configs"].append({"name": "small_cow_hit75", "source": "test",
                             "file": "esdfbench/configs/small_cow_hit75.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "small_new", "config":
                               "small_cow_hit75", "traffic":
                               "small_low_orbit", "chips": 1, "why": "t"})
    bench["per_layer"].append({"name": "ticks_traced", "unit": "ticks",
                               "better": "higher", "source":
                               "program_counter", "layer": "test",
                               "moves": "tick_ms",
                               "workloads": ["small_new"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("small_new", root)
    assert cell.fields["p_hit"] == 0.75 and cell.traffic["orbit"]["z"] == 0.1
    assert [m["name"] for m in cell.per_layer] == ["ticks_traced"]
    reader = spec.metric_reader(cell, "ticks_traced")
    assert reader(harness.Reading(cell, type("S", (), {"ticks": 120})(),
                                  [], set(), None)) == 120.0
    result = run_small(root, "small_new")
    assert result["correct"], result["checks"]
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_no_result_without_a_card_or_the_program(tmp_path):
    """Exits non-zero and prints nothing on stdout where there is no card
    (here) or, in a copy that holds only the benchmark, no program."""
    import shutil

    shutil.copytree(REPO / "esdfbench", tmp_path / "esdfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for cwd in (REPO, tmp_path):
        out = subprocess.run(
            [sys.executable, "-m", "esdfbench.run", "--workload",
             "cow_global_stream", "--seed", "1", "--seconds", "1",
             "--trace", "0"], capture_output=True, text=True, timeout=300,
            cwd=cwd)
        assert out.returncode != 0 and out.stdout == ""


@pytest.mark.card
def test_cow_cell_runs_correct_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "-m", "esdfbench.run", "--workload",
         "cow_global_stream", "--seed", "77", "--seconds", "2", "--trace",
         "0"], capture_output=True, text=True, timeout=1200, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
