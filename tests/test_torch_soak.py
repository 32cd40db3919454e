"""The port's soak drill (``soak_torch.py``) on the CPU at its small scale.

One run of the whole drill: an uninterrupted reference leg, a victim leg
SIGKILLed mid-flight, and a leg resumed from the victim's last checkpoint
+ archive pair.  The resumed map must equal the reference's bit for bit,
the run must scroll and restore (in the resumed part too), and the C20
oracle must pass at every check.  The reference leg's final map must also
equal, bit for bit, that of ``soak.py``'s reference leg (the JAX package)
on the same frames, seed and intervals.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
FRAMES = 120      # one orbit: the window scrolls out and back (restores)
INTERVALS = ["--check-every", "40", "--ck-every", "10"]
# one intra-op thread a leg: beside the suite's other workers, torch's
# default of a thread a core oversubscribes the CPU many times over
ENV = dict(os.environ, OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("soak")


@pytest.fixture(scope="module")
def drill(work):
    out = subprocess.run(
        [sys.executable, str(ROOT / "soak_torch.py"), "--platform", "cpu",
         "--frames", str(FRAMES), *INTERVALS, "--workdir", str(work)],
        capture_output=True, text=True, timeout=900, cwd=ROOT, env=ENV)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def jax_ref(work):
    """``soak.py``'s uninterrupted reference leg at the small scale."""
    jw = work / "jax"
    jw.mkdir()
    out = subprocess.run(
        [sys.executable, str(ROOT / "soak.py"), "--leg", "ref", "--platform",
         "cpu", "--scale", "small", "--frames", str(FRAMES), *INTERVALS,
         "--out", str(jw / "final_ref.npz"), "--ck", str(jw / "ck.npz"),
         "--archive", str(jw / "arch.npz")],
        capture_output=True, text=True, timeout=900, cwd=ROOT,
        env=dict(ENV, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    return jw / "final_ref.npz", json.loads(out.stdout.strip().splitlines()[-1])


def test_soak_resumed_map_bit_equal(drill):
    assert drill["bitexact_after_resume"], drill["mismatched_fields"]
    assert 0 < drill["resumed_from_frame"] < FRAMES
    assert drill["resumed"]["frames"] == FRAMES - drill["resumed_from_frame"]


def test_soak_scrolls_and_restores(drill):
    assert drill["scale"] == "small" and drill["platform"] == "cpu"
    assert drill["ref"]["scrolls"] >= 2 and drill["ref"]["restores"] >= 1
    assert drill["resumed"]["scrolls"] >= 1
    assert drill["resumed"]["restores"] >= 1


def test_soak_oracle_passes(drill):
    for leg in (drill["ref"], drill["resumed"]):
        assert leg["c20_checks"] >= 2
        assert leg["final_max_under"] == 0.0
        assert leg["final_known"] > 0


def test_soak_reference_leg_bit_equal_to_jax(drill, jax_ref, work):
    path, report = jax_ref
    with np.load(path) as a, np.load(work / "final_ref.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), f"{k} differs"
    for key in ("frames", "updates", "scrolls", "restores", "archive_tiles",
                "final_known", "final_rms", "final_max_under", "c20_checks"):
        assert drill["ref"][key] == report[key], key
