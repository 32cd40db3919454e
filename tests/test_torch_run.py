"""fiesta_tpu_torch's app (``python -m fiesta_tpu_torch.run``) against
fiesta_tpu's (CPU).

``fiesta_tpu.run.main`` and ``fiesta_tpu_torch.run.main`` run the same
command line on the ``small`` preset with ``--platform cpu``; their final
checkpoints must be bit-equal in every ``MapState`` field, the config and
the scrolling anchor, in each mode of ``MODES``: the default scanline run,
the DDA integrator, the incremental engine, a depth ``.npz`` replayed at
another resolution (the intrinsics rescale), a point-cloud ROS bag,
``--scrolling --persist`` (the saved archives' tiles equal too),
``--resume`` from a checkpoint the JAX app wrote, ``--sdf --viz-dir``
(the slice, signed slice and occupied cloud artifacts equal) and
``--ground-truth-check`` (the same report).  The JAX app runs as its own
tests run it.  The checks of ``tests/test_aux.py:135-194``,
``tests/test_mpc.py:218-224``, ``tests/test_scrolling.py:178-183``,
``tests/test_archive.py``'s ``--persist`` cases and
``tests/test_rosbag.py:248-318`` run on the port's app too.
"""

import contextlib
import dataclasses
import io
import json
import math
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from fiesta_tpu import run as jrun  # noqa: E402

from fiesta_tpu_torch import checkpoint, grid  # noqa: E402
from fiesta_tpu_torch import run as trun  # noqa: E402
from fiesta_tpu_torch.archive import TileArchive  # noqa: E402
from fiesta_tpu_torch.io import replay, rosbag  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BASE = ["--preset", "small", "--platform", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: at these shapes it is the fastest, and the
    suite runs several workers side by side (a thread a core each would
    oversubscribe the CPU many times over)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

#: mode -> command line; "{depth}", "{bag}", "{out}" and "{resume}" are
#: the depth npz, the cloud bag, the run's own directory and the JAX
#: default run's checkpoint
MODES = {
    "default": ["--frames", "6"],
    "dda": ["--frames", "6", "--method", "dda"],
    "incremental": ["--frames", "6", "--esdf-mode", "incremental"],
    "replay_depth_rescaled": ["--replay", "{depth}"],
    "bag_cloud": ["--bag", "{bag}"],
    "scrolling_persist": ["--frames", "6", "--scrolling", "--seed", "2",
                          "--persist", "{out}/arch.npz"],
    "resume_from_jax": ["--frames", "6", "--seed", "1",
                        "--resume", "{resume}"],
    "sdf_viz": ["--frames", "6", "--sdf", "--viz-dir", "{out}/viz"],
    "ground_truth": ["--frames", "6", "--ground-truth-check"],
}


def small_frames(kind, h, w, n_frames=6):
    """The small preset's scans at h x w (``tests/test_rosbag.py:230``)."""
    cfg, ph, pw = trun._preset_cfg("small")
    if (h, w) != (ph, pw):
        cfg = dataclasses.replace(
            replay.scale_intrinsics(cfg, h, w, base_height=ph,
                                    base_width=pw),
            max_points_per_scan=h * w)
    _, frames = replay.make_sequence(
        cfg, n_frames=n_frames, n_boxes=4, seed=5, height=h, width=w,
        kind=kind)
    return frames


def save_npz(path, frames, kind):
    np.savez_compressed(
        path, t=np.asarray([t for t, _, _ in frames]),
        pos=np.stack([p for _, (p, _), _ in frames]),
        quat=np.stack([q for _, (_, q), _ in frames]),
        **{"clouds" if kind == "cloud" else "depths":
           np.stack([s for _, _, s in frames])})


def app(mod, argv):
    """``mod.main(argv)``; returns its stderr."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert mod.main(argv) == 0
    return err.getvalue()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("inputs")
    depth = str(d / "depth.npz")
    save_npz(depth, small_frames("depth", 60, 80), "depth")
    bag = str(d / "cloud.bag")
    rosbag.frames_to_bag(bag, small_frames("cloud", 120, 160, 7),
                         kind="cloud", sensor_topic="/cam/points",
                         pose_topic="/vrpn")
    return dict(depth=depth, bag=bag)


@pytest.fixture(scope="module")
def jax_app(tmp_path_factory, inputs):
    """mode -> (run directory, stderr) of the JAX app, each run once."""
    runs = {}

    def get(mode):
        if mode not in runs:
            runs[mode] = run_mode(jrun, mode, tmp_path_factory.mktemp(
                f"jax_{mode}"), inputs, get)
        return runs[mode]
    return get


def run_mode(mod, mode, out, inputs, jax_app):
    fill = dict(inputs, out=str(out))
    if mode == "resume_from_jax":
        fill["resume"] = str(jax_app("default")[0] / "map.npz")
    argv = [a.format(**fill) for a in MODES[mode]]
    return out, app(mod, BASE + argv + ["--checkpoint", str(out / "map.npz")])


def same_npz(got, ref):
    with np.load(got) as a, np.load(ref) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k


def report(stderr):
    """The ``--ground-truth-check`` JSON report in an app's stderr."""
    m = re.search(r"^\{\n.*?^\}$", stderr, re.S | re.M)
    return json.loads(m.group(0))


@pytest.mark.parametrize("mode", list(MODES))
def test_app_matches_jax(tmp_path, inputs, jax_app, mode):
    ref_dir, ref_err = jax_app(mode)
    got_dir, got_err = run_mode(trun, mode, tmp_path, inputs, jax_app)
    same_npz(got_dir / "map.npz", ref_dir / "map.npz")
    _, state = checkpoint.load(str(got_dir / "map.npz"), device="cpu")
    assert int(grid.occupied_grid(trun._preset_cfg("small")[0],
                                  state.logodds).sum()) > 0
    if mode == "scrolling_persist":
        same_npz(got_dir / "arch.npz", ref_dir / "arch.npz")
        assert TileArchive.from_file(str(got_dir / "arch.npz")) \
            .seen_voxels() > 0
    if mode == "sdf_viz":
        for name in ("slice.npz", "sdf_slice.npz", "occ_pc.npz"):
            same_npz(got_dir / "viz" / name, ref_dir / "viz" / name)
    if mode == "ground_truth":
        rep = report(got_err)
        assert rep == report(ref_err)
        assert rep["num_known"] > 0 and rep["count_under"] == 0


@pytest.mark.parametrize("argv, match", [
    (BASE + ["--devices", "7"], "must divide by --devices 7"),
    (["--preset", "small", "--frames", "2"], "--platform cpu"),
], ids=["devices", "no_platform"])
def test_app_refuses(argv, match):
    if "--platform" not in argv and torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default run uses it")
    with pytest.raises(SystemExit, match=match):
        trun.main(argv)


# ---------------------------------------------------------------------------
# tests/test_aux.py:135-194, test_mpc.py:218-224, test_scrolling.py:178-183
# ---------------------------------------------------------------------------


def test_cli_runner(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "fiesta_tpu_torch.run", *BASE,
         "--frames", "6", "--checkpoint", str(tmp_path / "m.npz"),
         "--viz-dir", str(tmp_path / "viz")],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "processed 6 frames" in out.stderr
    assert (tmp_path / "m.npz").exists()
    assert (tmp_path / "viz" / "slice.npz").exists()


def test_cli_profile_and_periodic_checkpoint(tmp_path):
    ck, prof = str(tmp_path / "map.npz"), tmp_path / "trace"
    err = app(trun, BASE + ["--frames", "9", "--checkpoint", ck,
                            "--checkpoint-every", "1",
                            "--profile-dir", str(prof)])
    assert os.path.exists(ck)
    assert f"profiler trace in {prof}" in err
    with open(prof / "trace.json") as fh:
        assert json.load(fh)["traceEvents"], "empty profiler trace"


def test_cli_config_overrides(tmp_path):
    params = tmp_path / "params.json"
    params.write_text(json.dumps({"p_occ": 0.7, "max_ray_length": 2.0}))
    app(trun, BASE + ["--frames", "4", "--config", str(params),
                      "--set", "p_hit=0.8", "--set", "origin=-2,-2,-0.5",
                      "--set", "map_size=4,4,1", "--seed", "1"])
    with pytest.raises(SystemExit, match="unknown config field"):
        trun.main(BASE + ["--frames", "2", "--set", "nope=1"])
    with pytest.raises(SystemExit, match="expects 3 values"):
        trun.main(BASE + ["--frames", "2", "--set", "origin=-2,-2"])


def test_cli_mpc_and_fly_modes(tmp_path):
    """``--mpc`` and ``--fly`` close the loop on the mapped ESDF with a
    finite cost (the draws come from torch generators, so the solves are
    not compared with the JAX app's)."""
    err = app(trun, BASE + ["--frames", "9", "--mpc", "--fly",
                            "--fly-steps", "4", "--viz-dir",
                            str(tmp_path / "viz")])
    cost = float(re.search(r"MPC: \d+ rollouts, cost (\S+),", err).group(1))
    assert math.isfinite(cost)
    m = re.search(r"fly: (\d+) control steps, .* \(final err (\S+) m\)", err)
    assert 1 <= int(m.group(1)) <= 4 and math.isfinite(float(m.group(2)))
    with np.load(tmp_path / "viz" / "flight_path.npz") as fp:
        assert fp["path"].shape == (int(m.group(1)) + 1, 3)
        assert np.isfinite(fp["path"]).all()


def test_cli_scrolling_flag():
    err = app(trun, BASE + ["--frames", "6", "--scrolling", "--seed", "2"])
    assert "scrolling grid:" in err


# ---------------------------------------------------------------------------
# tests/test_archive.py's --persist cases
# ---------------------------------------------------------------------------


def test_cli_persist_flag(tmp_path):
    path = str(tmp_path / "arch.npz")
    argv = BASE + ["--frames", "6", "--scrolling", "--persist", path,
                   "--seed", "2"]
    app(trun, argv)
    assert (tmp_path / "arch.npz").exists()
    assert "loaded archive:" in app(trun, argv)   # reloads the directory
    assert TileArchive.from_file(path).seen_voxels() > 0


def test_cli_persist_appends_npz_suffix(tmp_path):
    argv = BASE + ["--frames", "6", "--scrolling", "--persist",
                   str(tmp_path / "world"), "--seed", "2"]
    app(trun, argv)
    assert (tmp_path / "world.npz").exists()
    assert "loaded archive:" in app(trun, argv)


def test_cli_resume_with_persist_restores_anchor(tmp_path):
    arch, ck = str(tmp_path / "arch.npz"), str(tmp_path / "map.npz")
    base = BASE + ["--frames", "6", "--scrolling", "--seed", "2"]
    app(trun, base + ["--persist", arch, "--checkpoint", ck])
    app(trun, base + ["--persist", arch, "--resume", ck])
    cfg, state = checkpoint.load(ck, device="cpu")
    checkpoint.save(ck, cfg, state)        # strip the anchor
    with pytest.raises(SystemExit, match="world anchor"):
        trun.main(base + ["--persist", arch, "--resume", ck])


def test_cli_persist_requires_scrolling():
    with pytest.raises(SystemExit, match="requires --scrolling"):
        trun.main(BASE + ["--frames", "2", "--persist"])


# ---------------------------------------------------------------------------
# tests/test_rosbag.py:248-318
# ---------------------------------------------------------------------------


def occupied_in(ck):
    cfg, state = checkpoint.load(ck, device="cpu")
    return int(grid.occupied_grid(cfg, state.logodds).sum())


def test_run_bag_cloud_end_to_end(tmp_path, inputs, capsys):
    ck = str(tmp_path / "map.npz")
    app(trun, BASE + ["--bag", inputs["bag"], "--checkpoint", ck])
    assert occupied_in(ck) > 0
    assert trun.main(["--bag", inputs["bag"], "--bag-info"]) == 0
    assert "/cam/points" in capsys.readouterr().out


def test_run_bag_depth_with_resolution_rescale(tmp_path):
    bag = str(tmp_path / "depth.bag")
    rosbag.frames_to_bag(bag, small_frames("depth", 60, 80, 9), kind="depth",
                         sensor_topic="/cam/depth", pose_topic="/pose")
    ck = str(tmp_path / "map16.npz")
    app(trun, BASE + ["--bag", bag, "--checkpoint", ck])
    assert occupied_in(ck) > 0


def test_bag_replay_equals_npz_replay(tmp_path):
    frames = small_frames("cloud", 120, 160, n_frames=7)
    npz, bag = str(tmp_path / "seq.npz"), str(tmp_path / "seq.bag")
    save_npz(npz, frames, "cloud")
    rosbag.frames_to_bag(bag, frames, kind="cloud")
    ck_a, ck_b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    app(trun, BASE + ["--replay", npz, "--update-every", "1",
                      "--checkpoint", ck_a])
    app(trun, BASE + ["--bag", bag, "--update-every", "1",
                      "--checkpoint", ck_b])
    same_npz(ck_a, ck_b)
