"""``fiesta_tpu_torch.run --devices N`` against ``fiesta_tpu.run`` (CPU).

Both apps run the same command line on the ``small`` preset with
``--platform cpu``: the sharded engine on a virtual mesh of N CPU shards
(the JAX app's on conftest's virtual devices); their final checkpoints and
world archives must be bit-equal (``tests/test_sharding.py``'s two CLI
tests, on the port).
"""

import contextlib
import io

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from fiesta_tpu import run as jrun  # noqa: E402

from fiesta_tpu_torch import run as trun  # noqa: E402

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs conftest's 8-device CPU mesh")

BASE = ["--preset", "small", "--platform", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _app(mod, argv):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert mod.main(argv) == 0
    return err.getvalue()


def _same_npz(got, want):
    with np.load(got) as a, np.load(want) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes(), k


@pytest.mark.parametrize("devices, extra", [
    ("4", ["--mpc"]),
    ("8", ["--set", "map_size=6.4,6.0,2.0", "--ground-truth-check"]),
], ids=["4", "8"])
def test_cli_devices_flag_runs_sharded_engine(tmp_path, devices, extra):
    """``run.main --devices N --platform cpu``: the sharded engine on a
    virtual mesh, its checkpoint bit-equal to the JAX app's (the small
    grid's 60 planes take 4 shards; 64 of them take 8)."""
    argv = BASE + ["--devices", devices, "--frames", "6"] + extra
    outs = {}
    for name, mod in (("jax", jrun), ("torch", trun)):
        ck = str(tmp_path / f"{name}.npz")
        outs[name] = (ck, _app(mod, argv + ["--checkpoint", ck]))
    err = outs["torch"][1]
    assert f"sharded engine: {devices}-device" in err
    assert "processed 6 frames" in err
    _same_npz(outs["torch"][0], outs["jax"][0])
    if "--ground-truth-check" in extra:
        assert '"count_under": 0' in err
    with pytest.raises(SystemExit, match="incremental mode is single-device"):
        trun.main(BASE + ["--devices", "4", "--esdf-mode", "incremental"])


def test_cli_devices_scrolling_runs_sharded_unbounded_world(tmp_path):
    """``run.main --devices 4 --scrolling --persist``: the sharded
    unbounded world; checkpoint and archive bit-equal to the JAX app's."""
    outs = {}
    for name, mod in (("jax", jrun), ("torch", trun)):
        d = tmp_path / name
        d.mkdir()
        err = _app(mod, BASE + [
            "--devices", "4", "--frames", "12", "--scrolling", "--persist",
            str(d / "world.npz"), "--checkpoint", str(d / "map.npz")])
        outs[name] = (d, err)
    d, err = outs["torch"]
    assert "sharded scrolling engine: 4-device" in err
    assert "world archive:" in err
    for f in ("map.npz", "world.npz"):
        _same_npz(d / f, outs["jax"][0] / f)
