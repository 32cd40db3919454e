"""fiesta_tpu_torch import and device guards.

The port imports neither JAX nor the JAX package, ``chip_smoke.py``,
``soak_torch.py`` and the benchmark twins (``bench*_torch.py``) do not
either, and the entry points (the app and the twins among them) run on
CUDA unless asked for the CPU.  The kernel layer builds only the
package's sources, and ``chip_smoke.py`` takes its peaks and bound rule
from the benchmark (``esdfbench/roofline.py``).
"""

import ast
import inspect
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import fiesta_tpu_torch as ft  # noqa: E402
from fiesta_tpu_torch import checkpoint, grid, kernels, run  # noqa: E402
from fiesta_tpu_torch.io import replay  # noqa: E402
from fiesta_tpu_torch.scrolling import ScrollingFiestaPipeline  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "fiesta_tpu")


def _top(name: str) -> str:
    return name.split(".")[0]


def test_package_import_leaves_jax_out():
    code = ("import sys, fiesta_tpu_torch, fiesta_tpu_torch.pipeline, "
            "fiesta_tpu_torch.io.replay, fiesta_tpu_torch.kernels, "
            "fiesta_tpu_torch.timing, fiesta_tpu_torch.ops.sort, "
            "fiesta_tpu_torch.ops.depth, fiesta_tpu_torch.ops.query, "
            "fiesta_tpu_torch.planning, fiesta_tpu_torch.planning.mpc, "
            "fiesta_tpu_torch.ops.esdf, fiesta_tpu_torch.ops.fusion, "
            "fiesta_tpu_torch.scrolling, fiesta_tpu_torch.archive, "
            "fiesta_tpu_torch.checkpoint, fiesta_tpu_torch.viz, "
            "fiesta_tpu_torch.run, fiesta_tpu_torch.debug, "
            "fiesta_tpu_torch.io.rosbag, fiesta_tpu_torch.io.lz4f, "
            "fiesta_tpu_torch.parallel, fiesta_tpu_torch.parallel.sharding, "
            "fiesta_tpu_torch.parallel.engine, fiesta_tpu_torch.native, "
            "fiesta_tpu_torch.planning.reference_planner, "
            "fiesta_tpu_torch.benchtools; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'fiesta_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


TWINS = ["bench_torch.py", "bench_demo_torch.py", "bench_mpc_torch.py",
         "bench_e2e_torch.py", "bench_accuracy_torch.py",
         "bench_reference_cpu_torch.py", "bench_scaling_torch.py"]


@pytest.mark.parametrize("path", ["chip_smoke.py", "soak_torch.py",
                                  "fiesta_tpu_torch"] + TWINS)
def test_sources_import_no_jax(path):
    files = ([ROOT / path] if path.endswith(".py")
             else sorted((ROOT / path).rglob("*.py")))
    assert files
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad = [n for n in names if _top(n) in FORBIDDEN]
            assert not bad, f"{f.name} imports {bad}"


def test_entry_points_default_to_cuda(tmp_path):
    cfg = ft.FiestaConfig(resolution=0.5, origin=(0.0, 0.0, 0.0),
                          map_size=(4.0, 4.0, 2.0))
    path = str(tmp_path / "map.npz")
    checkpoint.save(path, cfg, ft.make_state(cfg, device="cpu"))
    if torch.cuda.is_available():
        assert ft.make_state(cfg).d2.is_cuda
        assert ScrollingFiestaPipeline(cfg).state.d2.is_cuda
        assert checkpoint.load(path)[1].d2.is_cuda
        return
    for entry in (lambda: ft.make_state(cfg),
                  lambda: replay.stage_update_batches(cfg, []),
                  lambda: ScrollingFiestaPipeline(cfg),
                  lambda: checkpoint.load(path),
                  lambda: grid.coord_grids((2, 2, 2))):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()
    assert ft.make_state(cfg, device="cpu").d2.device.type == "cpu"
    assert ScrollingFiestaPipeline(cfg, device="cpu").state.d2.device.type \
        == "cpu"
    assert checkpoint.load(path, device="cpu")[1].d2.device.type == "cpu"


def test_sharded_entry_points_default_to_cuda():
    """The multi-device engine's meshes are cards unless given CPU
    devices: without a card, the default mesh, a CUDA virtual mesh, the
    sharded engine and ``distributed_mesh`` refuse (before any process
    group starts); given CPU devices they run there."""
    from fiesta_tpu_torch.parallel import engine, sharding

    cfg = ft.FiestaConfig(resolution=0.5, origin=(0.0, 0.0, 0.0),
                          map_size=(4.0, 4.0, 2.0))
    if torch.cuda.is_available():
        mesh = sharding.make_mesh(1)
        assert mesh.devices[0].type == "cuda"
        assert engine.ShardedFiestaPipeline(cfg, mesh=mesh).state.d2.is_cuda
        return
    with pytest.raises(ValueError, match="requested a 2-device mesh"):
        sharding.make_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        sharding.make_mesh(2, ["cuda"] * 2)
    with pytest.raises(ValueError, match="at least one shard"):
        engine.ShardedFiestaPipeline(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        sharding.distributed_mesh(init_method="file:///nonexistent",
                                  world_size=1, rank=0)
    import torch.distributed as dist

    assert not dist.is_initialized()
    mesh = sharding.make_mesh(2, ["cpu"] * 2)
    pipe = engine.ShardedFiestaPipeline(cfg, mesh=mesh)
    assert pipe.state.d2.device.type == "cpu"
    assert all(s.device.type == "cpu" for s in pipe.sharded_state.d2)


def test_app_refuses_to_run_on_the_cpu_unasked():
    """Without a card, ``python -m fiesta_tpu_torch.run`` stops unless
    given ``--platform cpu``; it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default run uses it")
    with pytest.raises(SystemExit, match="--platform cpu"):
        run.main(["--preset", "small", "--frames", "2"])


@pytest.mark.parametrize("twin", TWINS)
def test_benchmarks_refuse_to_run_on_the_cpu_unasked(twin, capsys):
    """Without a card, each benchmark twin stops unless given
    ``--platform cpu``, before it renders or stages anything, and prints
    no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default run uses it")
    import importlib

    mod = importlib.import_module(twin[:-3])
    with pytest.raises(SystemExit, match="--platform cpu"):
        mod.main([])
    assert capsys.readouterr().out == ""


def test_kernel_dir_holds_only_the_package_sources():
    """Every CUDA source beside the kernel wrappers is one the package
    builds (``kernels.SOURCES``)."""
    kdir = pathlib.Path(kernels.__file__).parent
    assert sorted(p.name for p in kdir.glob("*.cu")) == \
        sorted(kernels.SOURCES)


@pytest.mark.parametrize("name", ["_launch", "relax_sweeps",
                                  "_closest_split_wide",
                                  "closest_split_wide_residency"])
def test_kernel_wrappers_launch_only_the_package_build(name):
    """No wrapper takes another library than the package's own, and no
    build of a variant exists."""
    assert not hasattr(kernels, "build_variants")
    assert "lib" not in inspect.signature(getattr(kernels, name)).parameters


YARDSTICK = ["HBM_BYTES_PER_S", "F32_OPS_PER_S", "I32_OPS_PER_S",
             "ENVELOPE_OPS", "RELAX_OPS", "bound"]


@pytest.mark.parametrize("name", YARDSTICK)
def test_chip_smoke_takes_its_yardstick_from_the_benchmark(name):
    """``chip_smoke.py`` defines none of the card's peaks, work constants
    or the bound rule, and imports them from ``esdfbench.roofline``."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    defined = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            defined |= {n.id for t in targets for n in ast.walk(t)
                        if isinstance(n, ast.Name)}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            defined.add(node.name)
    assert name not in defined
    imported = {(n.module, a.name) for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom) for a in n.names}
    assert ("esdfbench.roofline", "bound_s") in imported
    if name != "bound":
        assert ("esdfbench.roofline", name) in imported
