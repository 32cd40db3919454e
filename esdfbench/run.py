"""Run one cell of the benchmark once.

    python3 -m esdfbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  Prints the
numbers compared by the check (each beside its limit) as the last lines
of standard error, and one JSON object as the last line of standard
output: ``correct``, ``attempted`` (ticks dispatched in the window),
``failed`` (of those, ticks whose counts disagree with the reference),
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` last.  Exits non-zero without a result where no CUDA card (or
fewer than the cell asks for) is present, the program is missing, or a
module of JAX or the JAX package was loaded.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# caches that PyTorch or a compiler might fill go to fixed directories
# inside the checkout, so that a checkout's later runs find them
_CACHE = Path(__file__).resolve().parent.parent / ".bench_cache"
os.environ.setdefault("PYTORCH_KERNEL_CACHE_PATH", str(_CACHE / "torch"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(_CACHE / "extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(_CACHE / "triton"))

import torch  # noqa: E402

from esdfbench import harness, spec  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def emit(result: dict) -> None:
    """The check's lines last on stderr, the JSON line last on stdout,
    ``checks`` its last key."""
    lines = result.pop("_lines")
    checks = result.pop("checks")
    result["checks"] = checks
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import fiesta_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program under test is missing: {e}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         device, STARTED)
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
