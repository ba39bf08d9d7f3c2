"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the program ``stark_rings_tpu_torch``.  The last line of standard
output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``, and last
``check``, the compared numbers with their limits).  Exits non-zero,
with no result line, without a CUDA card, with fewer cards than the
cell asks for, without the program in the checkout, or when a JAX
module was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache the run could fill stays inside the checkout, at a
    # fixed path, so that the checkout's first run fills it for the rest
    cache = ROOT / "build" / "portbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    sys.path[0] = str(ROOT)            # the checkout, not portbench/

    import torch

    from portbench import harness

    cell = harness.cell(args.workload)
    if not torch.cuda.is_available():
        harness.log("no CUDA device: torch.cuda.is_available() is False")
        return 2
    if torch.cuda.device_count() < cell.chips:
        harness.log(f"cell {cell.name} needs {cell.chips} cards, found "
                    f"{torch.cuda.device_count()}")
        return 2
    try:
        import stark_rings_tpu_torch
    except ImportError as exc:
        harness.log(f"the program is not in this checkout: {exc}")
        return 2
    where = pathlib.Path(stark_rings_tpu_torch.__file__).resolve()
    if ROOT not in where.parents:
        harness.log(f"the program was imported from {where}, outside the "
                    f"checkout {ROOT}")
        return 2

    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), T_START)
    banned = harness.banned_modules()
    if banned:
        harness.log(f"modules that may not load were loaded: {banned}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
