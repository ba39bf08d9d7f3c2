"""Run a cell's control at the cell's own size: the plain reference at
half-width field products put in the program's place.  The comparison
that decides ``correct`` has to reject it on every seed.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --seconds 2

Prints one JSON line a seed with the compared numbers.  The benchmark's
own runs never run the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)            # the checkout, not portbench/
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        harness.log("no CUDA device")
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run(args.workload, seed, args.seconds, False,
                          time.perf_counter(), program="control")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": out["correct"], "check": out["check"],
                          "attempted": out["attempted"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
