"""The control of the correctness check: the plain reference put in the
program's place, computed one precision below the configuration's (int4
for its int8: K=4 weights, activations and requants), must come out as
not correct.

    python3 benchmark/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

Runs the cell's set-up and a short window at the cell's load with the
K=4 reference as the pipeline (no warm-up: the reference has nothing to
warm), then the usual comparison with the K=8 reference; prints one
JSON line per seed with the checks, and exits non-zero if any seed's run
came out correct. The benchmark's own runs never run it.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402

# the nearest precision below the configuration's
LOWER_K = {8: 4}


def control_run(workload: str, seed: int, seconds: float, device="cuda",
                root: Path = run.spec.ROOT) -> dict:
    def swap(fn, config, params, max_a):
        return run.reference_fn(config, params, max_a,
                                LOWER_K[config["k"]], device)
    return run.run_cell(workload, seed, seconds, False, device, root,
                        wrap_fn=swap, no_warmup=True)["result"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    any_correct = False
    for seed in args.seeds:
        res = control_run(args.workload, seed, args.seconds)
        any_correct |= res["correct"]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": res["correct"],
                          "attempted": res["attempted"],
                          "checks": res["checks"]}), flush=True)
    return 1 if any_correct else 0


if __name__ == "__main__":
    sys.exit(main())
