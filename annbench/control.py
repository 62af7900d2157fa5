"""The control of the comparison that decides `correct`: the plain reference
put in the program's place and computed one precision lower (TF32 products
for a float32 configuration, int4 operands for an 8-bit one), judged by
`check.judge` exactly as a run's answers are. It has to come out not correct.

    python3 annbench/control.py --workload <cell> --seeds 1 2 3

For each seed it draws the cell's data on the card as a run does, answers every test
query once in the mix's requests with `reference.exact_knn(lower=True)`
(answers are deterministic, so one pass reads what more would), and prints
one JSON line with the compared numbers. The benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def control_answers(data, queries, k, metric, request_queries):
    """The control's answers to the test set, one request at a time."""
    from annbench import reference

    answers = []
    for lo in range(0, queries.shape[0], request_queries):
        d, i = reference.exact_knn(data, queries[lo : lo + request_queries], k, metric, lower=True)
        answers.append((lo, d.cpu().numpy(), i.cpu().numpy()))
    return answers


def run(reg, workload: str, seed: int) -> dict:
    from annbench import check, synth
    from annbench.registry import cell_params, form

    cell = reg.cell(workload)
    cfg, traffic = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    params = cell_params(cfg, traffic)
    k = params["args"]["K"]
    metric = form(cfg)[0]
    data, queries = synth.generate(cfg, seed, "cuda")
    answers = control_answers(data, queries, k, metric, traffic["request_queries"])
    correct, numbers, _ = check.judge(data, queries, answers, k, metric, params["limits"])
    return {"workload": workload, "seed": seed, "correct": correct,
            "check": {n: v for n, (v, _, _) in numbers.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from annbench.registry import Registry

    reg = Registry()
    for seed in args.seeds:
        print(json.dumps(run(reg, args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
