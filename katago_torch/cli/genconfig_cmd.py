"""genconfig command — generate a tuned GTP config; port of
katago_tpu/cli/genconfig_cmd.py (the written text is the JAX package's,
its header line included).

The reference's `katago genconfig` (cpp/command/benchmark.cpp:554+,
gtpconfig.cpp) interactively asks about rules/visits and runs a benchmark
sweep to pick numSearchThreads. Here the tunable is games-per-batch /
visit budget on the one accelerator; with -benchmark it runs the
benchmark sweep to pick a visit budget that keeps moves under the target
seconds-per-move, then writes a key=value config consumable by
`python -m katago_torch.cli.gtp -config ...`.

Usage: python -m katago_torch.cli.genconfig_cmd -output gtp.cfg
         [-rules tromp-taylor] [-komi 7.5] [-boardsize 19]
         [-target-s-per-move 5.0] [-benchmark] [-model M] [-config b6c96]
         [-device cpu]

With -benchmark it runs on CUDA unless `-device cpu` is given.
"""

from __future__ import annotations

import argparse


TEMPLATE = """\
# Configuration for katago_tpu GTP engine
# Generated by genconfig_cmd (reference: cpp/command/benchmark.cpp genconfig)

# Board rules
rules = {rules}
komi = {komi}

# Search limits
maxVisits = {max_visits}

# Search behavior
useLcbForSelection = true
lcbStdevs = 5.0
minVisitPropForLCB = 0.15
rootNoiseEnabled = false
cpuctExploration = 1.0
cpuctExplorationLog = 0.45
staticScoreUtilityFactor = 0.10
dynamicScoreUtilityFactor = 0.30

# Time management
lagBuffer = {lag_buffer}
"""


def generate(output: str, *, rules: str = "tromp-taylor", komi: float = 7.5,
             boardsize: int = 19, target_s_per_move: float = 5.0,
             run_benchmark: bool = False, model: str | None = None,
             config_name: str = "b6c96", lag_buffer: float = 1.0,
             device=None, log=print) -> dict:
    max_visits = 512
    if run_benchmark:
        from katago_torch.cli.benchmark_cmd import run_benchmark as bench
        out = bench(size=boardsize, visits=64, batch_sizes=[1],
                    config_name=config_name, model_path=model, iters=2,
                    device=device, log=log)
        pps = out["results"][0]["playouts_per_s"]
        from katago_torch.search.timecontrols import \
            visits_for_time_budget
        max_visits = visits_for_time_budget(target_s_per_move, pps,
                                            min_visits=16, max_visits=65536)
        log(f"measured {pps:.0f} playouts/s -> maxVisits {max_visits} "
            f"for ~{target_s_per_move:.1f}s/move")
    text = TEMPLATE.format(rules=rules, komi=komi, max_visits=max_visits,
                           lag_buffer=lag_buffer)
    with open(output, "w") as f:
        f.write(text)
    log(f"wrote {output}")
    return {"output": output, "max_visits": max_visits}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-output", required=True)
    ap.add_argument("-rules", default="tromp-taylor")
    ap.add_argument("-komi", type=float, default=7.5)
    ap.add_argument("-boardsize", type=int, default=19)
    ap.add_argument("-target-s-per-move", type=float, default=5.0)
    ap.add_argument("-benchmark", action="store_true")
    ap.add_argument("-model", default=None)
    ap.add_argument("-config", default="b6c96")
    ap.add_argument("-device", default=None,
                    help="torch device of -benchmark (default: cuda; "
                         "'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    generate(args.output, rules=args.rules, komi=args.komi,
             boardsize=args.boardsize,
             target_s_per_move=args.target_s_per_move,
             run_benchmark=args.benchmark, model=args.model,
             config_name=args.config, device=args.device)


if __name__ == "__main__":
    main()
