"""Phases 14-16 of chip_smoke.py, on one NVIDIA GPU, with a shortened
phase 6 and the whole phase 7 before them to make their inputs.

    python3 tools/chip_loop.py [14 15 16]

Builds both kernels, plays chip_smoke's selfplay phase for SELFPLAY_MOVES
moves (phase 6 plays SP_MOVES) to write the shard and the sgfs, trains
on it (phase 7: the export, the .bin.gz and the checkpoint), then runs
the match and gatekeeper phase (14), the training-loop phase (15) and
the tools phase (16), or the ones named, with every check of those
phases. The quick way to measure the loop and the tools without phases
8-13; it prints no result line.
"""

import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402

SELFPLAY_MOVES = 10


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("chip_loop: no CUDA device available", file=sys.stderr)
        return 2
    from katago_torch.cli import selfplay_cmd as SP
    from katago_torch.ops import _build

    which = set(argv if argv is not None else sys.argv[1:]) or \
        {"14", "15", "16"}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    CS.log(f"card: {CS.smi_query('name,power.limit')}")
    CS.log(f"build: both kernels built in {_build.build_all():.1f} s")
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        gen = torch.Generator(device=dev).manual_seed(CS.SEED)
        model = SP.make_model(CS.SIZE, CS.MODEL, torch.bfloat16, dev,
                              CS.SEED)
        CS.run_selfplay_phase(model, gen, dev, work, moves=SELFPLAY_MOVES)
        del model
        torch.cuda.empty_cache()
        train = CS.run_train_phase(work, dev)
        torch.cuda.empty_cache()
        phases = [("14", lambda: CS.run_match_phase(train, dev, work)),
                  ("15", lambda: CS.run_loop_phase(dev, work)),
                  ("16", lambda: CS.run_tools_phase(train, dev, work))]
        for name, run in phases:
            if name in which:
                t0 = time.time()
                run()
                torch.cuda.empty_cache()
                CS.log(f"phase {name} in {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
