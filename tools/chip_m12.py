"""Phases 17-21 of chip_smoke.py, on one NVIDIA GPU, with phases 6 and 7
before them to make their inputs.

    python3 tools/chip_m12.py [17 18 19 20 21]

Builds both kernels, plays chip_smoke's selfplay phase (phase 6, at its
own depth: phase 17 mines the positions of its records) to write the
shard and the sgfs, trains on it (phase 7: the export, the .bin.gz and
the checkpoint), then runs the SGF tools (17), genposes and genboard
(18), the book (19), contribute (20) and data parallelism with the fused
actor-learner (21), or the ones named, with every check of those phases.
The quick way to measure them without phases 8-16; it prints no result
line.
"""

import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("chip_m12: no CUDA device available", file=sys.stderr)
        return 2
    from katago_torch.cli import selfplay_cmd as SP
    from katago_torch.ops import _build

    which = set(argv if argv is not None else sys.argv[1:]) or None
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
        CS.run_selfplay_phase(model, gen, dev, work)
        del model
        torch.cuda.empty_cache()
        train = CS.run_train_phase(work, dev)
        torch.cuda.empty_cache()
        if which is not None and "18" in which:
            which.add("17")     # 18 trains on phase 17's .sgf files
        CS.run_m12_phases(train, dev, work, which)
    return 0


if __name__ == "__main__":
    sys.exit(main())
