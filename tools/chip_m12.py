"""Phases 17-22 of chip_smoke.py, on one NVIDIA GPU, with phases 6 and 7
before them to make their inputs.

    python3 tools/chip_m12.py [17 18 19 20 21 22]

Builds both kernels and both host libraries, plays chip_smoke's selfplay
phase (phase 6, at its own depth: phase 17 mines the positions of its
records) to write the shard and the sgfs, trains on it (phase 7: the
export, the .bin.gz and the checkpoint), then runs the SGF tools (17),
genposes and genboard (18), the book (19), contribute (20), data
parallelism with the fused actor-learner (21) and the fused step across
ranks with the JAX import and the host libraries (22), or the ones
named, with every check of those phases (18 and 22 run 17 first: they
read its records). The quick way to measure them without phases 8-16;
it prints no result line.
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

    which = set(argv if argv is not None else sys.argv[1:]) or None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    CS.log(f"card: {CS.smi_query('name,power.limit')}")
    kernels_s, host_s = CS.build_everything()
    CS.log(f"build: both kernels in {kernels_s:.1f} s, both host libraries "
           f"in {host_s:.1f} s")
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
        if which is not None and which & {"18", "22"}:
            which.add("17")     # 18 and 22 read phase 17's .sgf files
        CS.run_m12_phases(train, dev, work, which)
    return 0


if __name__ == "__main__":
    sys.exit(main())
