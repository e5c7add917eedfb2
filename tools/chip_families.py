"""Phases 11-13 of chip_smoke.py alone, on one NVIDIA GPU.

    python3 tools/chip_families.py [11 12 13]

Builds both kernels, then runs chip_smoke's humanSL serving phase (11),
transformer phase (12) and other-families phase (13), or the ones named,
with every check of those phases. The quick way to measure the net
families' paths without phases 1-10; it prints no result line.
"""

import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("chip_families: no CUDA device available", file=sys.stderr)
        return 2
    from katago_torch.ops import _build

    which = set(argv if argv is not None else sys.argv[1:]) or \
        {"11", "12", "13"}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    CS.log(f"card: {CS.smi_query('name,power.limit')}")
    CS.log(f"build: both kernels built in {_build.build_all():.1f} s")
    dev = torch.device("cuda")
    phases = [("11", CS.run_humansl_phase), ("12", CS.run_transformer_phase),
              ("13", CS.run_families_phase)]
    with tempfile.TemporaryDirectory() as tmp:
        for name, run in phases:
            if name in which:
                t0 = time.time()
                run(dev, Path(tmp))
                torch.cuda.empty_cache()
                CS.log(f"phase {name} in {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
