"""Phases 9-10 of chip_smoke.py alone, on one NVIDIA GPU.

    python3 tools/chip_serving.py

Exports a seeded random b18c384nbt to a reference .bin.gz (as phase 7
exports its trained net), then runs chip_smoke's GTP phase, the
one-game kernel times and the analysis phase on it, with every check
of those phases. The quick way to measure the serving path (about two
minutes on an H100) without the selfplay and trainer phases that make
chip_smoke's export; it skips phase 9's DescNet-vs-KataGoModel check,
which needs phase 6's shard.
"""

import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_serving: no CUDA device available", file=sys.stderr)
        return 2
    from katago_torch.cli import train_cmd as TCMD
    from katago_torch.models import config as MC
    from katago_torch.ops import _build
    from katago_torch.train import checkpoint as CK

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    CS.log(f"card: {CS.smi_query('name,power.limit')}")
    CS.log(f"build: both kernels built in {_build.build_all():.1f} s")
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        model = TCMD.make_model(CS.SIZE, CS.MODEL, dev, CS.SEED)
        bin_gz = CK.export_bin_gz(
            str(work), f"{CS.MODEL}-random",
            {k: v.detach() for k, v in model.named_parameters()},
            MC.get_config(CS.MODEL))
        del model
        t0 = time.time()
        CS.run_gtp_phase(bin_gz, dev, work)
        CS.one_game_kernel_times(dev)
        CS.run_analysis_phase(bin_gz, dev)
        CS.log(f"phases 9-10 in {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
