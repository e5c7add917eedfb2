"""npz data utilities — add-meta / summarize
(python/add_kata_selfplay_meta_to_npzs.py,
summarize_old_selfplay_files.py); port of katago_tpu/cli/npz_tools_cmd.py.

  add-meta    stamp selfplay npz shards with metadataInputNC rows (the
              KataGo-selfplay SGFMetadata profile, or a named rank/pro
              profile) so they can join humanSL training mixes
  summarize   count rows/files per directory of npz shards without
              loading array data (zip header scan)

Host-only: no device is used.

Usage:
  python -m katago_torch.cli.npz_tools_cmd add-meta -dir D [-profile '']
  python -m katago_torch.cli.npz_tools_cmd summarize DIR [DIR...]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import zipfile

import numpy as np

from katago_torch.models.sgfmetadata import (SGFMetadata, fill_metadata_row,
                                             get_profile)


def npz_row_count(path: str) -> int:
    """Rows of the first array by reading the npy header only
    (summarize_old_selfplay_files.py get_numpy_npz_headers); -1 when
    the file cannot be read."""
    try:
        with zipfile.ZipFile(path) as z:
            for name in z.namelist():
                with z.open(name) as f:
                    version = np.lib.format.read_magic(f)
                    shape, _, _ = np.lib.format._read_array_header(f,
                                                                   version)
                    return int(shape[0])
    except Exception:
        return -1
    return 0


def cmd_summarize(args):
    out = []
    for d in args.paths:
        files = sorted(glob.glob(os.path.join(d, "**", "*.npz"),
                                 recursive=True))
        counts = [npz_row_count(f) for f in files]
        out.append({"dir": d, "files": len(files),
                    "rows": sum(n for n in counts if n >= 0),
                    "unreadable": sum(1 for n in counts if n < 0)})
    print(json.dumps(out))


def selfplay_metadata() -> SGFMetadata:
    """The KataGo-selfplay stamp: engine-vs-engine, byo-yomi-ish
    (SGFMetadata.get_katago_selfplay_metadata)."""
    return SGFMetadata(initialized=True, tc_is_byo_yomi=True,
                       main_time_seconds=600.0, period_time_seconds=15.0,
                       byo_yomi_periods=5)


def cmd_add_meta(args):
    meta = get_profile(args.profile) if args.profile else SGFMetadata()
    if not meta.initialized:
        meta = selfplay_metadata()
    files = sorted(glob.glob(os.path.join(args.dir, "**", "*.npz"),
                             recursive=True))
    area = args.board_area
    row_b = fill_metadata_row(meta, next_player_is_white=False,
                              board_area=area)
    row_w = fill_metadata_row(meta, next_player_is_white=True,
                              board_area=area)
    done = skipped = 0
    for path in files:
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        if "metadataInputNC" in arrays and not args.force:
            skipped += 1
            continue
        bi = arrays.get("binaryInputNCHWPacked",
                        arrays.get("binaryInputNCHW"))
        if bi is None:
            skipped += 1
            continue
        n = bi.shape[0]
        gi = arrays.get("globalInputNC")
        if gi is not None and gi.shape[1] > 5:
            # selfKomi (globalInputNC channel 5) flips sign with the
            # mover; komi is almost always white-positive in selfplay data
            is_white = gi[:, 5] >= 0
            rows = np.where(is_white[:, None], row_w[None, :],
                            row_b[None, :]).astype(np.float32)
        else:
            # no mover flag: the mover-agnostic average of both rows
            rows = np.broadcast_to(0.5 * (row_b + row_w),
                                   (n, row_b.shape[0])).astype(np.float32)
        arrays["metadataInputNC"] = rows
        tmp = path + ".tmp.npz"
        np.savez_compressed(tmp, **arrays)
        os.replace(tmp, path)
        done += 1
    print(json.dumps({"stamped": done, "skipped": skipped,
                      "profile": args.profile or "katago-selfplay"}))


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="command", required=True)
    p = sub.add_parser("summarize")
    p.add_argument("paths", nargs="+")
    p.set_defaults(fn=cmd_summarize)
    p = sub.add_parser("add-meta")
    p.add_argument("-dir", required=True)
    p.add_argument("-profile", default="")
    p.add_argument("-board-area", type=int, default=361)
    p.add_argument("-force", action="store_true")
    p.set_defaults(fn=cmd_add_meta)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
