"""Resumable, no-repeat training-data file serving — the port's own copy
of katago_tpu/train/datagen.py (pure Python; the same random.Random draws,
so a seed serves the files in the same order).

Mirrors the reference's TrainingDataGenerator contract
(python/katago/utils/training_data_generator.py): the generator owns three
fields of a shared, checkpointable `train_state` dict and mutates them in
place so a checkpoint taken at any moment resumes exactly —

  - ``data_files_used``: files already consumed this epoch, in consumption
    order (the "previous epoch order" the gap-delaying reshuffle consumes).
  - ``rev_data_files_remaining``: the current serve queue in REVERSE order
    (O(1) pop from the end).
  - ``old_train_data_dirs``: bounded history of data dirs, used to prune
    stale used-file entries once a dir rotates out.

Two modes: ``no_repeat_files=True`` stops when data runs out (distributed-
training semantics: each shuffled file trains once, ever);
``no_repeat_files=False`` reshuffles for a new epoch, forbidding a file
from recurring within ~1/3 of the dataset of its previous occurrence
(the reservoir gap-delay of _reshuffle_for_new_epoch).
"""

from __future__ import annotations

import os
import random
from typing import Any, Optional


class DataFileServer:
    def __init__(self, train_state: dict[str, Any], no_repeat_files: bool,
                 rng: random.Random | None = None):
        self.train_state = train_state
        self.no_repeat_files = no_repeat_files
        self.rng = rng or random.Random()
        # legacy checkpoints stored used files as a set; order is
        # meaningless there, so give the reshuffle an arbitrary one
        if isinstance(train_state.get("data_files_used"), set):
            conv = list(train_state["data_files_used"])
            self.rng.shuffle(conv)
            train_state["data_files_used"] = conv
        train_state.setdefault("data_files_used", [])
        train_state.setdefault("rev_data_files_remaining", [])
        train_state.setdefault("old_train_data_dirs", [])
        self._all_files: list[str] = []

    # -- internals ----------------------------------------------------------

    def _uniform_interleave(self, a: list[str], b: list[str]) -> list[str]:
        """Merge preserving each list's internal order, items spread
        uniformly: pick from a with prob len(rem_a)/(rem_a+rem_b)."""
        out: list[str] = []
        i = j = 0
        while i < len(a) or j < len(b):
            rem_a, rem_b = len(a) - i, len(b) - j
            if self.rng.random() < rem_a / (rem_a + rem_b):
                out.append(a[i])
                i += 1
            else:
                out.append(b[j])
                j += 1
        return out

    def _reshuffle_for_new_epoch(self) -> list[str]:
        """New epoch order: a file may not recur within ~len/3 of its
        previous-epoch position. Reservoir: seed with the new files plus
        the first 2/3 of the previous order; pop uniform-random items,
        feeding in the remaining previous-order files one per pop."""
        present = set(self._all_files)
        prev = [f for f in self.train_state["data_files_used"]
                if f in present]
        prev_set = set(prev)
        new_files = [f for f in self._all_files if f not in prev_set]
        self.rng.shuffle(new_files)

        n = len(prev)
        k = (n * 2 + 1) // 3
        reservoir = new_files + prev[:k]
        order: list[str] = []
        while k < n:
            idx = self.rng.randrange(len(reservoir))
            reservoir[idx], reservoir[-1] = reservoir[-1], reservoir[idx]
            order.append(reservoir.pop())
            reservoir.append(prev[k])
            k += 1
        self.rng.shuffle(reservoir)
        order.extend(reservoir)
        return order

    def _maybe_refill(self) -> None:
        if self.train_state["rev_data_files_remaining"]:
            return
        if self.no_repeat_files:
            return
        order = self._reshuffle_for_new_epoch()
        order.reverse()
        self.train_state["rev_data_files_remaining"] = order
        self.train_state["data_files_used"] = []

    # -- public -------------------------------------------------------------

    def set_data_dir_if_has_remaining_files(self, data_dir: str) -> bool:
        """Point at a (new) shuffled-data directory; reconcile the queue
        with what it actually contains. Declines (returns False) if it
        cannot serve anything right now."""
        all_files = [os.path.join(data_dir, f)
                     for f in sorted(os.listdir(data_dir))
                     if f.endswith(".npz")]
        present = set(all_files)
        used = set(self.train_state["data_files_used"])
        fresh = [f for f in all_files if f not in used]

        rev = [f for f in self.train_state["rev_data_files_remaining"]
               if f in present]
        queued = set(rev)
        new_queue = [f for f in fresh if f not in queued]
        self.rng.shuffle(new_queue)
        rev = self._uniform_interleave(rev, new_queue)

        if not all_files or (self.no_repeat_files and not rev):
            return False

        self._all_files = all_files
        self.train_state["rev_data_files_remaining"] = rev

        dirs = self.train_state["old_train_data_dirs"]
        if data_dir not in dirs:
            dirs.append(data_dir)
        while len(dirs) > 20:
            old = dirs.pop(0)
            self.train_state["data_files_used"] = [
                f for f in self.train_state["data_files_used"]
                if not f.startswith(old)]
        return True

    def has_any_files(self) -> bool:
        return bool(self._all_files)

    def has_any_remaining_data(self) -> bool:
        if not self._all_files:
            return False
        if (self.no_repeat_files
                and not self.train_state["rev_data_files_remaining"]):
            return False
        return True

    def peek(self) -> Optional[str]:
        self._maybe_refill()
        rev = self.train_state["rev_data_files_remaining"]
        return rev[-1] if rev else None

    def pop(self) -> Optional[str]:
        self._maybe_refill()
        rev = self.train_state["rev_data_files_remaining"]
        if not rev:
            return None
        f = rev.pop()
        self.train_state["data_files_used"].append(f)
        return f
