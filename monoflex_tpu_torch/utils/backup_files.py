"""Snapshot the framework source + config into the run directory
(reference: utils/backup_files.py:57-70) so every experiment is reproducible
from its output folder alone.  A copy of ``monoflex_tpu/utils/backup_files.py``."""

from __future__ import annotations

import os
import shutil


def sync_root(root: str, output_dir: str, exts=(".py", ".yaml", ".yml")) -> int:
    """Copy all framework source files under ``root`` into
    ``output_dir/backup``, preserving relative paths. Returns file count."""
    backup_dir = os.path.join(output_dir, "backup")
    count = 0
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames
                       if d not in {"__pycache__", ".git", "output", ".jax_cache"}]
        for fn in filenames:
            if not fn.endswith(exts):
                continue
            src = os.path.join(dirpath, fn)
            rel = os.path.relpath(src, root)
            dst = os.path.join(backup_dir, rel)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copyfile(src, dst)
            count += 1
    return count
