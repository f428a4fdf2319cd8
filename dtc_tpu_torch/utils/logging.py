"""Run logging.

The CSV schemas are the JAX package's: ``log.csv`` (its reference's
columns ``step, elapsed_time, loss``, cumulative ``elapsed_time``), so
``plot.py`` reads either, and ``eval_log.csv`` (``step, loss``). Rows are
appended as they come: a crash keeps every row written before it. A
resumed run appends to the file it resumes.
"""

from __future__ import annotations

import csv
import os
from typing import IO

FIELDS = ("step", "elapsed_time", "loss")


class CSVLogger:
    """Rows of ``fields`` into ``path``: a new file with its header, or
    with ``append`` the rows after those already there."""

    def __init__(self, path: str, fields: tuple[str, ...] = FIELDS, append: bool = False):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._path = path
        self._fields = fields
        append = append and os.path.exists(path) and os.path.getsize(path) > 0
        self._fh: IO | None = open(path, "a" if append else "w", newline="")
        self._writer = csv.DictWriter(self._fh, fieldnames=fields)
        if not append:
            self._writer.writeheader()

    def log(self, **row) -> None:
        """Write one row. Missing fields stay blank; unknown keys raise
        with the valid set."""
        if self._fh is None:
            raise ValueError(f"CSVLogger({self._path!r}) is closed")
        unknown = set(row) - set(self._fields)
        if unknown:
            raise ValueError(
                f"CSVLogger({self._path!r}): unknown field(s) {sorted(unknown)}; "
                f"valid fields: {list(self._fields)}"
            )
        self._writer.writerow({k: row.get(k, "") for k in self._fields})

    def flush(self) -> None:
        if self._fh:
            self._fh.flush()

    def close(self) -> None:
        """Idempotent."""
        if self._fh:
            self._fh.close()
            self._fh = None
