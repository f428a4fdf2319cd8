"""Run logging.

The CSV schema is the JAX package's and its reference's ``log.csv``
(columns ``step, elapsed_time, loss``, cumulative ``elapsed_time``), so
``plot.py`` reads either. Rows are appended as they come: a crash keeps
every row written before it.
"""

from __future__ import annotations

import csv
import os
from typing import IO

FIELDS = ("step", "elapsed_time", "loss")


class CSVLogger:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._path = path
        self._fh: IO | None = open(path, "w", newline="")
        self._writer = csv.DictWriter(self._fh, fieldnames=FIELDS)
        self._writer.writeheader()

    def log(self, **row) -> None:
        """Write one row. Missing fields stay blank; unknown keys raise
        with the valid set."""
        if self._fh is None:
            raise ValueError(f"CSVLogger({self._path!r}) is closed")
        unknown = set(row) - set(FIELDS)
        if unknown:
            raise ValueError(
                f"CSVLogger({self._path!r}): unknown field(s) {sorted(unknown)}; "
                f"valid fields: {list(FIELDS)}"
            )
        self._writer.writerow({k: row.get(k, "") for k in FIELDS})

    def flush(self) -> None:
        if self._fh:
            self._fh.flush()

    def close(self) -> None:
        """Idempotent."""
        if self._fh:
            self._fh.close()
            self._fh = None
