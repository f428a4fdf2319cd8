"""Integrity-verified checkpoints: the port's counterpart of the JAX
package's ``utils/checkpoint.py``, with ``torch.save`` in place of Orbax.

Layout under the directory:

- ``<step>/``: one directory a loop step. Each entry of the state is a file
  ``<name>.pt`` (``torch.save``); an entry of one process's own (a rank's
  dropout generator) is ``<name>_p<i>.pt``. Files are read with
  ``torch.load(weights_only=True)``.
- ``manifest_<step>.json``: each file's size and sha256, written after the
  files land. ``latest_step`` / ``restore_latest`` check a step against
  it and fall back to the newest intact earlier step when it is corrupt
  or partial.
- ``stream_<step>_p<i>.json`` and ``eval_set_p<i>.npz``: the data stream's
  position and the held-out eval batches.

A step is written into ``<step>.partial/`` (:meth:`begin`, then
:meth:`write` from every process) and renamed into place by
:meth:`commit`, so a save cut short leaves no step behind. Every small
file is written atomically (tmp + fsync + ``os.replace``). ``keep_n``
retention runs after each commit and never deletes the step just saved:
a replay past a rollback re-saves steps below a stale newer one, and that
re-save is the run's recovery point.
"""

from __future__ import annotations

import contextlib
import glob
import hashlib
import json
import os
import re
import shutil
import time
from typing import Any, Callable

import numpy as np
import torch

_PROCESS_FILE = re.compile(r"^(.*)_p(\d+)\.pt$")


@contextlib.contextmanager
def _atomic_file(path: str):
    """A file handle whose bytes land at ``path`` by tmp + fsync +
    ``os.replace`` when the block ends without raising: a reader sees the
    old file or the new one, never a truncated one, even across a
    preemption mid-write."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        yield f
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _atomic_write_json(path: str, obj: Any) -> None:
    with _atomic_file(path) as f:
        f.write(json.dumps(obj).encode())


def _sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while block := f.read(chunk):
            h.update(block)
    return h.hexdigest()


class CheckpointManager:
    """Verified checkpoints, stream sidecars and ``keep_n`` retention in
    ``directory``. ``verify=False`` writes and checks no manifest.
    ``hash_s`` and ``bytes_written`` are the last commit's sha256 seconds
    and the bytes of its files. ``on_event(etype, **fields)`` (a
    :class:`~dtc_tpu_torch.resilience.events.RecoveryBus` post) receives
    one ``recovery`` record, action ``ckpt_fallback``, whenever a step is
    rejected, so a silent fallback still lands in the telemetry."""

    def __init__(self, directory: str, *, verify: bool = True, keep_n: int = 3,
                 on_event: Callable[..., None] | None = None):
        if keep_n < 1:
            raise ValueError(f"keep_n must be >= 1, got {keep_n}")
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self.verify = verify
        self.keep_n = keep_n
        self._on_event = on_event
        # Steps that failed verification are not hashed (or reported) again;
        # a re-save clears the entry. Passes are not cached: bit rot between
        # two reads must still be caught.
        self._rejected: set[int] = set()
        self.hash_s = 0.0
        self.bytes_written = 0

    # ---- paths -----------------------------------------------------------
    def step_dir(self, step: int) -> str:
        return os.path.join(self._dir, str(step))

    def _partial_dir(self, step: int) -> str:
        return os.path.join(self._dir, f"{step}.partial")

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self._dir, f"manifest_{step}.json")

    # ---- save ------------------------------------------------------------
    def begin(self, step: int) -> None:
        """Start writing ``step``: an empty ``<step>.partial/`` (one
        process calls it, before any :meth:`write`)."""
        shutil.rmtree(self._partial_dir(step), ignore_errors=True)
        os.makedirs(self._partial_dir(step))

    def write(self, step: int, state: dict, process_index: int | None = None) -> None:
        """Write each entry of ``state`` into the step being saved:
        ``<name>.pt``, or ``<name>_p<process_index>.pt`` for a process's own
        entries. Any process may call it between :meth:`begin` and
        :meth:`commit`."""
        for name, obj in state.items():
            fname = f"{name}.pt" if process_index is None else f"{name}_p{process_index}.pt"
            with _atomic_file(os.path.join(self._partial_dir(step), fname)) as f:
                torch.save(obj, f)

    def commit(self, step: int) -> None:
        """Put the step in place once every process's files have landed
        (one process calls it): a stale step of the same number and its
        manifest go first (a replay past a rollback re-saves steps), then
        the manifest hashes the final bytes and retention runs."""
        try:
            os.remove(self._manifest_path(step))
        except FileNotFoundError:
            pass
        shutil.rmtree(self.step_dir(step), ignore_errors=True)
        os.replace(self._partial_dir(step), self.step_dir(step))
        self._rejected.discard(step)
        names = os.listdir(self.step_dir(step))
        if not names:
            raise RuntimeError(f"checkpoint step {step}: no files under {self.step_dir(step)}")
        self.bytes_written = sum(os.path.getsize(os.path.join(self.step_dir(step), n))
                                 for n in names)
        if self.verify:
            t0 = time.perf_counter()
            self._write_manifest(step, names)
            self.hash_s = time.perf_counter() - t0
            self._prune_aux("manifest_*.json", keyfield=1, keep_step=step)
        self._gc(current=step)

    def save(self, step: int, state: dict, process_state: dict | None = None,
             process_index: int = 0) -> None:
        """One process's whole save: ``state`` as shared files,
        ``process_state`` as this process's own, then :meth:`commit`."""
        self.begin(step)
        self.write(step, state)
        if process_state:
            self.write(step, process_state, process_index)
        self.commit(step)

    def _write_manifest(self, step: int, names: list[str]) -> None:
        root = self.step_dir(step)
        files = {n: {"size": os.path.getsize(os.path.join(root, n)),
                     "sha256": _sha256_file(os.path.join(root, n))} for n in sorted(names)}
        _atomic_write_json(self._manifest_path(step), {"step": step, "files": files})

    def _gc(self, current: int) -> None:
        """Keep the newest ``keep_n`` steps; delete older ones and their
        manifests, never ``current`` (the step just saved: below a stale
        newer step after a rollback, it is the run's recovery point)."""
        steps = self.all_steps()
        for old in steps[:-self.keep_n]:
            if old == current:
                continue
            shutil.rmtree(self.step_dir(old), ignore_errors=True)
            self._rejected.discard(old)
            try:
                os.remove(self._manifest_path(old))
            except FileNotFoundError:
                pass

    # ---- verify ----------------------------------------------------------
    def verify_step(self, step: int) -> bool:
        """True when the step's files match its manifest. A step without a
        manifest (a ``verify=False`` writer) is trusted; its restore still
        falls back when a file does not load."""
        if step in self._rejected:
            return False
        root = self.step_dir(step)
        if not os.path.isdir(root):
            return False
        mpath = self._manifest_path(step)
        if not os.path.exists(mpath):
            return True
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError):
            return False
        for rel, meta in manifest.get("files", {}).items():
            p = os.path.join(root, rel)
            if (not os.path.exists(p) or os.path.getsize(p) != meta["size"]
                    or _sha256_file(p) != meta["sha256"]):
                return False
        return True

    def _reject(self, step: int, why: str, sticky: bool = True) -> None:
        """Report a rejected step. ``sticky`` remembers a manifest mismatch
        (permanent until re-saved); a load error is not remembered, since
        it may be transient."""
        if step in self._rejected:
            return
        if sticky:
            self._rejected.add(step)
        print(f"[dtc_tpu_torch] WARNING: checkpoint step {step} {why}; "
              "falling back to an earlier step")
        if self._on_event is not None:
            self._on_event("recovery", action="ckpt_fallback", rejected_step=step,
                           reason=why)

    def all_steps(self) -> list[int]:
        return sorted(int(n) for n in os.listdir(self._dir)
                      if n.isdigit() and os.path.isdir(os.path.join(self._dir, n)))

    def latest_step(self) -> int | None:
        """The newest intact step; None when none passes verification."""
        steps = self.all_steps()
        if not self.verify:
            return steps[-1] if steps else None
        for s in reversed(steps):
            if self.verify_step(s):
                return s
            self._reject(s, "failed integrity verification")
        return None

    # ---- restore ---------------------------------------------------------
    def restore(self, step: int, process_index: int = 0, map_location=None) -> dict:
        """The step's shared entries and process ``process_index``'s own,
        by name, loaded onto ``map_location``."""
        root = self.step_dir(step)
        out = {}
        for name in sorted(os.listdir(root)):
            m = _PROCESS_FILE.match(name)
            if m is not None and int(m.group(2)) != process_index:
                continue
            if not name.endswith(".pt"):
                continue
            key = m.group(1) if m is not None else name[:-3]
            out[key] = torch.load(os.path.join(root, name), map_location=map_location,
                                  weights_only=True)
        return out

    def restore_latest(self, process_index: int = 0, map_location=None) -> tuple[dict, int]:
        """:meth:`restore` of the newest step that passes verification and
        loads; ``FileNotFoundError`` when none does."""
        steps = self.all_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoint under {self._dir}")
        last_err: Exception | None = None
        for s in reversed(steps):
            if self.verify and not self.verify_step(s):
                self._reject(s, "failed integrity verification")
                continue
            try:
                return self.restore(s, process_index, map_location), s
            except Exception as e:  # corrupt beyond what the manifest saw
                last_err = e
                self._reject(s, f"failed to restore ({type(e).__name__})", sticky=False)
        raise FileNotFoundError(
            f"no intact checkpoint under {self._dir} (all {len(steps)} candidate "
            f"step(s) rejected; last error: "
            f"{type(last_err).__name__ if last_err else 'manifest mismatch'})"
        ) from last_err

    # ---- data-stream sidecars --------------------------------------------
    def save_stream(self, step: int, position: dict, process_index: int = 0) -> None:
        """The stream's resume point as of ``step`` (each process its own)."""
        _atomic_write_json(os.path.join(self._dir, f"stream_{step}_p{process_index}.json"),
                           position)
        self._prune_aux(f"stream_*_p{process_index}.json", keyfield=1, keep_step=step)

    def _prune_aux(self, pattern: str, keyfield: int, keep_step: int | None = None) -> None:
        """``keep_n`` retention of the manifests and sidecars; ``keep_step``
        (the step just saved) is kept, as :meth:`_gc` keeps it."""
        def key(p: str) -> int:
            return int(os.path.basename(p).split("_")[keyfield].split(".")[0])

        paths = sorted(glob.glob(os.path.join(self._dir, pattern)), key=key)
        for p in paths[:-self.keep_n]:
            if key(p) != keep_step:
                os.remove(p)

    def load_stream(self, step: int, process_index: int = 0) -> dict | None:
        """The sidecar of ``step``; None when it is missing or torn (the
        caller then drains the stream instead)."""
        path = os.path.join(self._dir, f"stream_{step}_p{process_index}.json")
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"[dtc_tpu_torch] WARNING: unreadable stream sidecar {path} ({e})")
            return None

    def save_eval_set(self, batches: list, process_index: int = 0) -> None:
        """The held-out eval batches (numpy), so a resume need not re-read
        the stream's head to rebuild them."""
        with _atomic_file(os.path.join(self._dir, f"eval_set_p{process_index}.npz")) as f:
            np.savez(f, *batches)

    def load_eval_set(self, process_index: int = 0) -> list | None:
        path = os.path.join(self._dir, f"eval_set_p{process_index}.npz")
        if not os.path.exists(path):
            return None
        try:
            with np.load(path) as z:
                return [z[k] for k in z.files]
        except (OSError, ValueError) as e:
            print(f"[dtc_tpu_torch] WARNING: unreadable eval-set sidecar {path} ({e})")
            return None
