"""Build a costly test value once per pytest run, whatever xdist does.

Under ``pytest -n N`` every worker that receives an item of a module builds
that module's module-scoped fixtures again: under ``--dist load`` the items
of one file are dealt over all the workers, so a fixture that spawns a gloo
world of four ranks would spawn one world a worker, all at once.
:func:`once` keys the value on a directory that the run's workers share
(``<basetemp of the run>/torch_once``; the session's own basetemp without
xdist) and an exclusive ``fcntl.flock`` per name: the first caller builds
and pickles the value, every later caller, in any worker, loads it.  A
build that raises is cached as its text, and every later caller raises
that text without building again.  ``builds.log`` there records one line
per build (name, worker, seconds): one line per name in a run.
"""

from __future__ import annotations

import fcntl
import os
import pickle
import shutil
import time
import traceback
from pathlib import Path


def shared_dir(tmp_path_factory) -> Path:
    """The directory this run's workers share: ``torch_once`` beside the
    workers' own basetemps (``<run>/popen-gwK``), else in the session's."""
    base = Path(tmp_path_factory.getbasetemp())
    root = (base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base) / "torch_once"
    root.mkdir(parents=True, exist_ok=True)
    return root


def once(name: str, tmp_path_factory, build):
    """The value of ``build(workdir)``, built by the first caller of
    ``name`` in this run and loaded from its pickle by every other.
    ``workdir`` (``torch_once/<name>``, made empty) is seen by every worker
    and outlives the build, for files the value names.  ``name`` is unique
    in the run; a build calls no other ``once``, so no caller holds two
    locks."""
    root = shared_dir(tmp_path_factory)
    done, failed = root / f"{name}.pkl", root / f"{name}.err"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if failed.exists():
                raise RuntimeError(failed.read_text())
            if done.exists():
                with open(done, "rb") as f:
                    return pickle.load(f)
            workdir = root / name
            shutil.rmtree(workdir, ignore_errors=True)  # what a killed build left
            workdir.mkdir()
            t0 = time.monotonic()
            try:
                value = build(workdir)
            except Exception:
                failed.write_text(f"{name}: its one build in this run failed:\n{traceback.format_exc()}")
                raise
            with open(root / f"{name}.tmp", "wb") as f:
                pickle.dump(value, f)
            os.replace(root / f"{name}.tmp", done)
            with open(root / "builds.log", "a") as log:
                log.write(f"{name} {os.environ.get('PYTEST_XDIST_WORKER', 'main')} {time.monotonic() - t0:.1f}\n")
            return value
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
