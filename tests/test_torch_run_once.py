"""``tests/torch_run_once.py``: a value built once per pytest run and shared
by the xdist workers (the gloo worlds of ``tests/test_torch_sharded.py``)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from torch_run_once import once, shared_dir

HERE = Path(__file__).resolve().parent


class _Factory:
    """A stand-in for ``tmp_path_factory``: the basetemp a worker gets."""

    def __init__(self, base: Path):
        self.base = Path(base)

    def getbasetemp(self) -> Path:
        self.base.mkdir(parents=True, exist_ok=True)
        return self.base


_CALLER = """
import json, sys, time
from pathlib import Path
sys.path.insert(0, sys.argv[1])
from torch_run_once import once
from test_torch_run_once import _Factory
run, worker = Path(sys.argv[2]), sys.argv[3]
def build(workdir):
    with open(run / "counter", "a") as f:
        f.write(worker + "\\n")
    time.sleep(1.0)  # the other worker asks meanwhile
    return {"worker": worker, "workdir": str(workdir)}
print(json.dumps(once("shared", _Factory(run / f"popen-{worker}"), build)))
"""


def test_two_workers_build_once(tmp_path):
    procs = [subprocess.Popen([sys.executable, "-c", _CALLER, str(HERE), str(tmp_path), w],
                              env=dict(os.environ, PYTEST_XDIST_WORKER=w), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for w in ("gw0", "gw1")]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    values = [json.loads(o.strip().splitlines()[-1]) for o, _err in outs]
    assert (tmp_path / "counter").read_text().splitlines() == [values[0]["worker"]]  # one build
    assert values[0] == values[1]
    assert values[0]["workdir"] == str(tmp_path / "torch_once" / "shared")
    log = (tmp_path / "torch_once" / "builds.log").read_text().split()
    assert log[:2] == ["shared", values[0]["worker"]] and len(log) == 3


def test_failed_build_is_raised_to_later_callers(tmp_path, monkeypatch):
    monkeypatch.setenv("PYTEST_XDIST_WORKER", "gw0")
    calls = []

    def hang(workdir):
        calls.append(workdir)
        raise ValueError("world of 4 ranks: rank 3 did not join")

    with pytest.raises(ValueError, match="rank 3 did not join"):
        once("world", _Factory(tmp_path / "popen-gw0"), hang)
    monkeypatch.setenv("PYTEST_XDIST_WORKER", "gw1")
    with pytest.raises(RuntimeError, match="rank 3 did not join"):
        once("world", _Factory(tmp_path / "popen-gw1"), hang)
    assert len(calls) == 1  # nothing rebuilt
    assert not (tmp_path / "torch_once" / "builds.log").exists()


def test_without_xdist_the_cache_is_the_sessions(tmp_path, monkeypatch):
    monkeypatch.delenv("PYTEST_XDIST_WORKER", raising=False)
    calls = []

    def build(workdir):
        calls.append(workdir)
        (workdir / "file").write_text("kept")
        return {"n": 7, "path": workdir / "file"}

    factory = _Factory(tmp_path / "session")
    first, second = once("value", factory, build), once("value", factory, build)
    assert first == second and len(calls) == 1
    assert (tmp_path / "session" / "torch_once" / "value.pkl").exists()
    assert second["path"].read_text() == "kept"


def test_workers_share_the_runs_directory(tmp_path_factory):
    # The layout once() relies on: under xdist each worker's basetemp is
    # <run>/popen-<worker>, so its parent is the run's.
    base = tmp_path_factory.getbasetemp()
    worker = os.environ.get("PYTEST_XDIST_WORKER")
    if worker:
        assert base.name == f"popen-{worker}"
        assert shared_dir(tmp_path_factory) == base.parent / "torch_once"
    else:
        assert shared_dir(tmp_path_factory) == base / "torch_once"
