"""The port's samples (``lanczos_tpu_torch/samples``) on the CPU.

Each sample runs as ``python -m lanczos_tpu_torch.samples.<name>`` in a
subprocess with ``LT_SAMPLE_DEVICE=cpu`` and prints one ``error <what>:
<value>`` line for every result it holds against its truth (analytic,
numpy or scipy); every such value must be within the bar of
``lanczos_tpu_torch.samples.BARS`` (the JAX sample's own assertion, else
the bar of the JAX package's tests for that API).  The JAX samples are not
run here: ``tests/test_samples.py`` runs them.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from lanczos_tpu_torch.samples import BARS, SAMPLES, printed_errors

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 600
# One thread each: the test workers run side by side, and many-threaded
# small tensor ops in every worker's subprocess oversubscribe the cores
# (sample9 ran past 300 s that way beside three workers, 31 s alone).
ONE_THREAD = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def _run(name, **env):
    # The test's own environment (its TMPDIR and HOME among it), with the
    # repo first on the path and the device only as ``env`` gives it.
    base = {k: v for k, v in os.environ.items() if k != "LT_SAMPLE_DEVICE"}
    path = os.pathsep.join(p for p in (str(REPO), os.environ.get("PYTHONPATH", "")) if p)
    return subprocess.run([sys.executable, "-m", f"lanczos_tpu_torch.samples.{name}"], cwd=REPO,
                          env=dict(base, PYTHONPATH=path, **ONE_THREAD, **env),
                          capture_output=True, text=True, timeout=TIMEOUT_S)


@pytest.mark.parametrize("name", SAMPLES)
def test_sample_meets_its_bars(name):
    proc = _run(name, LT_SAMPLE_DEVICE="cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    errors = printed_errors(proc.stdout)
    assert set(errors) == set(BARS[name]), (sorted(errors), sorted(BARS[name]))  # every check printed, no other
    for what, value in errors.items():
        assert value <= BARS[name][what], (name, what, value, BARS[name][what], proc.stdout[-2000:])


def test_sample_without_a_card_fails():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    proc = _run("sample1_simple")  # LT_SAMPLE_DEVICE unset: the card, which is not here
    assert proc.returncode != 0
    assert "LT_SAMPLE_DEVICE=cpu" in proc.stderr and "Eigenvalue" not in proc.stdout
