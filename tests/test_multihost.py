"""Multi-process ``jax.distributed`` rehearsal (chan axis across
processes, as on a multi-host deployment), on the CPU only.

Spawns real CPU subprocesses — the only way to exercise the multi-controller
path (make_array_from_process_local_data, cross-process jit dispatch,
Gloo collectives) — and checks the result is bitwise-identical to a
single-process run over the same per-process data.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "benchmarks", "multihost_rehearsal.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    env = os.environ.copy()
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    return env


def _run(args, timeout=240):
    return subprocess.run(
        [sys.executable, SCRIPT] + args, capture_output=True, text=True,
        timeout=timeout, env=_env(), cwd=REPO)


@pytest.mark.slow
def test_two_process_rehearsal_matches_single():
    port = _free_port()
    common = ["--coordinator", f"localhost:{port}", "--num-processes", "2",
              "--local-devices", "4"]
    procs = [subprocess.Popen(
        [sys.executable, SCRIPT] + common + ["--process-id", str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=REPO) for i in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    results = {json.loads(out.splitlines()[-1])["process"]: (
        json.loads(out.splitlines()[-1])) for out, _ in outs}
    assert results[0]["global_devices"] == 8
    assert results[0]["channels_global"] == 8
    assert results[0]["local_checksum"] != results[1]["local_checksum"]

    # A single process given process 0's data (same seed) must produce a
    # bitwise-identical residual: the chan axis is pure data parallelism.
    single = _run(["--local-devices", "4"])
    assert single.returncode == 0, single.stderr[-2000:]
    sres = json.loads(single.stdout.splitlines()[-1])
    assert sres["local_checksum"] == results[0]["local_checksum"]
