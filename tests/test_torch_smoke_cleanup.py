"""``chip_smoke.py`` stops what it started: a phase that raises leaves
planted-fault builds that no later phase reads, and the script ends each
of them, with the compilers that ``nvcc`` started, before it exits.  Here
a stand-in ``nvcc`` (a shell script that starts a child and sleeps) takes
the compiler's place."""

import os
import time

import pytest

import chip_smoke as S
from paddle_tpu_torch.ops.kernels import _build


def _alive(pid: int) -> bool:
    """Whether ``pid`` runs (a zombie, ended but not yet reaped, does
    not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


@pytest.mark.skipif(not os.path.isdir("/proc/self"), reason="needs /proc")
def test_stop_fault_builds_ends_each_build_and_its_children(tmp_path,
                                                           monkeypatch):
    child_pids = tmp_path / "children"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!/bin/sh\nsleep 60 &\necho $! >> {child_pids}\n"
                    "sleep 60\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build" / "kernels")
    monkeypatch.setattr(S, "_fault_procs", [])
    builds = S.source_fault_builds("paged_attention", S.PAGED_BF16_FAULTS,
                                   prefix="bf16_")
    assert len(S._fault_procs) == len(builds) == len(S.PAGED_BF16_FAULTS)
    deadline = time.monotonic() + 30
    while (not child_pids.exists()
           or len(child_pids.read_text().split()) < len(builds)):
        assert time.monotonic() < deadline, "the stand-in builds never ran"
        time.sleep(0.05)
    children = [int(p) for p in child_pids.read_text().split()]
    assert all(p.poll() is None for p in S._fault_procs)
    S.stop_fault_builds()
    assert all(p.returncode is not None for p in S._fault_procs)
    deadline = time.monotonic() + 10
    while any(_alive(pid) for pid in children):
        assert time.monotonic() < deadline, "a build's child outlived it"
        time.sleep(0.05)
    S.stop_fault_builds()    # a second call finds nothing left to end
