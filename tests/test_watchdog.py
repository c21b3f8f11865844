"""The per-test time limit of the root conftest.py: a test past it fails with
every thread's stack printed, its subprocesses end, and the run goes on
with the next test."""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

HANGS = '''
import ctypes
import pathlib
import subprocess

import conftest

conftest.TEST_TIME_LIMIT = 3.0


def test_blocks_in_native_code():
    child = subprocess.Popen(["sleep", "120"])
    (pathlib.Path(__file__).parent / "child.pid").write_text(str(child.pid))
    # libc's sleep() with the GIL held: no Python code runs, a signal
    # handler included, until it returns; so for a test blocked in XLA.
    ctypes.PyDLL(None).sleep(120)


def test_after_it():
    pass
'''


def test_a_test_past_the_limit_fails_with_every_stack(tmp_path):
    (tmp_path / "test_hangs.py").write_text(HANGS)
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", str(tmp_path / "test_hangs.py"),
         "-p", "conftest", "-p", "xdist", "-n", "1", "--dist", "load",
         "-p", "no:cacheprovider", "-p", "no:randomly", "-q"],
        cwd=ROOT, capture_output=True, text=True, timeout=100)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 1, out
    assert "Timeout (0:00:03)!" in out, out
    assert "line 16 in test_blocks_in_native_code" in out, out
    assert "crashed while running" in out, out
    assert "1 failed, 1 passed" in out, out
    # The test's subprocess went with its worker: gone, or a zombie.
    stat = pathlib.Path(f"/proc/{(tmp_path / 'child.pid').read_text()}/stat")
    assert not stat.exists() or stat.read_text().split()[2] in "ZX"
