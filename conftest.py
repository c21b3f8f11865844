"""Repository-wide test hooks: how xdist hands out tests, a time limit on
every test, the JAX package's goldens that cannot finish marked ``slow``,
and where the JAX compile cache lives.

Tier-1 runs ``python -m pytest tests/ -m 'not slow' -p xdist -n 6 --dist
load`` on the CPU, with ``JAX_PLATFORMS=cpu``; ``tests/conftest.py`` sets
XLA:CPU's flags and the persistent compile cache.

Hand-out.  Under xdist this file sets ``--maxschedchunk=1`` unless it is
given, so ``--dist load`` hands each worker one test at a time as it frees
up (at most two queued).  xdist's default first hand-out is a block of
``len(collection) // workers // 4`` consecutive tests a worker, which put
all of the JAX package's e2e goldens, in alphabetical order, on one worker.

Time limit.  A test that runs past ``TEST_TIME_LIMIT`` seconds, setup and
teardown included, prints every thread's stack.  In an xdist worker the
worker then exits: xdist reports the test as failed and starts a fresh
worker, this file ends the test's subprocesses, and the run goes on.
``faulthandler`` does this from a C thread, so it fires while the test's
thread is blocked in native code (an XLA compile).  Outside xdist it only
prints the stacks: exiting would end the run.

Slow.  The tests in ``SLOW`` compile on XLA:CPU for longer than the limit.
Tier-1 deselects them (``-m 'not slow'``); ``-m slow`` runs them, without
the limit.
"""

import faulthandler
import os
import pathlib
import signal
import sys
import tempfile

import pytest

# The lower of 600 s and 1.5 times the slowest test kept in Tier-1
# (test_native_shim.py's C client, which fails at its own 600-s limit on
# a subprocess).
TEST_TIME_LIMIT = 600.0

# JAX-package goldens past the limit from an empty compile cache (663 s to
# more than 2640 s, up to 56 GB a process).  The port's tests hold the same
# goldens and scene: test_torch_goldens.py [fx_echo], [fx_equalizer],
# [fx_distortion], [stereo_filtered_tone]; test_torch_eax.py the EAX scene.
SLOW = {
    "tests/test_e2e_effects.py::test_echo_send",
    "tests/test_e2e_effects.py::test_equalizer_send",
    "tests/test_e2e_effects2.py::test_distortion_send",
    "tests/test_e2e_stereo.py::test_filtered_tone",
    "tests/test_eax.py::test_eax2_reverb_renders_through_efx",
}

_stderr_fd = None


def pytest_configure(config):
    global _stderr_fd
    # Not in pyproject.toml's addopts: pytest without xdist would refuse it.
    if (config.pluginmanager.hasplugin("xdist")
            and config.getoption("maxschedchunk") is None):
        config.option.maxschedchunk = 1
    # A copy of stderr made outside output capture, for the watchdog.
    _stderr_fd = os.dup(2)
    # tests/conftest.py points the JAX compile cache at a fixed path; keep
    # it under this run's temporary directory instead, so that runs from
    # two checkouts on one machine do not share compiles.
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.config.update(
            "jax_compilation_cache_dir",
            os.path.join(tempfile.gettempdir(), "openal_tpu_jax_cache"))


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(config, items):
    # Before the ``-m`` selection reads the marks.
    for item in items:
        if item.nodeid in SLOW:
            item.add_marker(pytest.mark.slow)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item, nextitem):
    if item.get_closest_marker("slow") is not None:
        return (yield)
    faulthandler.dump_traceback_later(
        TEST_TIME_LIMIT, exit=hasattr(item.config, "workerinput"),
        file=_stderr_fd)
    try:
        return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()


@pytest.hookimpl(optionalhook=True)
def pytest_testnodedown(node, error):
    """A worker that exited at the time limit leaves its subprocesses
    running (a C client, gloo ranks): end every process that inherited
    its worker id and this run's id."""
    if error is None:
        return
    tags = {f"PYTEST_XDIST_WORKER={node.gateway.id}".encode(),
            f"PYTEST_XDIST_TESTRUNUID={node.workerinput['testrunuid']}"
            .encode()}
    for environ in pathlib.Path("/proc").glob("[0-9]*/environ"):
        try:
            if tags <= set(environ.read_bytes().split(b"\0")):
                os.kill(int(environ.parent.name), signal.SIGKILL)
        except OSError:
            pass
