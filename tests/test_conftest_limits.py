"""The per-test time limit of the repo's root conftest.py, run on tiny test
files in a pytest of their own that loads a copy of that conftest with the
limit cut to 1 s."""

import subprocess
import sys
import textwrap
import time
from pathlib import Path

CONFTEST = Path(__file__).resolve().parents[1] / "conftest.py"


def _run_pytest(tmp_path, source):
    src = CONFTEST.read_text()
    short = src.replace("TIME_LIMIT_S = 300", "TIME_LIMIT_S = 1")
    assert short != src
    (tmp_path / "conftest.py").write_text(short)
    (tmp_path / "test_inner.py").write_text(textwrap.dedent(source))
    start = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:xdist",
         "-p", "no:cacheprovider", "-p", "no:randomly",
         "test_inner.py"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
    )
    return proc, time.monotonic() - start


def test_over_limit_fails_alone(tmp_path):
    proc, wall = _run_pytest(tmp_path, """
        import time

        def test_sleeps_past_its_limit():
            time.sleep(5)

        def test_after_it():
            pass
    """)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "1 failed, 1 passed" in proc.stdout, proc.stdout
    assert ("test_sleeps_past_its_limit exceeded its time limit of 1 s"
            in proc.stdout), proc.stdout
    assert wall < 30


def test_under_limit_passes(tmp_path):
    # Setup and call together run past the limit; each phase alone does not.
    proc, _ = _run_pytest(tmp_path, """
        import time
        import pytest

        @pytest.fixture(scope="module")
        def slow_setup():
            time.sleep(0.6)

        def test_within_its_limit(slow_setup):
            time.sleep(0.6)

        def test_after_it():
            time.sleep(0.2)
    """)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "2 passed" in proc.stdout, proc.stdout


def test_hang_out_of_reach_of_the_signal_prints_its_stack(tmp_path):
    # With SIGALRM blocked the handler cannot run, as in a hang inside C;
    # the signal stays pending until the test unblocks it. pytest's
    # faulthandler prints the stack ten seconds past the limit.
    proc, wall = _run_pytest(tmp_path, """
        import signal
        import time

        def test_blocks_the_alarm():
            signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGALRM})
            try:
                time.sleep(12)
            finally:
                signal.pthread_sigmask(signal.SIG_UNBLOCK, {signal.SIGALRM})
    """)
    assert "Timeout (0:00:11)!" in proc.stderr, proc.stderr
    assert "in test_blocks_the_alarm" in proc.stderr, proc.stderr
    assert "1 failed" in proc.stdout, proc.stdout
    assert "exceeded its time limit of 1 s" in proc.stdout, proc.stdout
    assert wall < 30
