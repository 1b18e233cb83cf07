"""A time limit for every test of the repo, so that a test that hangs or
runs far past its size fails alone instead of stalling the whole run.

Each phase of a test (setup, call, teardown) gets ``TIME_LIMIT_S``; setup
covers the module- and session-scoped fixtures the test is first to need.
When the limit passes, SIGALRM fails the phase from the main thread
(pytest-xdist runs tests there too). A hang inside C code never returns to
the interpreter to take the signal, so it still stalls its worker. For such
a hang, pytest's faulthandler plugin prints every thread's stack once the
test has run ten seconds past the limit: that stack is what it leaves to
find it by.
"""

import contextlib
import signal

import pytest

TIME_LIMIT_S = 300


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: left out of the tier-1 run by -m 'not slow'")
    # An ini file's or -o's faulthandler_timeout takes precedence.
    config.inicfg.setdefault("faulthandler_timeout", str(TIME_LIMIT_S + 10))


@contextlib.contextmanager
def _time_limit(item):
    def on_alarm(signum, frame):
        pytest.fail(f"{item.nodeid} exceeded its time limit of "
                    f"{TIME_LIMIT_S} s")

    previous = signal.signal(signal.SIGALRM, on_alarm)
    signal.setitimer(signal.ITIMER_REAL, TIME_LIMIT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with _time_limit(item):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _time_limit(item):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item):
    with _time_limit(item):
        return (yield)
