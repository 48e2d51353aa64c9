"""Deal the test suite to pytest-xdist's workers one test at a time.

Under ``-n 6 --dist load`` xdist's LoadScheduling first hands each worker
N // 6 // 4 consecutive tests (19 at N = 463-470). One worker's chunk then
holds about 19 cases of tests/test_fused_tick.py, its dearest among them,
and runs them in series while the other five go idle: on an 8-core machine
that worker ran alone from about 700-880 s to the end at 1911-2161 s. With
``maxschedchunk = 1`` every worker starts with 2 tests and then takes one as
each finishes, so no worker holds more than one test queued behind the one
it runs; the same suite ended at 1296-1616 s. The wall is then the start of
the dearest test, set by its place in the collection, plus its own time.
A ``--maxschedchunk`` given on the command line is kept; without xdist, or
under ``--noconftest``, nothing changes.
"""


def pytest_configure(config):
    if getattr(config.option, "maxschedchunk", 0) is None:
        config.option.maxschedchunk = 1
