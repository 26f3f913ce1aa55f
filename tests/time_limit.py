"""A time limit for every test, with the standard library only.

Each phase of a test (setup, call, teardown) runs under
`signal.setitimer(ITIMER_REAL, limit)`. When the limit passes, SIGALRM
fails the test with its node id and its limit, and the run goes on with
the next test. A call that holds the interpreter in C code (an XLA
compile) sees the signal only when it returns, so `faulthandler` is
armed as a backstop `BACKSTOP_S` later: it writes every thread's stack
to stderr and ends the process, which pytest-xdist reports as a lost
worker and replaces.

The limit is `DEFAULT_TIME_LIMIT` seconds; `@pytest.mark.time_limit(s)`
gives one test another, and so does `TIME_LIMITS` for the tests named
there by node id. `SLOW` names the tests that tier-1 leaves out: each
takes over 120 s alone and checks only the JAX package against itself.
The repo's `conftest.py` loads this plugin; a run outside the repo loads
it with `-p time_limit` and `tests/` on `PYTHONPATH`.
"""

import contextlib
import faulthandler
import os
import signal

import pytest

DEFAULT_TIME_LIMIT = 300.0
BACKSTOP_S = 60.0

# Seconds for each phase, above the default, by node id.
TIME_LIMITS = {
    "tests/test_train_e2e.py::test_checkpoint_resume_continues_training": 900,
    "tests/test_parallel.py::test_tile_sharded_pallas_interpret_base_ref": 600,
    "tests/test_parallel.py::test_dp_step_distinct_views_finite": 600,
    "tests/test_parallel.py::test_fused_fully_sharded_pipeline_matches_single_device[0]": 600,
    "tests/test_regressions.py::test_train_step_tracks_compensations": 600,
    "tests/test_regressions.py::test_gradient_skip_guard_freezes_bad_step": 600,
    "tests/test_regressions.py::test_depth_loss_finite_grads_at_vanishing_alpha[xla]": 600,
}

# Marked slow, with each one's limit in seconds.
SLOW = {
    "tests/test_parallel.py::test_dp_step_matches_mean_of_grads": 900,
    "tests/test_parallel.py::test_dp_trainer_grows_capacity": 900,
    "tests/test_parallel.py::test_fused_fully_sharded_pipeline_matches_single_device[1]": 900,
    "tests/test_parallel.py::test_trainer_tile_mesh_matches_unsharded": 900,
    "tests/test_parallel.py::test_dist_block_overflow_signals_growth": 900,
    "tests/test_parallel.py::test_2d_mesh_cameras_x_tiles_matches_dp": 14400,
    "tests/test_tools.py::test_bench_train_smoke": 900,
    "tests/test_train_e2e.py::test_training_improves_psnr": 900,
    "tests/test_train_e2e.py::test_refine_keeps_training_sane": 900,
    "tests/test_train_e2e.py::test_wild_gaussians_training": 900,
    "tests/test_train_e2e.py::test_resolution_ladder_stage_switch": 900,
    "tests/test_train_e2e.py::test_trainer_auto_grows_capacity": 900,
    "tests/test_train_e2e.py::test_deformable_training_and_refine": 900,
    "tests/test_train_e2e.py::test_deformable_enable_schedule_and_canonical_freeze": 900,
    "tests/test_train_e2e.py::test_speculative_precompile_threads": 900,
}

_STDERR = pytest.StashKey[object]()  # the terminal's stderr, kept past pytest's capture


def pytest_configure(config):
    config.stash[_STDERR] = os.fdopen(os.dup(2), "w")


def pytest_unconfigure(config):
    config.stash[_STDERR].close()


@pytest.hookimpl(tryfirst=True)  # before `-m` deselects
def pytest_collection_modifyitems(items):
    for item in items:
        if item.nodeid in SLOW:
            item.add_marker(pytest.mark.slow)
        limit = SLOW.get(item.nodeid, TIME_LIMITS.get(item.nodeid))
        if limit is not None:
            item.add_marker(pytest.mark.time_limit(limit))


def time_limit(item) -> float:
    marker = item.get_closest_marker("time_limit")
    return float(marker.args[0]) if marker else DEFAULT_TIME_LIMIT


@contextlib.contextmanager
def _armed(item, phase):
    limit = time_limit(item)

    def on_alarm(signum, frame):
        pytest.fail(f"{item.nodeid} ran past its time limit of {limit:g} s (in {phase})")

    previous = signal.signal(signal.SIGALRM, on_alarm)
    signal.setitimer(signal.ITIMER_REAL, limit)
    faulthandler.dump_traceback_later(limit + BACKSTOP_S, exit=True,
                                      file=item.config.stash[_STDERR])
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)
        faulthandler.cancel_dump_traceback_later()


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with _armed(item, "setup"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _armed(item, "call"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item, nextitem):
    with _armed(item, "teardown"):
        return (yield)
