"""The per-test time limit of `time_limit.py`: a test that runs past its
limit fails with its name and its limit, and the run goes on."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

TESTS = Path(__file__).resolve().parent


def test_time_limit_fails_the_test_and_the_run_goes_on(tmp_path):
    (tmp_path / "test_demo.py").write_text(textwrap.dedent("""
        import time
        import pytest

        @pytest.mark.time_limit(2)
        def test_sleeps_past_its_limit():
            time.sleep(30)

        def test_runs_after():
            assert True
    """))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(TESTS)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "time_limit", "-p", "no:cacheprovider",
         "-p", "no:xdist", "-p", "no:randomly", "-c", str(TESTS.parent / "pyproject.toml"),
         "--rootdir", str(tmp_path), str(tmp_path / "test_demo.py")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=60)
    out = r.stdout + r.stderr
    assert r.returncode == 1, out
    assert "1 failed, 1 passed" in out, out
    assert ("test_demo.py::test_sleeps_past_its_limit ran past its time limit of 2 s (in call)"
            in out), out
    assert "PytestUnknownMarkWarning" not in out, out


def test_node_ids_of_the_tables_name_tests_that_exist():
    """A renamed test would drop its `slow` mark or its raised limit."""
    import re

    from tests import time_limit

    for nodeid in [*time_limit.SLOW, *time_limit.TIME_LIMITS]:
        path, _, name = nodeid.partition("::")
        name, _, param = name.partition("[")
        src = (TESTS.parent / path).read_text()
        assert re.search(rf"^def {name}\(", src, re.M), nodeid
        if param:
            assert all(f'"{p}"' in src for p in param.rstrip("]").split("-")), nodeid
