"""The suite's schedule and time limit (`tests/conftest.py`), on a toy suite.

The toy's conftest loads the hooks of `tests/conftest.py` and sets its own
split list and a 2 s time limit. One run under xdist's `--dist loadfile`
with two workers, as the tier-1 command runs the suite, checks that the split
file's tests go to both workers ahead of every other file, and that a test past
the limit fails under its own name while its worker goes on. Without xdist,
checked in this process, the hooks load and keep the collection order.
"""

import importlib.util
import os
import subprocess
import sys
import types
import xml.etree.ElementTree as ET

import pytest
from _pytest.config import PytestPluginManager

CONFTEST = os.path.join(os.path.dirname(os.path.abspath(__file__)), "conftest.py")

TOY_CONFTEST = f"""
import importlib.util

spec = importlib.util.spec_from_file_location("suite_conftest", {CONFTEST!r})
suite = importlib.util.module_from_spec(spec)
spec.loader.exec_module(suite)
suite.SPLIT_FILES = ("test_split.py",)
suite.TEST_TIME_LIMIT = 2.0

pytest_configure = suite.pytest_configure
pytest_unconfigure = suite.pytest_unconfigure
pytest_xdist_make_scheduler = suite.pytest_xdist_make_scheduler
pytest_collection_modifyitems = suite.pytest_collection_modifyitems
pytest_runtest_setup = suite.pytest_runtest_setup
pytest_runtest_call = suite.pytest_runtest_call
pytest_runtest_teardown = suite.pytest_runtest_teardown
"""

RECORD = """
import os
import pathlib
import time


def record(request):
    with open(pathlib.Path(__file__).with_name("starts.txt"), "a") as f:
        f.write(f"{os.environ['PYTEST_XDIST_WORKER']} {request.node.nodeid}\\n")
"""

SPLIT = RECORD + """
import pytest


@pytest.mark.parametrize("i", range(4))
def test_split(request, i):
    record(request)
"""

# More tests than a split unit has, so xdist's own order would put it first.
PLAIN = RECORD + """
import pytest


@pytest.mark.parametrize("i", range(6))
def test_plain(request, i):
    record(request)
"""

LIMIT = RECORD + """
import threading


def test_sleep(request):
    record(request)
    time.sleep(30)


def test_join(request):
    record(request)
    t = threading.Thread(target=threading.Event().wait, daemon=True)
    t.start()
    t.join()


def test_after(request):
    record(request)
"""


def _toy_run(root, *args):
    """Run the toy suite in `root`: the run's result, each test's (worker,
    node id) in the order they started, and each test's outcome by name (a
    failure's message)."""
    for name, text in [("conftest.py", TOY_CONFTEST), ("test_split.py", SPLIT),
                       ("test_plain.py", PLAIN), ("test_limit.py", LIMIT)]:
        (root / name).write_text(text)
    (root / "starts.txt").write_text("")
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", f"--rootdir={root}", f"--basetemp={root / 'tmp'}",
         "--junitxml=toy.xml", *args],
        cwd=root, env=env, capture_output=True, text=True, timeout=120,
    )
    starts = [line.split() for line in (root / "starts.txt").read_text().splitlines()]
    outcomes = {}
    for case in ET.parse(root / "toy.xml").iter("testcase"):
        failure = case.find("failure")
        outcomes[case.get("name")] = "passed" if failure is None else failure.get("message")
    return proc, starts, outcomes


@pytest.fixture(scope="module")
def xdist_run(tmp_path_factory):
    return _toy_run(tmp_path_factory.mktemp("toy"), "-p", "xdist", "-n", "2", "--dist", "loadfile")


def test_split_file_runs_on_every_worker(xdist_run):
    _, starts, _ = xdist_run
    assert {w for w, nodeid in starts if nodeid.startswith("test_split.py")} == {"gw0", "gw1"}


def test_split_file_is_handed_out_first(xdist_run):
    _, starts, _ = xdist_run
    for worker in ("gw0", "gw1"):
        files = [nodeid.split("::")[0] for w, nodeid in starts if w == worker]
        n_split = files.count("test_split.py")
        assert n_split and files[:n_split] == ["test_split.py"] * n_split, files


@pytest.mark.parametrize("name", ["test_sleep", "test_join"])
def test_a_test_past_the_limit_fails_under_its_name(xdist_run, name):
    _, _, outcomes = xdist_run
    assert f"test_limit.py::{name} ran past the 2 s time limit" in outcomes[name]


def test_the_run_goes_on_past_the_limit(xdist_run):
    proc, starts, outcomes = xdist_run
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "2 failed, 11 passed" in proc.stdout, proc.stdout
    assert outcomes["test_after"] == "passed"
    assert {w for w, nodeid in starts if nodeid.startswith("test_limit.py")} == {
        w for w, nodeid in starts if nodeid == "test_limit.py::test_after"
    }


def test_a_run_without_xdist_keeps_its_order():
    spec = importlib.util.spec_from_file_location("suite_conftest", CONFTEST)
    suite = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(suite)
    # pytest's own hooks without xdist's: only an optional hook may be unknown
    plugins = PytestPluginManager()
    plugins.register(suite)
    plugins.check_pending()
    items = [types.SimpleNamespace(nodeid=f"tests/test_plain.py::test_plain[{i}]") for i in range(3)]
    items.append(types.SimpleNamespace(nodeid=f"{suite.SPLIT_FILES[0]}::test_split"))
    collected = list(items)
    suite.pytest_collection_modifyitems(types.SimpleNamespace(), items)  # no `workerinput`
    assert items == collected
