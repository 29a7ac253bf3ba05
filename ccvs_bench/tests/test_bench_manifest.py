"""``BENCHMARK.json`` against the rules it is held to: its keys, names and
units, every cell's files found by name, each per-layer metric's end-to-end
metric reported where it is, and the imports that the measured process and
the reference may not make."""

import ast
import json
import os
import re

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def man():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_limits(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert man["command"] == ["python3", "ccvs_bench/run.py"]
    assert man["paths"] == ["ccvs_bench"]
    rs = man["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells at this length fits in 43200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert "setup_s" in {m["name"] for m in man["end_to_end"]}


def test_names_units_and_texts(man):
    groups = ("configs", "workloads", "end_to_end", "per_layer")
    for g in groups:
        names = [x["name"] for x in man[g]]
        assert len(names) == len(set(names)), g
        for x in man[g]:
            assert NAME.match(x["name"]), x["name"]
            if "unit" in x:
                assert UNIT.match(x["unit"]), x["unit"]
                assert x["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in x:
                    assert 1 <= len(x[key]) <= 200 and "\n" not in x[key] and "\t" not in x[key]
    for w in man["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_cells_find_their_files(man):
    configs = {c["name"]: c for c in man["configs"]}
    used = set()
    for w in man["workloads"]:
        c = configs[w["config"]]
        used.add(c["name"])
        assert c["file"] == f"ccvs_bench/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        for part in (("traffic", w["traffic"] + ".json"), ("limits", w["name"] + ".json")):
            assert os.path.exists(os.path.join(BENCH, *part)), part
    assert used == set(configs)
    for m in man["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics", m["name"] + ".py")), m["name"]


def test_each_layer_metric_moves_one_reported_metric(man):
    cells = {w["name"] for w in man["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in man["end_to_end"]}
    for name, where in e2e.items():
        assert where <= cells, name
    reported = {c: {n for n, where in e2e.items() if c in where} for c in cells}
    for c in cells:
        assert "setup_s" in reported[c] and len(reported[c]) >= 2, c
    for m in man["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s", m["name"]
        for c in m.get("workloads", cells):
            assert c in cells and m["moves"] in reported[c], (m["name"], c)
    layers = {}
    for m in man["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for c in cells:
        assert any(c in m.get("workloads", cells) for m in man["per_layer"]), c


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def _sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_and_a_reference_of_its_own():
    """Nothing of the benchmark imports JAX or the JAX package (the whole
    top-level name compared, so ``ccvs_tpu_torch`` is not ``ccvs_tpu``), and
    the reference imports nothing of the program."""
    for path in _sources(BENCH):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "ccvs_tpu"}, path
        if os.sep + "reference" + os.sep in path:
            assert "ccvs_tpu_torch" not in tops, path


def test_test_names_are_the_benchmarks_own():
    ours = {f for f in os.listdir(os.path.join(BENCH, "tests")) if f.endswith(".py")}
    theirs = set(os.listdir(os.path.join(ROOT, "tests"))) if os.path.isdir(
        os.path.join(ROOT, "tests")) else set()
    assert not (ours - {"conftest.py", "__init__.py"}) & theirs
