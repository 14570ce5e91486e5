"""Every entry of ``BENCHMARK.json`` resolves to its files, the file keeps
to the benchmark's contract, and a cell added as new files in a copy of
the benchmark is found without an edit."""

import json
import re
import shutil

import pytest

from benchmark.harness import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
# widths that a configuration may never cut
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|width"
                   r"|proj|head|expan|channels|planes|^m$|experts_per")


def bench():
    return core.registry()


def test_top_level_keys_and_command():
    b = bench()
    assert set(b) == KEYS["top"]
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    assert (core.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_configs_resolve():
    b = bench()
    files = set()
    for c in b["configs"]:
        assert set(c) == KEYS["config"]
        assert NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        body = core.load_json(core.ROOT / c["file"])
        assert body["name"] == c["name"]
        assert body["source"] == c["source"]
        assert body["reduced"] == c["reduced"]
        assert not any(WIDTH.search(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in b["workloads"])


def test_workloads_resolve_to_traffic_and_driver():
    b = bench()
    pairs = set()
    configs = {c["name"] for c in b["configs"]}
    for w in b["workloads"]:
        assert set(w) == KEYS["workload"]
        assert NAME.match(w["name"]) and w["config"] in configs
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        work, conf, conf_file, traffic = core.cell(w["name"])
        assert (core.BENCH_DIR / "drivers"
                / (traffic["driver"] + ".py")).is_file()
        assert hasattr(core.driver(traffic), "Driver")
    assert sum(w["chips"] == 4 for w in b["workloads"]) \
        <= max(1, len(b["workloads"]) // 4)


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics_resolve(kind):
    b = bench()
    names = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    seen = set()
    for m in b[kind]:
        assert set(m) - {"workloads"} == KEYS[kind]
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", names)) <= names
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
            continue
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert hasattr(core.reader(m["name"]), "read")
        moved = e2e[m["moves"]]
        for w in m.get("workloads", names):
            assert w in moved.get("workloads", names)
    if kind == "end_to_end":
        assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25


def test_every_cell_reports_enough():
    b = bench()
    for w in b["workloads"]:
        e2e = [m["name"] for m in core.metrics_for(w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert core.metrics_for(w["name"], "per_layer")


def test_a_cell_added_as_new_files_is_found(tmp_path):
    shutil.copytree(core.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    b = bench()
    b["workloads"].append({"name": "mopa_scn.train_small_pool",
                           "config": "mopa_scn", "traffic": "prebuilt_train",
                           "chips": 1, "why": "a test cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    traffic = core.load_json(core.BENCH_DIR / "workloads"
                             / "mopa_scn.train_prebuilt.json")
    traffic["pool"] = 4
    (tmp_path / "benchmark" / "workloads"
     / "mopa_scn.train_small_pool.json").write_text(json.dumps(traffic))
    work, conf, conf_file, found = core.cell("mopa_scn.train_small_pool",
                                             tmp_path)
    assert work["config"] == "mopa_scn" and found["pool"] == 4
    assert conf_file["name"] == "mopa_scn"
    names = [m["name"] for m in core.metrics_for(
        "mopa_scn.train_small_pool", "end_to_end", tmp_path)]
    assert names == ["setup_s", "peak_mem_gib"]
