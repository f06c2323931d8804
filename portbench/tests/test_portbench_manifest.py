"""BENCHMARK.json against its contract, and every file a name leads to."""

import json
import os
import re
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
from portbench import harness  # noqa: E402

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source",
                   "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    files = [w for w in cmd if os.path.exists(os.path.join(ROOT, w))]
    assert all(any(f.startswith(p + "/") for p in BENCH["paths"])
               for f in files)
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check with 24 cells fits its time
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("group", sorted(KEYS))
def test_entries_keys_and_names(group):
    entries = BENCH[group]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert set(e) <= KEYS[group] and NAME.match(e["name"])
        if "why" in e:
            assert _line(e["why"])
        if group in ("end_to_end", "per_layer"):
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                            "higher")
        if group == "end_to_end":
            assert e["source"] in ("host_clock", "device_trace")
            assert 0.01 <= e["bound"] <= 0.25
        if group == "per_layer":
            assert e["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert _line(e["layer"])
            assert e["moves"] in [m["name"] for m in BENCH["end_to_end"]]
    if group == "configs":
        for e in entries:
            assert _line(e["source"]) and len(e["reduced"]) <= 16
            assert all(NAME.match(k) for k in e["reduced"])


def test_cells_and_their_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    used = set()
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        wl = json.load(open(os.path.join(ROOT, "portbench", "workloads",
                                         w["name"] + ".json")))
        assert (wl["name"], wl["config"], wl["traffic"], wl["chips"]) == (
            w["name"], w["config"], w["traffic"], w["chips"])
        data = os.path.join(ROOT, wl["data"])
        assert os.path.isfile(os.path.join(data, "ice.input"))
        # every cell reports setup_s, another end-to-end metric and a
        # per-layer one, each with a reader
        e2e = [m for m in BENCH["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        pl = [m for m in BENCH["per_layer"]
              if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert pl
        for m in pl:
            assert m["moves"] in [x["name"] for x in e2e]
    assert used == set(configs)
    files = [c["file"] for c in configs.values()]
    assert len(set(files)) == len(files)
    for c in configs.values():
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    for m in METRICS:
        assert os.path.isfile(harness.reader_path(m["name"], ROOT))


def test_layer_names_match():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_four_chip_share():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
