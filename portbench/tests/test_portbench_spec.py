"""``BENCHMARK.json`` keeps to the benchmark's contract, and every name in
it finds its files under ``portbench/``."""

import json
import re

import pytest

from portbench.lib import harness, spec

BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|head|latent|state|"
                   r"projection|expan|experts_per_tok")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    items = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] \
        + BENCH["per_layer"]
    for it in items:
        assert NAME.match(it["name"]), it["name"]
        for k in ("why", "layer", "source"):
            if k in it:
                assert 1 <= len(it[k]) <= 200 and "\n" not in it[k], it
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names = [it["name"] for it in items]
    assert len(names) == len(set(names))


def test_cells_find_their_files():
    for w in BENCH["workloads"]:
        cell = spec.load(w["name"])
        assert w["chips"] == 1
        ref = cell.ref
        assert set(ref.param_shapes(cell.conf))
        assert (spec.BENCH / "lib" / f"drive_{cell.cell['driver']}.py") \
            .exists()


def test_configs_state_their_cuts():
    for c in BENCH["configs"]:
        conf = spec.load_json(spec.ROOT / c["file"])
        assert conf["source"] == c["source"]
        # Every key changed from the source: the semantic departures the
        # program forces (none of this file's keys is cut for size).
        assert sorted(conf["departures"]) == sorted(c["reduced"])
        assert not any(WIDTH.search(k) for k in c["reduced"]), c["reduced"]


def test_metrics_move_a_reported_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for w in m["workloads"]:
            assert spec.applies(e2e[m["moves"]], w), (m["name"], w)
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
        assert harness.reader_path(m["name"]).exists()
    assert all(len(v) == 1 for v in layers.values()), layers
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_setup_another_e2e_and_a_layer(w):
    e2e = [m["name"] for m in BENCH["end_to_end"] if spec.applies(m, w)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(spec.applies(m, w) for m in BENCH["per_layer"])


@pytest.mark.parametrize("path", sorted(
    p.name for p in (spec.BENCH / "configs").glob("*.json")))
def test_port_config_matches_registry(path):
    """Every configuration file, listed or kept for a later cell, states
    the configuration the port runs."""
    from portbench.lib import port
    conf = spec.load_json(spec.BENCH / "configs" / path)
    port.model_config(conf, spec.reference(conf), strict=True)
