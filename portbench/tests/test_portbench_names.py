"""BENCHMARK.json against the contract's forms, and every name it gives
found as a file."""

import re

import pytest

from portbench.tests.conftest import REPO, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_names_and_units(bench):
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[section]]
        assert len(names) == len(set(names)), section
        for n in names:
            assert NAME.match(n), n
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in bench["configs"]:
        for k in c["reduced"]:
            assert NAME.match(k), k
        assert len(c["source"]) <= 200
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")


def test_every_name_has_its_file(bench):
    for c in bench["configs"]:
        assert (REPO / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
    for w in bench["workloads"]:
        assert (ROOT / "traffic" / f"{w['traffic']}.json").is_file()
    for m in bench["per_layer"]:
        assert (ROOT / "metrics" / f"{m['name']}.py").is_file()


def test_every_cell_reports_what_it_must(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    assert all("workloads" not in m for m in bench["end_to_end"])
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["workloads"] and set(m["workloads"]) <= cells, m["name"]
        assert m["moves"] in e2e, m["name"]
    for w in bench["workloads"]:
        assert any(w["name"] in m["workloads"] for m in bench["per_layer"])


@pytest.mark.parametrize("key", ["run_seconds"])
def test_run_seconds_fits_the_check(bench, key):
    s = bench[key]
    assert 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200
