"""scripts/graftcheck over the port: its ten checkers run through
``run_graftcheck`` on the port's roots (the package, chip_smoke.py and every
scripts/*_torch.py) with the port-side baseline
(production_stack_tpu_torch/graftcheck_baseline.json), and GC005's
endpoint-parity guard holds the port's pair: its engine's api_server.py,
its fake engine and its router. The checkers and the JAX baseline are used
as they are; GC005's three file constants are pointed at the port inside
the test only."""

import json
import os
import pathlib
import shutil
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "scripts"))
from graftcheck import core, gc005_endpoints  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
BASELINE = REPO / "production_stack_tpu_torch" / "graftcheck_baseline.json"
ROOTS = ["production_stack_tpu_torch", "chip_smoke.py"] + sorted(
    p.relative_to(REPO).as_posix() for p in (REPO / "scripts").glob("*_torch.py"))
PORT_PAIR = {
    "ENGINE_FILE": "production_stack_tpu_torch/engine/api_server.py",
    "FAKE_FILE": "production_stack_tpu_torch/testing/fake_engine.py",
    "ROUTER_DIR": "production_stack_tpu_torch/router/",
}


@pytest.fixture
def port_pair(monkeypatch):
    for name, value in PORT_PAIR.items():
        monkeypatch.setattr(gc005_endpoints, name, value)


@pytest.fixture(scope="module")
def index():
    """One parse of the port's roots, shared by the tree-level cases."""
    return core.RepoIndex(REPO, ROOTS)


def _baseline():
    return json.loads(BASELINE.read_text())


def test_the_roots_cover_the_port_and_its_scripts(index):
    paths = {f.path for f in index.files}
    for path in ("chip_smoke.py", "scripts/chaos_check_torch.py", "scripts/kv_directory_report_torch.py",
                 "scripts/fleet_controller_torch.py", PORT_PAIR["ENGINE_FILE"], PORT_PAIR["FAKE_FILE"],
                 "production_stack_tpu_torch/router/app.py"):
        assert path in paths, path
    assert not [p for p in paths if p.startswith("production_stack_tpu/")]


def test_port_tree_has_no_unsuppressed_findings(port_pair, index):
    violations, stats = core.run_graftcheck(REPO, ROOTS, baseline=_baseline(), index=index)
    assert not violations, (
        "graftcheck failed on the port (fix the hazard, or use a reasoned "
        "'# graftcheck: disable=GCnnn — <reason>' / graftcheck_baseline.json entry):\n"
        + "\n".join(f.render() for f in violations)
    )
    # the flight recorder's racy pre-check is suppressed in place, and the
    # baseline's one entry (the tiers miss counter) still matches a finding
    assert stats["suppressed"] >= 1 and stats["baselined"] == len(_baseline()) == 1
    assert stats["raw_findings"] == stats["suppressed"] + stats["baselined"]


def test_port_baseline_entries_carry_reasons_and_match_the_jax_format():
    jax_keys = {e["key"] for e in json.loads((REPO / "scripts" / "graftcheck" / "baseline.json").read_text())}
    for entry in _baseline():
        assert set(entry) == {"key", "reason"}, entry
        assert entry["reason"].strip(), entry
        rule, path = entry["key"].split(":")[:2]
        assert rule.startswith("GC") and path.startswith("production_stack_tpu_torch/"), entry
        # the one entry is the port's copy of a JAX baseline entry
        assert entry["key"].replace("production_stack_tpu_torch/", "production_stack_tpu/") in jax_keys


def test_gc005_port_pair_extracts_its_surfaces(port_pair, index):
    """The extraction sees the port pair's tables, and the port's fake
    covers every engine route the port's router calls."""
    routes = gc005_endpoints.extract_routes(index.get(PORT_PAIR["ENGINE_FILE"]))
    fake_routes = gc005_endpoints.extract_routes(index.get(PORT_PAIR["FAKE_FILE"]))
    called = gc005_endpoints.extract_router_paths(
        [f for f in index.files if f.path.startswith(PORT_PAIR["ROUTER_DIR"])])
    assert "/v1/chat/completions" in routes and "/abort" in routes
    for path in ("/metrics", "/slo_records", "/abort", "/migrate_attach"):
        assert path in called and path in fake_routes, path
    assert not [p for p in called if p in routes and p not in fake_routes]
    assert gc005_endpoints.check(index) == []


@pytest.mark.parametrize("route", ["/abort", "/migrate_attach", "/v1/completions"])
def test_gc005_reports_a_route_deleted_from_a_copy_of_the_port_fake(port_pair, tmp_path, route):
    """Mutation check: a copy of the port pair whose fake lost one
    router-called route is reported as fake drift, naming that route."""
    for rel in (PORT_PAIR["ENGINE_FILE"], PORT_PAIR["FAKE_FILE"]):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(REPO / rel, tmp_path / rel)
    shutil.copytree(REPO / PORT_PAIR["ROUTER_DIR"], tmp_path / PORT_PAIR["ROUTER_DIR"],
                    ignore=shutil.ignore_patterns("__pycache__"))
    fake = tmp_path / PORT_PAIR["FAKE_FILE"]
    lines = fake.read_text().splitlines(keepends=True)
    kept = [ln for ln in lines if f'("{route}",' not in ln]
    assert len(kept) == len(lines) - 1, route
    roots = ["production_stack_tpu_torch"]
    assert gc005_endpoints.check(core.RepoIndex(tmp_path, roots)) == []  # nothing deleted yet
    fake.write_text("".join(kept))
    findings = gc005_endpoints.check(core.RepoIndex(tmp_path, roots))
    assert [f.detail for f in findings] == [f"fake-missing:{route}"]
    violations, _ = core.run_graftcheck(tmp_path, roots, baseline=[], checkers=[gc005_endpoints])
    assert [f.key for f in violations] == [f"GC005:{PORT_PAIR['FAKE_FILE']}:<routes>:fake-missing:{route}"]
