"""The repository's static analysis (``tools/analyze.py``), run over the
PyTorch port: every pass must report zero unsuppressed findings in
``presto_tpu_torch/``, as ``tests/test_static_analysis.py`` holds the
reference to it. Each pass is its own case, so a finding names its
rule; the CLI's exit code over the port is the gate itself."""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "presto_tpu_torch")
sys.path.insert(0, os.path.join(REPO, "tools"))

import analysis  # noqa: E402
import analyze  # noqa: E402


@pytest.fixture(scope="module")
def port_findings():
    """One full-framework run over the port, shared by every case."""
    return analysis.run_passes(PORT)


def test_analyze_cli_exits_clean_over_the_port():
    assert analyze.main([str(PORT)]) == 0


@pytest.mark.parametrize("rule", analysis.all_rules())
def test_rule_clean_over_the_port(port_findings, rule):
    active = [f for f in port_findings if f.active and f.rule == rule]
    assert not active, "\n".join(
        f"{f.path}:{f.line}: [{f.rule}] {f.message}" for f in active
    )


def test_no_parse_errors_in_the_port(port_findings):
    assert not [f for f in port_findings if f.rule == "parse-error"]


def test_every_allowlisted_site_is_justified(port_findings):
    """Every allowlisted blocking site carries its reason."""
    for f in port_findings:
        if f.allowlisted:
            assert f.justification
