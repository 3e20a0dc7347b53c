"""dynalint as a gate over the port: ``analyze_paths(["dynamo_tpu_torch"])``
reports nothing, with no baseline (the JAX tree's gate,
``tests/test_dynalint.py``, runs against an empty one).

Every rule runs over the port, but two registry scopes name JAX paths
only, so what they select by path is never selected in the port:
``HOT_PATH_PATHS`` (DYN601's every-function scope; its named functions
still match) and ``DETERMINISTIC_CORE_PATHS`` (DYN603's module scope; its
class names still match).  ROADMAP.md lists them.
"""

from pathlib import Path

import pytest

from tools.dynalint import analyze_paths
from tools.dynalint.core import collect_files

REPO_ROOT = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.torch_port


def test_the_port_lints_clean():
    findings = analyze_paths(["dynamo_tpu_torch"], root=REPO_ROOT)
    assert [f"{f.path}:{f.line} {f.rule} {f.message}" for f in findings] == []


def test_the_gate_reads_every_module_of_the_port():
    files = {p.resolve() for p in collect_files(["dynamo_tpu_torch"], REPO_ROOT)}
    modules = {p.resolve() for p in (REPO_ROOT / "dynamo_tpu_torch").rglob("*.py")}
    assert modules and files == modules
