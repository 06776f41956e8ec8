"""The JAX package's pboxlint over the PyTorch port: zero findings.

Every checker runs over ``paddlebox_tpu_torch`` (the lock, flag, metric,
SLO-rule, step-path and race rules, and the serving-path rules PB701 and
PB702, which read the port's ``ps/serving.py``), as
``tests/test_pboxlint.py`` holds the JAX package.  A finding is fixed in
the port or suppressed at its line with the reason the JAX package gives
at the same site (``# pboxlint: disable-next=<code> -- <reason>``).  The
serving rules are shown to reach the port's serving module: the same
source with a frozen-plane write added is flagged.
"""

import os
import re

from paddlebox_tpu.tools.pboxlint import lint_paths, lint_source
from paddlebox_tpu.tools.pboxlint.core import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "paddlebox_tpu_torch")
SERVING = os.path.join(PORT, "ps", "serving.py")


def test_port_has_zero_findings():
    findings, errors = lint_paths([PORT])
    assert errors == []
    assert findings == [], "\n".join(
        f"{f.path}:{f.line}: {f.code} {f.message}" for f in findings)


def test_every_suppression_names_its_code_and_reason():
    """Each ``# pboxlint: disable`` in the port names the codes it
    silences and says why."""
    pat = re.compile(
        r"# pboxlint: disable(-next)?=PB\d{3}(,PB\d{3})* -- \S")
    seen = 0
    for root, _, files in os.walk(PORT):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(root, name), encoding="utf-8") as f:
                for n, text in enumerate(f, 1):
                    if "pboxlint: disable" in text:
                        seen += 1
                        assert pat.search(text), f"{name}:{n}: {text}"
    assert seen > 0


def test_cli_exits_zero_on_the_port(capsys):
    assert main([PORT]) == 0
    capsys.readouterr()


def test_serving_rules_read_the_ports_serving_module():
    """PB702 over the port's ``ps/serving.py`` as it is: silent; with an
    in-place write to a frozen plane outside ``__init__`` appended: one
    PB702 finding at that line."""
    with open(SERVING, encoding="utf-8") as f:
        src = f.read()
    path = os.path.relpath(SERVING, REPO)
    assert [f for f in lint_source(src, path=path)
            if f.code in ("PB701", "PB702")] == []
    bad = src + (
        "\n\nclass _Patch:\n"
        "    def hot_patch(self, tab, pos, rows):\n"
        "        tab._soa['show'][pos] = rows\n")
    line = bad.count("\n")
    found = [f for f in lint_source(bad, path=path) if f.code == "PB702"]
    assert [f.line for f in found] == [line]
