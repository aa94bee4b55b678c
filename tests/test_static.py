"""Source-level guards: nothing in the package needs a TPU."""

import ast
import os
import re

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "vampomi_tpu")


def _sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                yield path, open(path).read()


def test_no_tpu_kernels_or_platform_branches():
    """No module imports Pallas's TPU backend or libtpu, and no string
    constant is a TPU platform name (what a platform branch compares)."""
    platform = re.compile(r"^tpu$|pallas\.tpu|libtpu", re.IGNORECASE)
    found = []
    for path, src in _sources():
        tree = ast.parse(src)
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names]
                mod = getattr(node, "module", None) or ""
                if any("pallas.tpu" in f"{mod}.{n}" or "libtpu" in n
                       for n in names) or "pallas.tpu" in mod:
                    found.append((path, node.lineno, "import"))
            elif (isinstance(node, ast.Constant) and isinstance(node.value, str)
                  and platform.search(node.value.strip())):
                found.append((path, node.lineno, node.value))
    assert not found, found
