"""The reference's own PopPy core tests, run against the port.

Each ``tests/test_core_*.py``, ``test_speculation.py`` and
``test_durability.py`` states a behaviour of ``repro.core`` and
``repro.durability``; the same files, with their ``repro.core``,
``repro.durability``, ``repro.dispatch`` and ``repro.obs`` imports pointed at
``repro_torch``, must pass against the port.  One pytest process runs every
copy (the reference's run is the files themselves); each reference test
function is a case here, held to have passed in every one of its
parametrisations, with as many of them as the reference collects.

Two reference tests are not about the core and stay with the reference:
``test_core_extended.py::test_int8_kv_cache_model`` runs the JAX package's
qwen3-14b, and ``test_durability.py::test_kill_resume_subprocess`` runs the
reference's ``benchmarks/fig17_durability.py`` in a child process.
"""

import ast
import collections
import os
import pathlib
import re
import subprocess
import sys
import xml.etree.ElementTree as ET

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
TESTS = ROOT / "tests"
FILES = sorted(TESTS.glob("test_core_*.py")) + [
    TESTS / "test_speculation.py", TESTS / "test_durability.py"]
HELPERS = [TESTS / "helpers_core.py"]
NOT_CORE = {("test_core_extended.py", "test_int8_kv_cache_model"),
            ("test_durability.py", "test_kill_resume_subprocess")}


def to_port(src):
    """A reference test file's source with its imports on the port."""
    src = re.sub(r"\brepro\.(core|durability|dispatch|obs)\b",
                 r"repro_torch.\1", src)
    return src.replace("from tests.test_core_batching",
                       "from test_core_batching")


def _test_functions(path):
    """The test functions of a file, a method as ``Class::method``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []
    for n in tree.body:
        if isinstance(n, ast.FunctionDef) and n.name.startswith("test_"):
            out.append(n.name)
        elif isinstance(n, ast.ClassDef) and n.name.startswith("Test"):
            out += [f"{n.name}::{m.name}" for m in n.body
                    if isinstance(m, ast.FunctionDef)
                    and m.name.startswith("test_")]
    return out


CASES = [(p.name, fn) for p in FILES for fn in _test_functions(p)
         if (p.name, fn) not in NOT_CORE]


def _by_function(xml_path):
    """{(file, function): [outcome, ...]} of a junit report, one outcome
    a parametrisation."""
    out = collections.defaultdict(list)
    for case in ET.parse(xml_path).getroot().iter("testcase"):
        module, _, cls = case.get("classname").partition(".")
        fn = case.get("name").split("[", 1)[0]
        file, fn = module + ".py", f"{cls}::{fn}" if cls else fn
        kinds = {c.tag for c in case}
        out[(file, fn)].append("failed" if kinds & {"failure", "error"}
                               else "skipped" if "skipped" in kinds
                               else "passed")
    return out


def _pytest(args, cwd, env):
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-p", "no:xdist", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=280)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference collection, port outcomes): the reference files
    collected where they are, and their port copies run once."""
    port = tmp_path_factory.mktemp("port_suites")
    for p in FILES + HELPERS:
        (port / p.name).write_text(to_port(p.read_text()))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    deselect = [a for f, fn in sorted(NOT_CORE)
                for a in ("--deselect", f"{f}::{fn}")]
    xml = port / "report.xml"
    proc = _pytest([*deselect, f"--junitxml={xml}", "."], port, env)
    assert xml.exists(), proc.stdout[-3000:] + proc.stderr[-3000:]
    ref_env = dict(env, PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(TESTS), env["PYTHONPATH"]]))
    ref = _pytest(["--collect-only", *[str(p) for p in FILES]], TESTS,
                  ref_env)
    collected = collections.Counter()
    for line in ref.stdout.splitlines():
        if "::" in line:
            file, fn = line.split("[", 1)[0].split("::", 1)
            collected[(pathlib.Path(file).name, fn)] += 1
    assert collected, ref.stdout[-3000:] + ref.stderr[-3000:]
    return collected, _by_function(xml), proc.stdout


def test_every_reference_file_is_covered():
    assert len(FILES) >= 14 and all(p.exists() for p in FILES)
    assert len(CASES) > 150
    for file, fn in NOT_CORE:
        assert fn in _test_functions(TESTS / file)


@pytest.mark.parametrize("file,fn", CASES,
                         ids=[f"{f[:-3]}::{fn}" for f, fn in CASES])
def test_reference_case_passes_on_the_port(runs, file, fn):
    collected, outcomes, log = runs
    got = outcomes.get((file, fn), [])
    assert got, f"{file}::{fn} did not run on the port\n{log[-2000:]}"
    assert len(got) == collected[(file, fn)], (
        f"{file}::{fn}: {len(got)} cases on the port, "
        f"{collected[(file, fn)]} in the reference")
    bad = [o for o in got if o != "passed"]
    assert not bad, f"{file}::{fn}: {bad} on the port\n{log[-3000:]}"


def test_copies_import_only_the_port():
    for p in FILES + HELPERS:
        src = to_port(p.read_text())
        assert not re.search(r"\brepro\.(core|durability|dispatch|obs)\b",
                             src), p.name
