"""The port's hntlint (``repro_torch.analysis``): its engine held to the
JAX package's (``repro.analysis``, stdlib-only, so no JAX is needed), one
planted violation and one clean twin per rule, the repo gate over the
port, the CLI, and a violation planted in a copy of the real planner.

Fixtures are written inline under ``tmp_path``; the JAX linter's corpus
(``tests/lint_corpus/``) is read, never edited.  A fixture reaches the
data-plane rules (H003, H005) by registering its runner with
``register_scan_plane``, as the port's ScanPlane registry does.
"""
import json
import os
import shutil
import textwrap

import pytest

from repro.analysis import (analyze_paths as ref_analyze,
                            collect_files as ref_collect_files,
                            split_by_baseline as ref_split)
from repro.analysis.engine import collect_pragmas as ref_collect_pragmas
from repro_torch.analysis import (analyze_paths, collect_files, load_baseline,
                                  split_by_baseline)
from repro_torch.analysis import callgraph, rules
from repro_torch.analysis.__main__ import main
from repro_torch.analysis.baseline import DEFAULT_BASELINE
from repro_torch.analysis.engine import (Finding, collect_pragmas,
                                         load_project)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "tests", "lint_corpus")
PORT = os.path.join(REPO, "src", "repro_torch")
GATE = [PORT, os.path.join(REPO, "chip_smoke.py"),
        os.path.join(REPO, "examples")]


@pytest.fixture(autouse=True)
def _at_repo_root(monkeypatch):
    """Paths in findings and the baseline are relative to the repo root."""
    monkeypatch.chdir(REPO)


@pytest.fixture(scope="module")
def gate_findings():
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        return analyze_paths(GATE)
    finally:
        os.chdir(cwd)


# ----------------------------------------------------- engine vs the reference

PRAGMA_SOURCES = {
    "variants": ("A = 1  # hntlint: ok H004\n"
                 "B = 2  # hntlint: ok H004, H006\n"
                 "C = 3  # hntlint: ok\n"
                 "D = 4  # a normal comment\n"),
    "case_and_spacing": ("X = 1  #HNTLINT: OK h003 h005\n"
                         "Y = 2  # hntlint:ok\n"
                         "Z = 3  # hntlint: okay H004\n"
                         "W = 4  # hntlint: ok H004,H007\n"),
    "broken_source": "s = '''\n# hntlint: ok H004\n",
}


@pytest.mark.parametrize("name", sorted(PRAGMA_SOURCES))
def test_collect_pragmas_matches_reference(name):
    src = PRAGMA_SOURCES[name]
    assert collect_pragmas(src) == ref_collect_pragmas(src)


def test_pragma_variants_parse_as_documented():
    pragmas = collect_pragmas(PRAGMA_SOURCES["variants"])
    assert pragmas == {1: {"H004"}, 2: {"H004", "H006"}, 3: {"*"}}


@pytest.mark.parametrize("paths", [
    ["tests"], ["src/repro_torch"], ["tests/lint_corpus/h001_pos.py"],
    ["tests/lint_corpus"], ["src/repro_torch/core", "src/repro_torch"],
], ids=["tests", "port", "explicit_file", "corpus_dir", "overlap"])
def test_collect_files_matches_reference(paths):
    got = collect_files(paths)
    assert got == ref_collect_files(paths)
    if paths == ["tests"]:
        assert got and not any("lint_corpus" in f for f in got)


def test_split_by_baseline_matches_reference():
    fs = [Finding("H004", "a.py", 3, 0, "m", "sentinel:<module>:3e+38"),
          Finding("H006", "b.py", 9, 0, "m", "axes-key:x"),
          Finding("H004", "a.py", 7, 4, "m", "sentinel:f:3e+38")]
    entries = [{"rule": "H004", "path": "a.py",
                "key": "sentinel:<module>:3e+38", "reason": "r"},
               {"rule": "H005", "path": "c.py", "key": "item", "reason": "r"}]
    assert split_by_baseline(fs, entries) == ref_split(fs, entries)
    new, old, stale = split_by_baseline(fs, entries)
    assert [f.key for f in old] == ["sentinel:<module>:3e+38"]
    assert len(new) == 2 and stale == [entries[1]]


@pytest.mark.parametrize("polarity", ["pos", "neg"])
def test_h004_on_the_reference_corpus_matches(polarity):
    path = os.path.join(CORPUS, f"h004_{polarity}.py")
    ours = [(f.rule, f.line, f.col) for f in analyze_paths([path])]
    theirs = [(f.rule, f.line, f.col) for f in ref_analyze([path])]
    assert ours == theirs
    assert len(ours) == (2 if polarity == "pos" else 0)


def test_h002_has_no_counterpart():
    assert "H002" in rules.NOT_APPLICABLE
    for path in (os.path.join(CORPUS, "h002_pos.py"),
                 os.path.join(CORPUS, "h002_neg.py")):
        assert not any(f.rule == "H002" for f in analyze_paths([path]))


# --------------------------------------------------------- one rule, two twins

def _runner(body):
    """A fixture whose functions the walk reaches: imports, then ``body``
    (which registers its runner)."""
    return ("import numpy as np\nimport torch\n"
            "from repro_torch.core.scanplane import register_scan_plane\n"
            + textwrap.dedent(body))


FIXTURES = {
    "H001": (
        """
        import torch
        ZERO = torch.zeros(4)
        IDS = torch.arange(8, dtype=torch.int32)
        ON_CARD = torch.ones(2).cuda()
        FROM_HOST = torch.from_numpy(__import__("numpy").ones(3))
        MOVED = DEV_HOST.to(device="cuda")
        """,
        """
        import torch
        BIG = 3.0e38  # hntlint: ok H004
        DTYPE = torch.float32
        INT_MAX = torch.iinfo(torch.int32).max
        DEV = torch.device("cpu")

        def zeros(n):
            return torch.zeros(n)
        """, 5),
    "H003": (
        _runner("""
        def runner(q, x: torch.Tensor):
            d = torch.cdist(q, q)
            if d.min() > 0:
                pass
            while (x > 0).any():
                x = x - 1
            assert torch.all(d >= 0)
            return x

        register_scan_plane("fixture", "select", runner)
        """),
        _runner("""
        def runner(q, x: torch.Tensor, k: int):
            d = torch.cdist(q, q)
            if d.shape[0] > 0 and x.dim() == 2:
                pass
            if k > 2 and x is not None and d.dtype == torch.float32:
                d = torch.where(d > 0, d, 0.0)
            while len(x) > k:
                k += 1
            return d

        def host_side(x: torch.Tensor):
            if x.sum() > 0:               # not reachable: no finding
                return 1

        register_scan_plane("fixture", "select", runner)
        """), 3),
    "H005": (
        _runner("""
        def runner(q, x: torch.Tensor, m: torch.Tensor):
            d = torch.cdist(q, q)
            a = d.sum().item()
            b = d.tolist()
            c = d.cpu()
            e = int(d[0, 0])
            f = np.asarray(d)
            g = torch.nonzero(d)
            h = x.unique()
            i = torch.masked_select(d, d > 0)
            j = d[d > 0]
            keep = torch.logical_and(x > 0, m)
            d[keep] = x
            k = torch.equal(d, d)
            n = d.to("cpu")
            o = torch.argwhere(x)
            p = torch.where(m)
            r = torch.repeat_interleave(x, m)
            s = max(d.sum(), 0)
            return a, b, c, e, f, g, h, i, j, k, n, o, p, r, s

        register_scan_plane("fixture", "select", runner)
        """),
        _runner("""
        from repro_torch.analysis.sanitize import fetch

        def runner(q, x: torch.Tensor, m: torch.Tensor, rows):
            d = torch.cdist(q, q)
            n = d.numel() + d.shape[0] + x.dim()
            host = fetch(d).numpy()
            top = int(np.asarray(rows).max())
            d = torch.where(d > 0, d, 0.0)
            d[d > 1e6] = 0.0              # a masked fill: no sync
            r = torch.repeat_interleave(x, m, output_size=n)
            s = max(n, top)
            t = torch.from_numpy(np.zeros(3)).numpy()
            return host, d, r, s, t, x[rows]

        def host_side(x: torch.Tensor):
            return x.cpu().item()         # not reachable: no finding

        register_scan_plane("fixture", "select", runner)
        """), 16),
    "H004": (
        """
        NEG_BIG = 3.0e38

        def prune(d):
            return d >= 2.9e38 / 2
        """,
        """
        BIG = 3.0e38  # hntlint: ok H004
        SMALL = 1.0e6

        def prune(d):
            return d >= BIG / 2
        """, 2),
    "H006": (
        """
        import dataclasses
        import torch

        @dataclasses.dataclass(frozen=True)
        class Inner:
            coords: torch.Tensor
            extra: torch.Tensor

        @dataclasses.dataclass(frozen=True)
        class StackedSegments:
            index: Inner
            live: torch.Tensor

        PLANE_FIELD_AXES = {"coords": "grains", "live": "grains",
                            "gone": "grains"}
        """,
        """
        import dataclasses
        from typing import Optional
        import torch

        @dataclasses.dataclass(frozen=True)
        class Inner:
            coords: torch.Tensor
            sketch: Optional[torch.Tensor] = None

        @dataclasses.dataclass(frozen=True)
        class StackedSegments:
            index: Inner
            live: Optional[torch.Tensor] = None
            n: int = 0

        PLANE_FIELD_AXES = {"coords": "grains", "sketch": "grains",
                            "live": "grains"}
        """, 2),
    "H007": (
        """
        import torch

        def f(x: torch.Tensor, m, i, v):
            x.index_put((i,), v)
            x.masked_fill(m, 0.0)
            x.clamp(min=0)
            x.to(torch.float64)
            y = torch.zeros(3)
            y.scatter(0, i, v)

        z = torch.ones(2)  # hntlint: ok H001
        z.index_copy(0, torch.zeros(1, dtype=torch.long), z[:1])
        """,
        """
        import torch

        def f(x: torch.Tensor, m, i, v, model, seen):
            x.index_put_((i,), v)
            x = x.masked_fill(m, 0.0)
            x.clamp_(min=0)
            model.to("cuda")              # a module moves itself
            seen.add(3)
            torch.zeros(3).scatter_(0, i, v)
            return x
        """, 6),
}


def _write(tmp_path, name, src):
    p = tmp_path / name
    p.write_text(textwrap.dedent(src))
    return str(p)


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_rule_catches_its_positive_fixture(rule, tmp_path):
    pos, _, n_min = FIXTURES[rule]
    findings = analyze_paths([_write(tmp_path, "pos.py", pos)])
    hits = [f for f in findings if f.rule == rule]
    assert len(hits) >= n_min, [f.format() for f in findings]
    assert all(f.rule == rule for f in findings), \
        [f.format() for f in findings]


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_rule_passes_its_negative_fixture(rule, tmp_path):
    _, neg, _ = FIXTURES[rule]
    findings = analyze_paths([_write(tmp_path, "neg.py", neg)])
    assert findings == [], [f.format() for f in findings]


def test_h005_names_each_form(tmp_path):
    pos = FIXTURES["H005"][0]
    keys = {f.key.split(":", 2)[2]
            for f in analyze_paths([_write(tmp_path, "pos.py", pos)])}
    assert {"item", "tolist", "cpu", "concretize:int", "np:asarray",
            "shape:nonzero", "shape:unique", "shape:masked_select",
            "equal", "to-host", "shape:argwhere", "shape:where",
            "shape:repeat_interleave", "py-reduce:max"} <= keys
    assert any(k.startswith("shape:mask-index:") for k in keys)


@pytest.mark.parametrize("polarity", ["pos", "neg"])
def test_h004_reads_the_kernel_sources(polarity, tmp_path):
    src = {"pos": "const float kBig = 3.0e38f;\n"
                  "if (d > 3.4e38) { }\n",
           "neg": "// a comment may say 3e38\n"
                  "/* so may\n 3.0e38f a block */\n"
                  "const float kBig = 3.0e38f;  // hntlint: ok H004\n"
                  "float x = 1.0e30f, y = 2e-38f;\n"}[polarity]
    d = tmp_path / "csrc"
    d.mkdir()
    (d / "k.cu").write_text(src)
    findings = analyze_paths([str(tmp_path)])
    if polarity == "neg":
        assert findings == [], [f.format() for f in findings]
    else:
        assert [(f.rule, f.line) for f in findings] == [("H004", 1),
                                                        ("H004", 2)]


def test_pragma_suppresses_on_the_flagged_line(tmp_path):
    bad = _write(tmp_path, "bad.py", "import torch\nT = torch.zeros(3)\n")
    assert [f.rule for f in analyze_paths([bad])] == ["H001"]
    ok = _write(tmp_path, "ok.py",
                "import torch\nT = torch.zeros(3)  # hntlint: ok H001\n")
    assert analyze_paths([ok]) == []


# ------------------------------------------------------------ the repo gate


def test_repo_gate_over_the_port_is_clean(gate_findings):
    """Zero non-baselined findings over the port, chip_smoke.py and the
    examples, and every baseline entry live and explained."""
    entries = load_baseline(DEFAULT_BASELINE)
    assert all(e["reason"].strip() for e in entries)
    new, old, stale = split_by_baseline(gate_findings, entries)
    assert new == [], "\n".join(f.format() for f in new)
    assert stale == [], stale
    assert len(old) == len(entries)


def test_kernel_sources_are_read(gate_findings):
    proj = load_project([PORT])
    assert {os.path.basename(t.path) for t in proj.texts} >= {
        "fused_select.cu", "hntl_scan.cu", "layout_scan.cu"}


def test_every_entry_point_resolves_and_is_reached():
    graph = load_project([PORT]).callgraph
    assert graph.unresolved_roots == []
    reached = {(callgraph.module_of(f.path), f.qualname)
               for f in graph.reachable_funcs()}
    for dotted in callgraph.ENTRY_POINTS:
        mod, name = dotted.rsplit(".", 1)
        assert (mod, name) in reached, dotted
    names = {q for _, q in reached}
    # registered runners: by module attribute, by name, through factories
    assert "blocksoa_scan" in names and "blocksoa_select_ref" in names
    assert "make_cascade_runner.cascade_select" in names
    assert "make_planner_scan_fn.fn" in names
    # host-side maintenance and serving stay out of the walk
    assert "merge_target" not in names
    assert "coalesced_retrieve" not in names
    # the sanctioned read is the walk's boundary
    assert not any(m.endswith("analysis.sanitize") for m, _ in reached)


def _port_copy(tmp_path):
    dst = tmp_path / "src" / "repro_torch"
    shutil.copytree(PORT, dst, ignore=shutil.ignore_patterns(
        "__pycache__", "*.so"))
    return dst


def test_planted_item_in_the_real_planner_is_caught(tmp_path):
    """The gate bites on the real code: a ``.item()`` planted in a copy of
    ``core/planner.py``'s ``search_stacked`` is an H005 finding there."""
    dst = _port_copy(tmp_path)
    clean = {(f.rule, f.key) for f in analyze_paths([str(dst)])}
    planner = dst / "core" / "planner.py"
    src = planner.read_text()
    anchor = "    check_budgets(budgets, topk)\n"
    at = src.index(anchor, src.index("def search_stacked("))
    planner.write_text(src[:at] + "    _ = q.sum().item()\n" + src[at:])
    found = [f for f in analyze_paths([str(dst)])
             if (f.rule, f.key) not in clean]
    assert [(f.rule, f.key) for f in found] == [
        ("H005", "h005:search_stacked:item")]
    assert found[0].path.endswith("repro_torch/core/planner.py")


def test_a_root_that_no_longer_resolves_is_a_finding(tmp_path):
    dst = _port_copy(tmp_path)
    planner = dst / "core" / "planner.py"
    planner.write_text(planner.read_text().replace(
        "def probe_plan(", "def probe_plan_renamed("))
    hits = [f for f in analyze_paths([str(dst)])
            if f.key.startswith("unresolved-root:")]
    assert [f.key for f in hits] == [
        "unresolved-root:repro_torch.core.planner.probe_plan"]


# ----------------------------------------------------------------- the CLI


def test_cli_exit_codes(tmp_path, capsys):
    clean = _write(tmp_path, "clean.py", "X = 1\n")
    dirty = _write(tmp_path, "dirty.py", "NEG = -3.0e38\n")
    assert main([clean]) == 0
    assert main([dirty, "--no-baseline"]) == 1
    assert main([]) == 2                          # no paths: bad invocation
    assert main([clean, "--no-such-flag"]) == 2
    stale = tmp_path / "baseline.json"
    stale.write_text(json.dumps([{"rule": "H004", "path": "gone.py",
                                  "key": "sentinel:<module>:3e+38",
                                  "reason": "fixed long ago"}]))
    assert main([clean, "--baseline", str(stale)]) == 0
    assert main([clean, "--baseline", str(stale),
                 "--strict-baseline"]) == 1
    capsys.readouterr()


def test_cli_gate_over_the_port_exits_clean():
    assert main(["src/repro_torch", "chip_smoke.py", "examples",
                 "--strict-baseline"]) == 0


def test_baseline_entries_need_a_reason(tmp_path):
    bad = tmp_path / "b.json"
    bad.write_text(json.dumps([{"rule": "H004", "path": "a.py",
                                "key": "k", "reason": " "}]))
    with pytest.raises(ValueError, match="reason"):
        load_baseline(str(bad))
