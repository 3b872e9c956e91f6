"""The harness around the driver: the result's line, the refusals, the
look-ups by name, and that nothing of perfbench imports JAX or the JAX
package."""
import ast
import json
import re
import shutil
import subprocess
import sys

import pytest

from perfbench import run as bench_run
from perfbench.harness import spec
from perfbench.tests import tiny

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_nothing_imports_jax_or_the_jax_package():
    for path in spec.PERFBENCH.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in bench_run.FORBIDDEN, (path, n)


def test_forbidden_modules_compare_whole_top_level_names():
    assert bench_run.forbidden_modules(["repro_torch.models", "numpy", "jaxtyping"]) == []
    assert bench_run.forbidden_modules(["repro.core.api", "jaxlib.xla", "flax"]) == [
        "flax", "jaxlib", "repro"]


def run_cli(cwd, *extra):
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload", "dsv3.chat.c1",
                           "--seed", "1", "--seconds", "1", "--trace", "0", *extra],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    r = run_cli(spec.ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.PERFBENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = run_cli(tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_benchmark_json_names_and_files():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = {w["name"]: w for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert all(c in cells for c in m.get("workloads", []))
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for c in m.get("workloads", cells):
            assert c in e2e[m["moves"]].get("workloads", cells), (m["name"], c)
            mix = cells[c]["traffic"]
            assert (spec.PERFBENCH / "metrics" / f"{spec.quantity(m['name'], mix)}.py").is_file()
    for c in BENCH["configs"]:
        assert (spec.ROOT / c["file"]).is_file() and NAME.match(c["name"])
    for name, w in cells.items():
        assert NAME.match(name) and w["chips"] in (1, 4) and len(w["why"]) <= 200
        mix = spec.traffic(w["traffic"])
        assert (spec.PERFBENCH / "drivers" / f"{mix['driver']}.py").is_file()
        assert "mean_logit_gap" in spec.limits(name)
        b = spec.Bench()
        assert len(b.metrics_of(name, "end_to_end")) >= 2
        assert b.metrics_of(name, "per_layer")
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(1, len(cells) // 4)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.fixture(scope="module")
def traced():
    return tiny.run("jamba.docqa.c1", seconds=5.0, trace=True)


def test_the_result_line_has_the_keys_in_order(traced):
    b = tiny.bench()
    e2e = bench_run.collect(b, "jamba.docqa.c1", "docqa", traced, trace=False)
    assert set(e2e) == {m["name"] for m in b.metrics_of("jamba.docqa.c1", "end_to_end")}
    line = bench_run.result_line(traced, e2e, trace=False)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    assert line["correct"] is True and line["attempted"] > 0
    json.dumps(line)


def test_readers_leave_out_what_they_cannot_read(traced):
    """On the CPU there is no device trace: every device reader finds
    nothing and returns None (never 0); the host-clock readers read."""
    got = bench_run.collect(tiny.bench(), "jamba.docqa.c1", "docqa", traced, trace=True)
    assert {"admit_wave_ms.p50.docqa", "decode_wave_ms.p50.docqa"} <= set(got)
    for name in ("idle_share.serve.docqa", "moe_gmm_roofline.serve.docqa",
                 "flash_decode_roofline.serve.docqa", "mfu.serve.docqa"):
        assert name not in got
