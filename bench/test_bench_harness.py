"""The harness: cells, mixes and metrics found by name with no edit,
``BENCHMARK.json`` within its contract, the isolation check, and the
command's refusals without a card."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench import harness
from bench.reference import analog_deep, dense_lm

ROOT = Path(__file__).resolve().parent.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_a_new_cell_mix_and_metric_are_found_with_no_edit(tmp_path):
    bench = tmp_path / "bench"
    for sub in ("configs", "traffic", "workloads", "metrics"):
        (bench / sub).mkdir(parents=True)
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "new-cell", "config": "new-config",
                              "traffic": "new-mix", "chips": 1, "why": "x"})
    spec["end_to_end"].append({"name": "new_rate", "unit": "1/s",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["new-cell"]})
    spec["per_layer"].append({"name": "new_layer_ms", "unit": "ms",
                              "better": "lower", "source": "device_trace",
                              "layer": "kernels", "moves": "new_rate"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    (bench / "configs" / "new-config.json").write_text('{"width": 1}')
    (bench / "traffic" / "new-mix.json").write_text('{"driver": "d"}')
    (bench / "workloads" / "new-cell.json").write_text('{"limits": {}}')
    (bench / "metrics" / "new_layer_ms.py").write_text(
        "def read(records):\n    return records.get('x')\n")
    got = harness.cell_spec("new-cell", root=tmp_path)
    assert got["config"] == {"width": 1}
    assert got["traffic"] == {"driver": "d"}
    assert [m["name"] for m in got["end_to_end"]] == ["setup_s", "new_rate"]
    assert [m["name"] for m in got["per_layer"]] == ["new_layer_ms"]
    assert harness.read_metric("new_layer_ms", {"x": 2}, bench) == 2.0
    assert harness.read_metric("new_layer_ms", {}, bench) is None
    with pytest.raises(harness.BenchError):
        harness.cell_spec("no-such-cell", root=tmp_path)


def test_benchmark_json_keeps_its_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"] and SPEC["command"][1] == "bench/run.py"
    names = [c["name"] for c in SPEC["configs"]]
    for c in SPEC["configs"]:
        assert NAME.match(c["name"]) and (ROOT / c["file"]).exists()
        assert c["file"].startswith("bench/")
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["reduced"] == c["reduced"]
        assert body["source"] == c["source"]
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").exists()
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    used = set()
    for w in SPEC["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in names
        assert w["chips"] == 1 and len(w["why"]) <= 200
        used.add(w["config"])
        spec = harness.cell_spec(w["name"])
        e2e = [m["name"] for m in spec["end_to_end"]]
        assert "setup_s" in e2e and len(e2e) >= 2 and spec["per_layer"]
        for m in spec["per_layer"]:
            assert m["moves"] in e2e
    assert used == set(names)
    # a full check of 24 cells at this length fits its 43200 seconds
    n = 24
    assert (2 + 14 * n) * (SPEC["run_seconds"] + 60) + n * 180 + 1200 \
        <= 43200


def test_the_isolation_check_compares_whole_top_level_names(monkeypatch):
    import types

    before = harness.foreign_modules()
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike",
                        types.ModuleType("repro_torch_lookalike"))
    assert harness.foreign_modules() == before
    monkeypatch.setitem(sys.modules, "repro.models",
                        types.ModuleType("repro.models"))
    assert "repro.models" in harness.foreign_modules()


def test_inputs_and_weights_repeat_for_a_large_seed():
    cfg = json.loads((ROOT / "bench/configs/rfnn-deep-64x64-l4.json")
                     .read_text())
    a, b = (analog_deep.make_inputs(cfg, 2**31 + 77) for _ in range(2))
    assert all((x == y).all() for x, y in zip(a["targets"], b["targets"]))
    assert a["keys"] == b["keys"] and a["perms"] == b["perms"]
    small = {"hidden_size": 16, "num_attention_heads": 2,
             "num_key_value_heads": 1, "intermediate_size": 32,
             "num_hidden_layers": 1, "vocab_size": 40,
             "tie_word_embeddings": True}
    p, q = (dense_lm.make_params(small, 2**33 + 1, "cpu") for _ in range(2))
    assert all((p_ == q_).all() for p_, q_ in zip(
        dense_lm.slices(p).values(), dense_lm.slices(q).values()))


def _run(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "bench/run.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


@pytest.mark.parametrize("alone", [False, True],
                         ids=["checkout", "bench-only"])
def test_the_command_refuses_without_a_card_or_a_program(tmp_path, alone):
    """Off the card (and in a directory with only BENCHMARK.json and
    bench/) the command exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cwd = ROOT
    if alone:
        shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
        shutil.copytree(ROOT / "bench", tmp_path / "bench",
                        ignore=shutil.ignore_patterns("__pycache__"))
        cwd = tmp_path
    r = _run(cwd, "--workload", "rfnn64-infer-64k", "--seed", "1",
             "--seconds", "1")
    assert r.returncode != 0
    assert '"correct"' not in r.stdout
