"""A configuration, a traffic mix and a per-layer metric are new files,
found by the names BENCHMARK.json gives them; no file of the benchmark
that is there is edited."""

from __future__ import annotations

import json

import torch

from cipbench import run


def test_new_files_are_found(tiny_root):
    here = tiny_root / "cipbench"
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}

    cfg = json.loads((here / "configs" / "csd3-10k.json").read_text())
    cfg.update(name="csd3-other")
    cfg["imaging"]["num_pixels"] = 48
    (here / "configs" / "csd3-other.json").write_text(json.dumps(cfg))
    (here / "traffic" / "snapshot-every-3rd.json").write_text(json.dumps(
        {"operation": "snapshot", "dump_step": 3, "warmup_calls": 1,
         "check_images": 4, "why": "test"}))
    (here / "limits" / "csd3-other.snapshot-every-3rd.json").write_text(
        json.dumps({"img_err": 1e-4}))
    (here / "metrics" / "calls_n.image.py").write_text(
        "def read(run):\n    return float(len(run.calls))\n")

    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "csd3-other", "source": "test",
                             "file": "cipbench/configs/csd3-other.json",
                             "reduced": [], "why": "test"})
    cell = "csd3-other.snapshot-every-3rd"
    bench["workloads"].append({"name": cell, "config": "csd3-other",
                               "traffic": "snapshot-every-3rd", "chips": 1,
                               "why": "test"})
    image_s = next(m for m in bench["end_to_end"] if m["name"] == "image_s")
    image_s["workloads"].append(cell)
    bench["per_layer"].append({"name": "calls_n.image", "unit": "calls",
                               "better": "higher", "source": "program_span",
                               "layer": "planner", "moves": "image_s",
                               "workloads": [cell]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    loaded = run.load_cell(tiny_root, cell)
    assert loaded.config["imaging"]["num_pixels"] == 48
    assert loaded.traffic["dump_step"] == 3
    result = run.run_cell(loaded, 5, 0.2, True, torch.device("cpu"))
    assert result["correct"]
    assert result["metrics"]["calls_n.image"]["value"] == result["attempted"]
    for path, data in before.items():
        assert path.read_bytes() == data
