"""
The port's span recorder (``ska_sdp_cip_tpu_torch/utils/task_metrics.py``)
on the CPU:

* off (no ``tracing()``, no profiler), a span is one shared null
  context and ``dirty_image`` leaves no record and no counter;
* inside ``tracing()``, a tiny ``dirty_image`` and a major-cycle step
  (``residual_gradient`` and ``hogbom_clean``) record each span once (a
  plane group's once per group), with the right parent and root ids;
  self time is duration less children; the plan counters equal the
  plan's, ``h2d_bytes`` the uploaded arrays' bytes, and
  ``useful_visits`` a per-slot count of the plane groups each real
  slot's w-kernel touches;
* under ``torch.profiler`` the recorder is on, and the spans' ``cip.*``
  ranges are host events only;
* ``TaskRecorder.step`` keeps its schema and opens a span;
* the mesh's collective calls and bytes are counted with the recorder
  on or off, and timed only while it is on;
* a sharded Hogbom step records ``sharded.step`` around the minor cycle
  and ``sharded.residual`` (device), with the image psum's
  ``collective.all_reduce`` inside it, and counts ``shard_visibilities``
  and ``useful_visits`` once a residual.
"""

import json

import numpy as np
import pytest
import torch

from ska_sdp_cip_tpu_torch.io.synth import synthetic_uvw
from ska_sdp_cip_tpu_torch.models.clean import build_major_cycle_step
from ska_sdp_cip_tpu_torch.models.operators import MeasurementOperator
from ska_sdp_cip_tpu_torch.ops import gridder
from ska_sdp_cip_tpu_torch.ops.plan import make_plan
from ska_sdp_cip_tpu_torch.utils import staging, task_metrics
from ska_sdp_cip_tpu_torch.utils.task_metrics import (
    SCHEMA_KEYS,
    TaskRecorder,
    span,
    tracing,
)

torch.set_num_threads(1)

NPIX = 128
PIXEL_LM = float(np.sin(np.radians(120.0 / 3600.0)))
FREQS = np.array([1.30e9, 1.35e9, 1.40e9, 1.45e9])

IMAGE_SPANS = {
    # name: parent name (None for the root)
    "image": None,
    "plan": "image",
    "weight": "image",
    "stage": "image",
    "stage.host_arrays": "stage",
    "stage.upload": "stage",
    "stage.assemble": "stage",
    "invert": "image",
    "invert.work_lists": "stage.host_arrays",
    "invert.taper": "invert",
    "invert.group": "invert",
    "download": "image",
}


@pytest.fixture
def recorder():
    task_metrics.reset()
    yield task_metrics.RECORDER
    task_metrics.reset()


@pytest.fixture(scope="module")
def observation():
    uvw, _ = synthetic_uvw(6, 12, max_baseline_m=4000.0, seed=11)
    rng = np.random.default_rng(5)
    shape = (len(uvw), len(FREQS))
    vis = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)
    weights = rng.uniform(0.5, 2.0, size=shape).astype(np.float32)
    return uvw, vis, weights


def _dirty(observation):
    uvw, vis, weights = observation
    return gridder.dirty_image(uvw, FREQS, vis, weights, NPIX, PIXEL_LM,
                               device="cpu")


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def _check_tree(records, expected):
    """Each span of ``expected`` once (groups: once per group), under
    its parent, all sharing the root's id."""
    by_name = _by_name(records)
    (root,) = (by_name[n][0] for n, p in expected.items() if p is None)
    for name, parent in expected.items():
        if name != "invert.group":
            assert len(by_name[name]) == 1, name
        for r in by_name[name]:
            assert r.root == root.id, name
            if parent is None:
                assert r.parent is None and r.id == root.id
            else:
                assert r.parent == by_name[parent][0].id, name
            assert r.start_ns <= r.end_ns
    return by_name


def test_off_records_nothing(recorder, observation):
    assert not task_metrics.enabled()
    assert span("image") is span("plan", device=True)
    with span("image") as record:
        assert record is None
    task_metrics.count("visibilities", 7)
    _dirty(observation)
    assert recorder.records == [] and recorder.counters == {}


def test_dirty_image_spans_and_counters(recorder, observation):
    uvw, vis, weights = observation
    with tracing():
        assert task_metrics.enabled()
        image = _dirty(observation)
    assert not task_metrics.enabled()
    by_name = _check_tree(recorder.records, IMAGE_SPANS)
    assert set(by_name) == set(IMAGE_SPANS)

    plan = make_plan(uvw, FREQS, NPIX, PIXEL_LM, export_packed=False)
    assert plan.nplanes > plan.support  # slots whose kernels miss groups
    assert len(by_name["invert.group"]) == plan.num_groups
    counters = recorder.counters
    assert counters["visibilities"] == plan.num_vis_data == vis.size
    assert counters["slots"] == plan.num_vis
    assert counters["planes"] == plan.nplanes
    assert counters["groups"] == plan.num_groups
    lists = gridder.work_lists(plan, invert=True)
    blocks = [len(ids) for ids in lists["blocks"]]
    assert counters["active_blocks"] == sum(blocks)
    assert counters["slot_visits"] == sum(blocks) * plan.block
    assert counters["b1_chunks"] == sum(len(c) for c in lists["grid"])

    host = gridder.compact_plan_host_arrays(plan, uvw, FREQS, "cpu")
    weighted = (vis * weights).astype(np.complex64).ravel()
    host["re"], host["im"] = weighted.real, weighted.imag
    uploaded = [staging._host_array(v) for v in host.values()
                if not isinstance(v, int)]
    assert counters["h2d_bytes"] == sum(a.nbytes for a in uploaded)
    assert counters["h2d_copies"] == len(uploaded)
    assert counters["d2h_bytes"] == image.nbytes

    totals = task_metrics.summary()["spans"]
    for name in ("image", "stage", "invert"):
        (r,) = by_name[name]
        children = sum(c.end_ns - c.start_ns for c in recorder.records
                       if c.parent == r.id)
        assert totals[name]["self_s"] == pytest.approx(
            (r.end_ns - r.start_ns - children) / 1e9)
        assert 0 <= totals[name]["self_s"] < totals[name]["host_s"]
    # Device spans fall back to the host clock without a card.
    for name in ("invert.taper", "stage.assemble"):
        assert totals[name]["device_s"] == pytest.approx(
            totals[name]["host_s"])
    assert "device_s" not in totals["plan"]


def _reference_useful_visits(plan) -> int:
    """Per real slot, the plane groups among its W planes [q, q + W)."""
    ws = plan.packed[2] if plan.packed is not None else plan.ws
    origin = plan.w0 + (plan.support / 2 - 1) * plan.dw
    total = 0
    for slot in np.flatnonzero(plan.order < plan.num_vis_data):
        q = int(np.floor((float(ws[slot]) - origin) / plan.dw))
        q = min(max(q, 0), plan.nplanes - 1)
        planes = range(q, min(q + plan.support, plan.nplanes))
        total += len({p // plan.plane_group for p in planes})
    return total


def test_gradient_and_minor_spans(recorder, observation):
    uvw, vis, weights = observation
    op = MeasurementOperator.build(uvw, FREQS, weights, NPIX, PIXEL_LM,
                                   device="cpu")
    slots = op.stage(vis)
    step = build_major_cycle_step(op, gain=0.1, minor_iter=5)
    model = torch.zeros((NPIX, NPIX))
    task_metrics.reset()
    with tracing():
        step(model, slots.re, slots.im)
    gradient = {"gradient": None, "predict": "gradient",
                "predict.taper": "predict", "residual": "gradient",
                "invert": "gradient", "invert.taper": "invert",
                "invert.group": "invert"}
    records = recorder.records
    minor = [r for r in records if r.name == "minor"]
    assert len(minor) == 1 and minor[0].parent is None
    assert minor[0].root == minor[0].id
    by_name = _check_tree([r for r in records if r.name != "minor"],
                          gradient)
    assert set(by_name) == set(gradient)
    assert len(by_name["invert.group"]) == op.plan.num_groups

    counters = recorder.counters
    assert counters["minor_iterations"] == 5
    blocks = [len(ids) for ids in gridder.work_lists(op.plan)["blocks"]]
    assert counters["slot_visits"] == sum(blocks) * op.plan.block
    useful = _reference_useful_visits(op.plan)
    assert counters["useful_visits"] == useful
    assert 0 < useful < counters["slot_visits"]
    # Cached on the plan: a second traced step counts the same again.
    with tracing():
        step(model, slots.re, slots.im)
    assert recorder.counters["useful_visits"] == 2 * useful


def test_profiler_turns_it_on_with_host_ranges(recorder, observation):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert task_metrics.enabled()
        _dirty(observation)
    assert not task_metrics.enabled()
    assert {r.name for r in recorder.records} == set(IMAGE_SPANS)
    ranges = [e for e in prof.events() if e.name.startswith("cip.")]
    names = {e.name[len("cip."):] for e in ranges}
    assert names == set(IMAGE_SPANS)
    assert all(e.device_type == DeviceType.CPU for e in ranges)
    assert not any(e.is_user_annotation for e in ranges)


def test_task_recorder_step_opens_a_span(recorder):
    steps = TaskRecorder(worker="test")
    with tracing():
        with steps.step("load_shards"):
            with span("inner"):
                pass
    (task,) = steps.tasks
    assert tuple(task) == SCHEMA_KEYS
    assert task["key"] == "load_shards-000000"
    assert task["name"] == "load_shards" and task["status"] == "OK"
    outer, inner = sorted(recorder.records, key=lambda r: r.id)
    assert outer.name == "load_shards" and inner.parent == outer.id
    with steps.step("plan_shards"):
        pass
    assert len(steps.tasks) == 2 and len(recorder.records) == 2


def test_collective_counts_with_the_recorder_on_or_off(recorder):
    from ska_sdp_cip_tpu_torch.parallel.mesh import make_device_mesh

    mesh = make_device_mesh(2, device="cpu")
    parts = [torch.ones((4, 3)), torch.ones((4, 3))]

    def run():
        mesh.reset_stats()
        mesh.psum([p.clone() for p in parts])
        mesh.all_to_all(parts)
        mesh.allgather_max(np.array([1, 2]))
        return mesh.collective_stats()

    off = run()
    with tracing():
        on = run()
    expected_calls = {"all_reduce": 1, "all_to_all": 1, "host_allgather": 1}
    assert off["calls"] == on["calls"] == expected_calls
    assert off["bytes"] == on["bytes"] == {
        "all_reduce": 48, "all_to_all": 96, "host_allgather": 16}
    assert off["seconds"] == {} and off["total_seconds"] == 0.0
    assert set(on["seconds"]) == set(expected_calls)
    assert on["total_seconds"] == pytest.approx(sum(on["seconds"].values()))
    names = sorted(r.name for r in recorder.records)
    assert names == ["collective.all_reduce", "collective.all_to_all",
                     "collective.host_allgather"]
    assert recorder.counters["collective.all_to_all.bytes"] == 96
    assert recorder.counters["collective.host_allgather.calls"] == 1


def test_sharded_step_spans_and_counters(recorder, observation):
    from ska_sdp_cip_tpu_torch.invert import StokesIGridderInput
    from ska_sdp_cip_tpu_torch.parallel.mesh import make_device_mesh
    from ska_sdp_cip_tpu_torch.parallel.sharded_clean import (
        ShardedOperator,
        build_sharded_major_cycle_step,
    )
    from ska_sdp_cip_tpu_torch.parallel.sharded_invert import (
        stage_loaded_shards,
    )

    uvw, vis, weights = observation
    mesh = make_device_mesh(2, device="cpu")
    shards = {i: StokesIGridderInput(
        channel_frequencies=FREQS[2 * i:2 * i + 2],
        flags=np.zeros((len(uvw), 2), bool), uvw=uvw,
        visibilities=vis[:, 2 * i:2 * i + 2],
        weights=weights[:, 2 * i:2 * i + 2]) for i in range(2)}
    staged = stage_loaded_shards(shards, vis.size, NPIX, 120.0, mesh=mesh)
    op = ShardedOperator(staged, "replicated")
    step = build_sharded_major_cycle_step(op, gain=0.1, minor_iter=5)
    model = torch.zeros((NPIX, NPIX))
    residual = op.dirty()
    task_metrics.reset()
    mesh.reset_stats()
    with tracing():
        step(model, residual)
    by_name = _by_name(recorder.records)
    (root,) = by_name["sharded.step"]
    assert root.parent is None and root.device is False
    (residual_span,) = by_name["sharded.residual"]
    assert residual_span.parent == root.id and residual_span.device
    (minor,) = by_name["minor"]
    assert minor.parent == root.id
    (psum,) = by_name["collective.all_reduce"]
    # A host span on a CPU mesh, a device span on a card's.
    assert psum.parent == residual_span.id and not psum.device
    for name in ("predict.taper", "invert.taper", "invert.group"):
        assert by_name[name]
        assert all(r.root == root.id for r in by_name[name]), name
    counters = recorder.counters
    assert counters["shard_visibilities"] == vis.size
    assert counters["useful_visits"] == sum(
        _reference_useful_visits(plan) for plan in staged.plans)
    assert counters["collective.all_reduce.calls"] == 1
    assert counters["collective.all_reduce.bytes"] == NPIX * NPIX * 4
    assert mesh.collective_stats()["calls"] == {"all_reduce": 1}
    summary = task_metrics.summary()["spans"]
    assert summary["sharded.residual"]["device_s"] > 0


def test_spans_json(recorder, observation, tmp_path):
    with tracing():
        _dirty(observation)
    path = tmp_path / "spans.json"
    task_metrics.save_spans_json(path)
    saved = json.loads(path.read_text())
    assert set(saved) == {"spans", "counters", "records"}
    assert saved["spans"]["image"]["count"] == 1
    assert saved["counters"] == recorder.counters
    assert len(saved["records"]) == len(recorder.records)
    assert {"name", "id", "parent", "root", "host_s", "device_s"} <= set(
        saved["records"][0])


def test_profile_dir_writes_spans_beside_the_trace(recorder, dataset_path,
                                                   tmp_path):
    from ska_sdp_cip_tpu_torch.apps import pipeline_app

    prof = tmp_path / "prof"
    pipeline_app.run_program([str(dataset_path), str(tmp_path / "img.npy"),
                              "-n", "64", "-p", "30.0", "--device", "cpu",
                              "--profile-dir", str(prof)])
    assert not task_metrics.enabled()
    saved = json.loads((prof / "spans.json").read_text())
    assert saved["spans"]["read"]["count"] == 1
    assert saved["spans"]["image"]["count"] == 1
    assert saved["counters"]["visibilities"] > 0
    roots = {r["root"] for r in saved["records"] if r["name"] != "read"}
    assert len(roots) == 1
    trace = json.loads((prof / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"cip.read", "cip.image", "cip.invert.taper"} <= names
