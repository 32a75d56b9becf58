"""
The torch port's planner copy against the JAX package's planner.

The port carries its own copy of ``make_plan`` (it cannot import the JAX
package on a machine without jax); both must build the identical plan
from the same inputs: integers exactly, floats bit for bit, on every
field the port's plan has. These tests hold the copy's numpy path (the
native engine switched off); ``tests/test_torch_native.py`` holds the
engine to it.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ska_sdp_cip_tpu.io.synth import synthetic_uvw
from ska_sdp_cip_tpu.ops import plan as jax_plan
from ska_sdp_cip_tpu_torch import native as torch_native
from ska_sdp_cip_tpu_torch.ops import plan as torch_plan

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def numpy_planner(monkeypatch):
    """The port's planner on its numpy path."""
    monkeypatch.setattr(torch_native, "available", lambda: False)


def _inputs():
    uvw, _ = synthetic_uvw(4, 16, max_baseline_m=4000.0, seed=7)
    freqs = np.linspace(1.4e9, 1.5e9, 3)
    pixel = float(np.sin(np.radians(20.0 / 3600.0)))
    return uvw, freqs, pixel


def _assert_fields_equal(ours, ref):
    # The port's plan carries every field of the reference's except the
    # ones only the TPU strip kernels read.
    port_names = {f.name for f in dataclasses.fields(ours)}
    ref_names = {f.name for f in dataclasses.fields(ref)}
    assert port_names <= ref_names
    assert ref_names - port_names == torch_plan.COUNTERPART_ONLY_FIELDS
    for field in dataclasses.fields(ours):
        a = getattr(ours, field.name)
        b = getattr(ref, field.name)
        if b is None:
            assert a is None, field.name
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, field.name
            np.testing.assert_array_equal(a, b, err_msg=field.name)
        else:
            assert type(a) is type(b) and a == b, field.name


@pytest.mark.parametrize(
    "kwargs",
    [
        {"do_wstacking": True},
        {"do_wstacking": False},
        {"do_wstacking": True, "export_packed": False, "sigma": 1.5},
    ],
    ids=["wstack", "no_wstack", "compact_sigma1.5"],
)
def test_make_plan_matches_jax(kwargs):
    uvw, freqs, pixel = _inputs()
    ref = jax_plan.make_plan(uvw, freqs, 256, pixel, **kwargs)
    ours = torch_plan.make_plan(uvw, freqs, 256, pixel, **kwargs)
    _assert_fields_equal(ours, ref)


def test_plan_from_fields_round_trip():
    uvw, freqs, pixel = _inputs()
    ref = jax_plan.make_plan(uvw, freqs, 256, pixel)
    ours = torch_plan.plan_from_fields(dataclasses.asdict(ref))
    assert isinstance(ours, torch_plan.GridderPlan)
    _assert_fields_equal(ours, ref)
    assert ours.num_vis == ref.num_vis
    assert ours.num_groups == ref.num_groups
    with pytest.raises(ValueError, match="unknown"):
        torch_plan.plan_from_fields({**dataclasses.asdict(ref), "bogus": 1})
    fields = dataclasses.asdict(ref)
    del fields["ngrid"]
    with pytest.raises(ValueError, match="missing"):
        torch_plan.plan_from_fields(fields)
