"""
The port's host <-> device staging (``utils/staging.py``) on the CPU.

``device_put_parallel``, ``AsyncStager`` and ``stage_arrays`` (which now
goes through them) return what ``stage_arrays`` returned before them:
the same keys, values, dtypes and shapes, Python ints kept as they are
and uint16 widened to int32. On the CPU nothing is pinned and nothing
is copied: each tensor shares its array's memory. ``device_get`` gives
a CPU tensor's values back. The round trips through a card (pinned
downloads) are ``tests/test_torch_cuda.py``'s.
"""

import numpy as np
import pytest
import torch

from ska_sdp_cip_tpu_torch.ops.gridder import stage_arrays
from ska_sdp_cip_tpu_torch.utils import staging

torch.set_num_threads(1)


def _host():
    rng = np.random.default_rng(4)
    return {
        "f32": rng.normal(size=(3, 5)).astype(np.float32),
        "f64": rng.normal(size=7),
        "i32": rng.integers(-9, 9, size=11).astype(np.int32),
        "i64": rng.integers(-9, 9, size=(2, 2)),
        "u16": rng.integers(0, 60000, size=13).astype(np.uint16),
        "u8": rng.integers(0, 255, size=4).astype(np.uint8),
        "bool": rng.uniform(size=6) > 0.5,
        "strided": rng.normal(size=(6, 4)).astype(np.float32)[::2, 1:],
        "big": rng.normal(size=(1 << 20) + 17).astype(np.float32),
        "count": 12,
    }


def _stage_arrays_before(host: dict) -> dict:
    """``ops/gridder.py:stage_arrays`` as it was before the pinned path."""
    staged = {}
    for key, value in host.items():
        if isinstance(value, int):
            staged[key] = value
            continue
        value = np.ascontiguousarray(value)
        if value.dtype == np.uint16:
            value = value.astype(np.int32)
        staged[key] = torch.from_numpy(value).to("cpu")
    return staged


def _assert_same(got: dict, want: dict):
    assert list(got) == list(want)
    for key, value in want.items():
        if isinstance(value, int):
            assert got[key] == value and type(got[key]) is int, key
            continue
        assert got[key].dtype == value.dtype, key
        assert got[key].shape == value.shape, key
        assert got[key].device.type == "cpu", key
        assert not got[key].is_pinned(), key
        assert torch.equal(got[key], value), key


@pytest.mark.parametrize("wait", [False, True])
def test_device_put_parallel_is_stage_arrays(wait):
    host = _host()
    want = _stage_arrays_before(host)
    _assert_same(staging.device_put_parallel(host, "cpu", wait=wait), want)
    _assert_same(stage_arrays(host, "cpu"), want)


def test_cpu_staging_shares_the_arrays():
    host = _host()
    staged = staging.device_put_parallel(host, "cpu")
    assert np.shares_memory(staged["f32"].numpy(), host["f32"])
    assert np.shares_memory(staged["big"].numpy(), host["big"])


def test_async_stager_is_stage_arrays():
    host = _host()
    want = _stage_arrays_before(host)
    with staging.AsyncStager("cpu") as stager:
        first = dict(list(host.items())[:3])
        stager.submit_dict(first)
        for key, value in list(host.items())[3:]:
            stager.submit(key, value)
        one = stager.result("f64")
        got = stager.wait_all()
    _assert_same(got, want)
    assert torch.equal(one, want["f64"])
    with pytest.raises(KeyError):
        stager.result("missing")


def test_device_get_round_trip():
    host = _host()
    staged = staging.device_put_parallel(host, "cpu")
    for key, value in host.items():
        if isinstance(value, int):
            continue
        got = staging.device_get(staged[key])
        want = value.astype(np.int32) if value.dtype == np.uint16 else value
        assert got.dtype == want.dtype and got.shape == want.shape, key
        np.testing.assert_array_equal(got, want, err_msg=key)


def test_device_get_of_a_strided_view():
    base = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    view = base.t()[1:, ::2]
    got = staging.device_get(view)
    assert got.shape == tuple(view.shape)
    np.testing.assert_array_equal(got, base.numpy().T[1:, ::2])


def test_cuda_target_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        staging.device_put_parallel({"x": np.zeros(3)}, "cuda")
