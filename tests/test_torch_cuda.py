"""
The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips unless ``torch.cuda.is_available()``
(decided inside the fixture, never at import). Run them on a machine
with a card: ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py`` (``--noconftest``: the suite's conftest
imports jax, which such a machine need not have).
Tolerances: 1e-5 of the reference's max between a float32 kernel and
its float32 plain version (summation order differs; the gridding
kernel adds with atomics), 1e-4 against the explicit DFT.
"""

import numpy as np
import pytest
import torch

from ska_sdp_cip_tpu_torch.io.synth import synthetic_uvw
from ska_sdp_cip_tpu_torch.ops import cuda_gridder as tcg
from ska_sdp_cip_tpu_torch.ops import fft_cuda as tfc
from ska_sdp_cip_tpu_torch.ops import gridder as tg
from ska_sdp_cip_tpu_torch.ops.dft import dirty_image_dft
from ska_sdp_cip_tpu_torch.ops.fft import fft_plan_arrays, make_fft_plan
from ska_sdp_cip_tpu_torch.ops.plan import make_plan

pytestmark = pytest.mark.cuda

PIXEL = float(np.sin(np.radians(40.0 / 3600)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _small(seed=23):
    rng = np.random.default_rng(seed)
    uvw, _ = synthetic_uvw(3, 10, max_baseline_m=5000.0, seed=seed)
    freqs = np.array([1.0e9, 1.07e9])
    shape = (len(uvw), 2)
    vis = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64
    )
    wgt = rng.uniform(0.5, 2.0, size=shape).astype(np.float32)
    return uvw, freqs, vis, wgt


@pytest.mark.parametrize("wstack", [False, True], ids=["G1", "G2"])
def test_grid_kernel_matches_plain(cuda, wstack):
    uvw, freqs, vis, wgt = _small()
    plan = make_plan(uvw, freqs, 96, PIXEL, do_wstacking=wstack,
                     export_packed=False)
    arrays, re_s, im_s = tg.stage_compact(plan, uvw, freqs, vis * wgt, cuda)
    for k, ids in enumerate(tg.group_active_blocks(plan)):
        args = (
            arrays["packed"], re_s, im_s, arrays["block_len"],
            arrays["cblock_ox"], arrays["block_oy"], arrays["plane_wg"][k],
            arrays["group_blocks"][k, : len(ids)],
        )
        before = tcg.LAUNCHES
        got = tcg.grid_planes(*args, plan=plan)
        torch.cuda.synchronize()
        assert tcg.LAUNCHES == before + 1
        ref = tcg.grid_planes_reference(*args, plan=plan)
        for p in range(ref.shape[0]):
            scale = ref[p].abs().max()
            assert float((got[p] - ref[p]).abs().max() / scale) <= 1e-5


@pytest.mark.parametrize("n,crop,m", [(96, (24, 48), 128), (256, None, 200),
                                      (512, (128, 256), 384)])
def test_fft_kernel_matches_plain(cuda, n, crop, m):
    plan = make_fft_plan(n, shifted=True)
    meta = tfc.fused_pass_meta(plan, crop)
    host = fft_plan_arrays(plan, prefix="fft")
    host.update(tfc.fused_pass_host_arrays(plan, meta, sign=+1,
                                           prefix="fftp"))
    f = tg.stage_arrays(host, cuda)
    rng = np.random.default_rng(n)
    re = torch.from_numpy(rng.normal(size=(n, m)).astype(np.float32)).to(cuda)
    im = torch.from_numpy(rng.normal(size=(n, m)).astype(np.float32)).to(cuda)
    before = tfc.LAUNCHES
    got = tfc.fft_first_axis_fused(re, im, f, meta=meta, sign=+1)
    torch.cuda.synchronize()
    assert tfc.LAUNCHES == before + 1
    ref = tfc.fft_first_axis_reference(re, im, f, meta=meta, sign=+1)
    scale = max(float(r.abs().max()) for r in ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert float((g - r).abs().max()) <= 1e-5 * scale


def test_fft_kernel_refuses_factors_of_the_other_sign(cuda):
    plan = make_fft_plan(96, shifted=True)
    meta = tfc.fused_pass_meta(plan, (24, 48))
    f = tg.stage_arrays(
        tfc.fused_pass_host_arrays(plan, meta, sign=+1, prefix="fftp"), cuda
    )
    re = torch.zeros((96, 128), dtype=torch.float32, device=cuda)
    before = tfc.LAUNCHES
    with pytest.raises(ValueError, match="sign"):
        tfc.fft_first_axis_fused(re, re.clone(), f, meta=meta, sign=-1)
    assert tfc.LAUNCHES == before


@pytest.mark.parametrize("wstack", [False, True])
def test_dirty_image_on_card_matches_dft(cuda, wstack):
    uvw, freqs, vis, wgt = _small(seed=5)
    ref = dirty_image_dft(uvw, freqs, vis, wgt, 128, PIXEL, apply_w=wstack)
    got = tg.dirty_image(uvw, freqs, vis, wgt, 128, PIXEL,
                         do_wstacking=wstack, device=cuda)
    assert np.abs(got - ref).max() / np.abs(ref).max() <= 1e-4
