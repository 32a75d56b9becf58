"""
The port's B6 re-lay, B2's tiled input mode and the B2 probes' plain
pieces on the CPU, against the JAX package.

* ``pretile_first_axis`` (plain, CPU) equals the JAX Pallas
  ``pretile_first_axis`` in interpret mode exactly (a re-lay moves
  values and computes nothing), out-cropped at n = 512 and in-cropped
  (n1i < n1); a wrong input shape raises as in the counterpart.
* ``fft_first_axis_fused(tiled=True)`` on CPU equals the port's
  row-major pass exactly, and the JAX tiled pass (bf16x3, interpret)
  to 1e-5 of max (``tests/test_torch_fft.py``'s tolerance).
* The ablation probe's plain pieces: ``s1tw`` then ``s2`` equals
  ``fft_first_axis_reference`` to 1e-6 of max (float32 on both sides,
  only the summation order differs), ``load`` is the identity, and
  ``s1`` is the stage-1 einsum, at n = 512 and n = 960 (n1 = 30, not a
  multiple of the kernel's 16-deep chunk).
* Each probe module runs its CPU path, or (``smem``) raises an error
  that names the card, without importing jax.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ska_sdp_cip_tpu.ops import fft as jfft
from ska_sdp_cip_tpu.ops import fft_pallas as jfp
from ska_sdp_cip_tpu_torch.ops import fft as tfft
from ska_sdp_cip_tpu_torch.ops import fft_cuda as tfc
from ska_sdp_cip_tpu_torch.probes import common
from ska_sdp_cip_tpu_torch.probes import fft_ablation as p2
from ska_sdp_cip_tpu_torch.probes import fft_async_fetch as p1

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _metas(n, crop=None, in_crop=None):
    jmeta = jfp.fused_pass_meta(jfft.make_fft_plan(n, shifted=True), crop,
                                in_crop=in_crop)
    tplan = tfft.make_fft_plan(n, shifted=True)
    return jmeta, tplan, tfc.fused_pass_meta(tplan, crop, in_crop=in_crop)


def _inputs(rows, m, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(rows, m)).astype(np.float32),
            rng.normal(size=(rows, m)).astype(np.float32))


#: (n, out_crop, in_crop): the counterpart test's out-cropped pass and
#: predict's in-cropped pass (stage 1 over n1i = 8 of n1 = 16 rows).
PRETILE_CASES = [(512, (128, 256), None), (512, None, (128, 256))]


@pytest.mark.parametrize("n,crop,in_crop", PRETILE_CASES,
                         ids=["out_crop", "in_crop"])
def test_pretile_equals_jax_exactly(n, crop, in_crop):
    jmeta, _, tmeta = _metas(n, crop, in_crop)
    assert (tmeta.n1_in < tmeta.n1) == (in_crop is not None)
    re, im = _inputs(tmeta.n1_in * tmeta.n2, 256, seed=1)
    before = tfc.PRETILE_LAUNCHES
    ours = tfc.pretile_first_axis(torch.from_numpy(re), torch.from_numpy(im),
                                  meta=tmeta)
    assert tfc.PRETILE_LAUNCHES == before
    ref = jfp.pretile_first_axis(jnp.asarray(re), jnp.asarray(im),
                                 meta=jmeta, interpret=True)
    for o, r in zip(ours, ref):
        assert tuple(o.shape) == tfc.tiled_shape(tmeta, 256) == r.shape
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_pretile_refuses_a_wrong_shape():
    jmeta, _, tmeta = _metas(512, (128, 256))
    bad = np.zeros((500, 256), np.float32)
    with pytest.raises(ValueError, match="pretile input shape"):
        tfc.pretile_first_axis(torch.from_numpy(bad), torch.from_numpy(bad),
                               meta=tmeta)
    with pytest.raises(ValueError, match="pretile input shape"):
        jfp.pretile_first_axis(jnp.asarray(bad), jnp.asarray(bad),
                               meta=jmeta, interpret=True)


def test_tiled_pass_equals_untiled_and_jax():
    n, crop = 512, (128, 256)
    jmeta, tplan, tmeta = _metas(n, crop)
    host = tfft.fft_plan_arrays(tplan, prefix="fft")
    host.update(tfc.fused_pass_host_arrays(tplan, tmeta, sign=+1,
                                           prefix="fftp"))
    f = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
         for k, v in host.items()}
    re, im = _inputs(n, n, seed=7)
    tre, tim = torch.from_numpy(re), torch.from_numpy(im)
    base = tfc.fft_first_axis_fused(tre, tim, f, meta=tmeta, sign=+1)
    before = tfc.TILED_LAUNCHES
    tiled = tfc.fft_first_axis_fused(
        *tfc.pretile_first_axis(tre, tim, meta=tmeta), f, meta=tmeta,
        sign=+1, tiled=True,
    )
    assert tfc.TILED_LAUNCHES == before
    for t, b in zip(tiled, base):
        assert torch.equal(t, b)

    jf = {k: jnp.asarray(v) for k, v in jfp.fused_pass_host_arrays(
        jfft.make_fft_plan(n, shifted=True), jmeta, sign=+1, prefix="fp"
    ).items()}
    jt = jfp.pretile_first_axis(jnp.asarray(re), jnp.asarray(im),
                                meta=jmeta, interpret=True)
    ref = jfp.fft_first_axis_fused(*jt, jf, meta=jmeta, prefix="fp",
                                   interpret=True, tiled=True)
    scale = max(float(np.abs(np.asarray(r)).max()) for r in ref)
    for t, r in zip(tiled, ref):
        np.testing.assert_allclose(t.numpy(), np.asarray(r),
                                   atol=1e-5 * scale, rtol=0)


def test_tiled_pass_refuses_a_wrong_shape():
    _, tplan, tmeta = _metas(512, (128, 256))
    f = {k: torch.from_numpy(v) for k, v in
         tfft.fft_plan_arrays(tplan, prefix="fft").items()}
    flat = torch.zeros((512, 256))
    with pytest.raises(ValueError, match="bad tiled input shape"):
        tfc.fft_first_axis_fused(flat, flat, f, meta=tmeta, sign=+1,
                                 tiled=True)
    wrong = torch.zeros((tmeta.nc, 2, tmeta.n1_in, tmeta.c + 1, tmeta.mb))
    with pytest.raises(ValueError, match="bad tiled input shape"):
        tfc.fft_first_axis_fused(wrong, wrong, f, meta=tmeta, sign=+1,
                                 tiled=True)


@pytest.mark.parametrize("n,m", [(512, 256), (960, 1024)],
                         ids=["512", "960"])
def test_ablation_plain_pieces(n, m):
    s = common.out_crop_pass(n, "cpu", m=m)
    meta, f = s.meta, s.f
    assert meta.n1 == {512: 16, 960: 30}[n]
    ref = tfc.fft_first_axis_reference(s.re, s.im, f, meta=meta, sign=+1)
    z = p2.ablation_reference("s1tw", s.re, s.im, f, meta=meta)
    chained = p2.ablation_reference("s2", *z, f, meta=meta)
    scale = max(float(r.abs().max()) for r in ref)
    for c, r in zip(chained, ref):
        assert c.shape == r.shape == (meta.size, m)
        assert float((c - r).abs().max()) <= 1e-6 * scale
    full = p2.ablation_reference("full", s.re, s.im, f, meta=meta)
    assert all(torch.equal(a, b) for a, b in zip(full, chained))
    load = p2.ablation("load", s.re, s.im, f, meta=meta)
    assert all(torch.equal(a, b) for a, b in zip(load, (s.re, s.im)))
    # s1: the stage-1 einsum of m1 with the input viewed (n1i, n2, m).
    y = torch.einsum(
        "kj,jnm->knm", f["fftp_m1"],
        torch.cat([s.re.reshape(meta.n1_in, meta.n2, m),
                   s.im.reshape(meta.n1_in, meta.n2, m)]),
    )
    s1 = p2.ablation("s1", s.re, s.im, f, meta=meta)
    assert torch.equal(s1[0], y[: meta.n1].reshape(-1, m))
    assert torch.equal(s1[1], y[meta.n1 :].reshape(-1, m))
    assert sum(p2.LAUNCHES.values()) == 0


def test_probe_wrappers_refuse_bad_arguments():
    s = common.out_crop_pass(512, "cpu")
    with pytest.raises(ValueError, match="variant"):
        p2.ablation("s1twtr", s.re, s.im, s.f, meta=s.meta)
    with pytest.raises(ValueError, match="takes"):
        p2.ablation("s2", s.re[:100], s.im[:100], s.f, meta=s.meta)
    with pytest.raises(ValueError, match="stages"):
        p1.async_fetch_pass(s.re, s.im, s.f, meta=s.meta, stages=3)
    got = p1.async_fetch_pass(s.re, s.im, s.f, meta=s.meta, stages=2)
    ref = p2.ablation_reference("full", s.re, s.im, s.f, meta=s.meta)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert common.crop_rows(15360) == 10240 == common.crop_rows(20480)
    assert common.crop_rows(4096) == 2048


def test_probe_modules_run_on_cpu_without_jax():
    """Each probe's CPU path (plain versions, no time), in a process
    where jax cannot be imported; the shared-memory probe names the
    card it needs."""
    code = (
        "import sys, json\n"
        "sys.modules['jax'] = None\n"
        "import torch; torch.set_num_threads(1)\n"
        "from ska_sdp_cip_tpu_torch.probes import fft_tiled, "
        "fft_async_fetch, fft_ablation, smem\n"
        "out = [m.run(256, device='cpu') for m in "
        "(fft_tiled, fft_async_fetch, fft_ablation)]\n"
        "try:\n"
        "    smem.run(device='cpu')\n"
        "except RuntimeError as err:\n"
        "    out.append(str(err))\n"
        "print(json.dumps(out))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    import json

    tiled, fetch, ablation, smem_err = json.loads(proc.stdout)
    assert tiled["pretile_exact"] and tiled["tiled_exact"]
    assert tiled["pretile_max_abs_err"] == 0.0
    assert tiled["tiled_ms"] == "not measured"
    assert all(c["exact_vs_dense"] for c in fetch["stages"].values())
    assert set(ablation["variants"]) == set(p2.VARIANTS)
    assert "CUDA card" in smem_err
