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
* The B2 probes' plain pieces (P2's variants, P1's stages): ``s1tw``
  then ``s2`` equals ``fft_first_axis_reference`` to 1e-6 of max and
  the JAX fused pass (interpret) to 1e-5, ``load`` and ``load2`` are the
  identity, ``s1`` and ``s1tw`` are the stage-1 DFT and its twiddle in
  complex128 to 1e-5, at n = 512 and n = 960 (n1 = 30); the wrappers
  refuse bad variants, engines, depths, stages and shapes.
* P1's ring geometry (``ops/fft_cuda.py:ring_geometry``): which depths
  and column tiles fit a block's 227 KiB at n = 120, 128, 256, 454 and
  455, and the depths built at the production and large grids.
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


def _probe_pass(n, m, seed):
    """The probes' pass at n (``common.out_crop_pass``'s geometry and
    factors) on numpy-made input, with the JAX package's fused pass
    (interpret mode) on the same input."""
    s = common.out_crop_pass(n, "cpu", m=m)
    re, im = _inputs(n, m, seed)
    npix = common.crop_rows(n)
    jplan = jfft.make_fft_plan(n, shifted=True)
    jmeta = jfp.fused_pass_meta(jplan, ((n - npix) // 2, npix))
    jf = {k: jnp.asarray(v) for k, v in jfp.fused_pass_host_arrays(
        jplan, jmeta, sign=+1, prefix="fp").items()}
    jax_out = jfp.fft_first_axis_fused(jnp.asarray(re), jnp.asarray(im), jf,
                                       meta=jmeta, prefix="fp",
                                       interpret=True)
    return s, torch.from_numpy(re), torch.from_numpy(im), jax_out


@pytest.mark.parametrize("n,m", [(512, 256), (960, 1024)],
                         ids=["512", "960"])
def test_ablation_plain_pieces(n, m):
    """P2's plain pieces: ``s1tw`` then ``s2`` is the plain pass (1e-6 of
    max) and the JAX fused pass (1e-5); ``load`` and ``load2`` are the
    identity; ``s1`` and ``s1tw`` are y = conj(D1) x and z = y conj(T)
    (complex128 numpy, 1e-5), at n = 512 and n = 960 (n1 = 30: radix
    2, 3, 5)."""
    s, re, im, jax_out = _probe_pass(n, m, seed=11)
    meta, f = s.meta, s.f
    assert meta.n1 == {512: 16, 960: 30}[n]
    ref = tfc.fft_first_axis_reference(re, im, f, meta=meta, sign=+1)
    z = p2.ablation_reference("s1tw", re, im, f, meta=meta)
    chained = p2.ablation_reference("s2", *z, f, meta=meta)
    full = p2.ablation("full", re, im, f, meta=meta)
    scale = max(float(r.abs().max()) for r in ref)
    for c, r, j, u in zip(chained, ref, jax_out, full):
        assert c.shape == r.shape == u.shape == (meta.size, m)
        assert float((c - r).abs().max()) <= 1e-6 * scale
        assert torch.equal(u, r)
        np.testing.assert_allclose(c.numpy(), np.asarray(j),
                                   atol=1e-5 * scale, rtol=0)
    for variant, x in (("load", (re, im)), ("load2", z)):
        got = p2.ablation(variant, *x, f, meta=meta)
        assert all(torch.equal(a, b) for a, b in zip(got, x))
    n1, n2 = meta.n1, meta.n2
    x = (re.numpy().astype(np.float64)
         + 1j * im.numpy()).reshape(n1, n2 * m)
    d1 = f["fft_d1_cos"].numpy() + 1j * f["fft_d1_sin"].numpy()
    y = (d1.astype(np.complex128) @ x).reshape(n1 * n2, m)
    tw = (f["fft_tw_cos"].numpy() + 1j * f["fft_tw_sin"].numpy())
    zc = (y.reshape(n1, n2, m) * tw[:, :, None]).reshape(n1 * n2, m)
    for variant, want in (("s1", y), ("s1tw", zc)):
        got = p2.ablation(variant, re, im, f, meta=meta)
        err = np.abs(got[0].numpy() + 1j * got[1].numpy() - want).max()
        assert err <= 1e-5 * np.abs(want).max()
    assert sum(p2.LAUNCHES.values()) == 0


def test_probe_wrappers_refuse_bad_arguments():
    s = common.out_crop_pass(512, "cpu")
    with pytest.raises(ValueError, match="variant"):
        p2.ablation("s1twtr", s.re, s.im, s.f, meta=s.meta)
    with pytest.raises(ValueError, match="takes"):
        p2.ablation("s2", s.re[:100], s.im[:100], s.f, meta=s.meta)
    with pytest.raises(ValueError, match="stages"):
        p1.async_fetch_pass(s.re, s.im, s.f, meta=s.meta, engine="bulk",
                            stages=4)
    with pytest.raises(ValueError, match="engine"):
        p1.async_fetch_pass(s.re, s.im, s.f, meta=s.meta, engine="tma",
                            stages=1)
    with pytest.raises(ValueError, match="stage must"):
        p1.async_fetch_pass(s.re, s.im, s.f, meta=s.meta,
                            engine="cp_async", stages=1, stage=3)
    with pytest.raises(ValueError, match="shape"):
        p1.async_fetch_pass(s.re[:100], s.im[:100], s.f, meta=s.meta,
                            engine="cp_async", stages=1)
    in_meta = tfc.fused_pass_meta(tfft.make_fft_plan(512, shifted=True),
                                  None, in_crop=(128, 256))
    with pytest.raises(ValueError, match="out-cropped"):
        p1.async_fetch_pass(s.re, s.im, s.f, meta=in_meta,
                            engine="cp_async", stages=1)
    with pytest.raises(ValueError, match="out-cropped"):
        p2.ablation("load", s.re, s.im, s.f, meta=in_meta)
    with pytest.raises(ValueError, match="intermediate"):
        tfc.fft_first_axis_fused(s.re, s.im, s.f, meta=s.meta, sign=+1,
                                 z=(s.re, s.im))
    ref = p2.ablation_reference("full", s.re, s.im, s.f, meta=s.meta)
    for stages in p1.STAGES:
        got = p1.async_fetch_pass(s.re, s.im, s.f, meta=s.meta,
                                  engine="bulk", stages=stages)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    z = p1.async_fetch_pass(s.re, s.im, s.f, meta=s.meta, engine="bulk",
                            stages=1, stage=1)
    assert all(torch.equal(a, b) for a, b in
               zip(z, p2.ablation_reference("s1tw", s.re, s.im, s.f,
                                            meta=s.meta)))
    assert sum(p1.LAUNCHES.values()) == 0
    assert common.crop_rows(15360) == 10240 == common.crop_rows(20480)
    assert common.crop_rows(4096) == 2048


#: n -> (B2's column tile, ring depths that fit with cp.async, with
#: bulk): 120 and 128 (the production grid's n1, n2) take S = 1-3; 256
#: (the large grid's n2) one slot less; 454, B2's longest 32-column
#: sub-FFT, only B2's two buffers, and the bulk engine's mbarrier not
#: even that; 455 drops to 16 columns.
RING_CASES = {120: (32, (1, 2, 3), (1, 2, 3)), 128: (32, (1, 2, 3), (1, 2, 3)),
              256: (32, (1, 2), (1, 2)), 454: (32, (1,), ()),
              455: (16, (1, 2), (1, 2))}


@pytest.mark.parametrize("n", sorted(RING_CASES))
def test_ring_geometry_fits_shared_memory(n):
    cols, cp_async, bulk = RING_CASES[n]
    for engine, depths in (("cp_async", cp_async), ("bulk", bulk)):
        g = tfc.ring_geometry(n, engine)
        assert (g.columns, g.depths) == (cols, depths)
        extra = 8 if engine == "bulk" else 0
        for s in tfc.RING_DEPTHS:
            need = (s + 1) * 2 * n * cols * 4 + extra * s
            assert (need <= tfc.SMEM_BYTES) == (s in depths)
        assert (g.why == "") == (depths == tfc.RING_DEPTHS)
    with pytest.raises(ValueError, match="engine"):
        tfc.ring_geometry(n, "tma")


def test_ring_depths_at_the_probed_grids():
    """P1 builds S = 1-3 at the production grid and leaves S = 3 out at
    the large image's, saying why; the geometry needs no array."""
    for n, depths in ((15360, (1, 2, 3)), (32768, (1, 2))):
        plan = tfft.make_fft_plan(n, shifted=True)
        npix = common.crop_rows(n)
        meta = tfc.fused_pass_meta(plan, ((n - npix) // 2, npix))
        for engine in p1.ENGINES:
            assert p1.depths(meta, engine) == depths
            out = p1.left_out(meta, engine)
            assert set(out) == {f"{engine}_S{s}" for s in p1.STAGES
                                if s not in depths}
            assert all("n = 256" in why for why in out.values())


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
    assert set(fetch["cases"]) == set(p1.LAUNCHES) and not fetch["left_out"]
    assert all(c["exact"] and c["stage1_exact"] and c["stage2_exact"]
               for c in fetch["cases"].values())
    assert set(ablation["variants"]) == set(p2.VARIANTS)
    assert all(c.get("exact", True) and c["ms"] == "not measured"
               for c in ablation["variants"].values())
    assert "CUDA card" in smem_err


def test_b2_compare_reads_sass_without_names_and_needs_a_card():
    """The B2 comparison's pure parts: two disassemblies that differ
    only in kernel names, offsets and encodings read the same, one
    changed operand reads as one line; kernels from two files match by
    name once the anonymous namespaces' identifiers are dropped; the
    turns alternate which checkout goes first; without a card, or
    without two checkouts, it refuses with exit 2."""
    from ska_sdp_cip_tpu_torch.probes import b2_compare as bc

    a = ("\t\tFunction : _ZN45t_fused_cu_fe5e395413stage2_kernelILi4EE\n"
         "        /*0000*/   LDC R1, c[0x0][0x28] ;   "
         "/* 0x00000a00ff017b82 */\n"
         "        /*0010*/   S2R R0, SR_TID.X ;   "
         "/* 0x0000000000007919 */\n")
    b = (a.replace("45t_fused_cu", "52parent_fft_fused_cu")
         .replace("/*0010*/", "/*0020*/").replace("7919", "7a19"))
    assert bc.normalize_sass(a) == bc.normalize_sass(b) == [
        "LDC R1, c[0x0][0x28] ;", "S2R R0, SR_TID.X ;"]
    changed = bc.normalize_sass(a.replace("SR_TID.X", "SR_TID.Y"))
    assert bc.differing_lines(bc.normalize_sass(a), changed) == 1
    assert bc.differing_lines(bc.normalize_sass(a), changed[:1]) == 1

    def kernel(space, args):
        return (f"_ZN{len(space)}{space}13stage1_kernelILi32EN{len(space)}"
                f"{space}9Stage1OutEEEvNS_4PassE{args}")

    fused = "_INTERNAL_5c2f8e21_12_fft_fused_cu_9e3ab7c1"
    probes = "_INTERNAL_0d41a6b3_13_fft_probes_cu_17c2f0aa"
    assert bc.plain_name(kernel(fused, "PKf")) == bc.plain_name(
        kernel(probes, "PKf")) == (
        "_ZN13stage1_kernelILi32EN9Stage1OutEEEvNS_4PassEPKf")
    assert bc.plain_name(kernel("_GLOBAL__N__a1b2_x_cu", "Pf")) == (
        "_ZN13stage1_kernelILi32EN9Stage1OutEEEvNS_4PassEPf")
    dump = ("\t\tFunction : " + kernel(fused, "PKf") + "\n"
            "        /*0000*/   LDC R1, c[0x0][0x28] ;\n"
            "\t\tFunction : _ZN4load_kernelE\n"
            "        /*0000*/   EXIT ;\n")
    assert bc.sass_functions(dump) == {
        bc.plain_name(kernel(probes, "PKf")): ["LDC R1, c[0x0][0x28] ;"],
        "_ZN4load_kernelE": ["EXIT ;"]}
    assert bc.turn_order() == ["b", "a", "a", "b", "b", "a"]
    assert len(bc.turn_order()) == bc.TURNS
    assert bc.main(["elsewhere"]) == 2
    if not torch.cuda.is_available():
        assert bc.main(["here", "elsewhere"]) == 2
