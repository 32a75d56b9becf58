"""
The arithmetic of the B2 kernel (``csrc/fft_fused.cu``) on the CPU.

The kernel runs each four-step stage as a Stockham FFT in shared memory
(radix passes of ``sub_fft_radices``, twiddles of ``sub_fft_twiddles``),
with the centring signs of ``make_fft_plan(shifted=True)`` written out
and the crop applied on its last pass. :func:`pass_model` is a compact
torch model of the same stages in the same order, from the same host
tables (``fused_pass_kernel_arrays``); only these tests use it. It is
held against the JAX package's XLA ``fft_first_axis`` and against
``np.fft`` in float64, both to 1e-5 of the reference's max (the
kernel's gate against its plain version, ``KERNEL_RTOL``), out-cropped
and in-cropped, at both signs.

    python tests/test_torch_fft_schedule.py

prints the observed errors of every case.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ska_sdp_cip_tpu.ops import fft as jfft
from ska_sdp_cip_tpu_torch.ops import fft as tfft
from ska_sdp_cip_tpu_torch.ops import fft_cuda as tfc

torch.set_num_threads(1)

RTOL = 1e-5


def sub_fft_model(re, im, n: int, sign: int):
    """The kernel's length-``n`` sub-FFT of each column of (n, B) float32
    re/im: its Stockham passes, butterfly by butterfly in index form."""
    tw = torch.from_numpy(tfc.sub_fft_twiddles(n, sign))
    ns = 1
    for r in tfc.sub_fft_radices(n):
        nb = n // r
        j = torch.arange(nb)
        k = j % ns
        a_re = torch.stack([re[j + t * nb] for t in range(r)])
        a_im = torch.stack([im[j + t * nb] for t in range(r)])
        for t in range(1, r):
            w = tw[(ns - 1) + k * (r - 1) + t - 1]
            wr, wi = w[:, 0:1], w[:, 1:2]
            a_re[t], a_im[t] = (a_re[t] * wr - a_im[t] * wi,
                                a_re[t] * wi + a_im[t] * wr)
        q = np.arange(r)
        ang = sign * 2.0 * np.pi * np.outer(q, q) / r
        c = torch.from_numpy(np.cos(ang).astype(np.float32))
        s = torch.from_numpy(np.sin(ang).astype(np.float32))
        y_re = (torch.einsum("qt,tjb->qjb", c, a_re)
                - torch.einsum("qt,tjb->qjb", s, a_im))
        y_im = (torch.einsum("qt,tjb->qjb", s, a_re)
                + torch.einsum("qt,tjb->qjb", c, a_im))
        rows = ((j - k) * r + k)[None, :] + ns * torch.arange(r)[:, None]
        re, im = torch.empty_like(re), torch.empty_like(im)
        re[rows.reshape(-1)] = y_re.reshape(n, -1)
        im[rows.reshape(-1)] = y_im.reshape(n, -1)
        ns *= r
    return re, im


def pass_model(re, im, f, *, meta, sign: int, prefix: str):
    """The kernel's pass on (rows, m) float32 re/im: the window read
    with zero fill and the j1 sign, stage 1, the twiddle of ``twc``/
    ``tws``, the j2 sign, stage 2, the k2 signs and the crop."""
    n1, n2, m = meta.n1, meta.n2, re.shape[1]
    n = n1 * n2
    x_re = torch.zeros((n1, n2, m))
    x_im = torch.zeros((n1, n2, m))
    window = slice(meta.j1a, meta.j1a + meta.n1_in)
    rows = meta.n1_in * n2
    pad = meta.pad_lo if meta.in_size else 0
    for x, src in ((x_re, re), (x_im, im)):
        flat = torch.zeros((rows, m))
        flat[pad : pad + src.shape[0]] = src
        x[window] = flat.reshape(meta.n1_in, n2, m)
    sg1 = torch.tensor([(-1.0) ** (j1 * n2) for j1 in range(n1)])[:, None,
                                                                   None]
    y_re, y_im = sub_fft_model((x_re * sg1).reshape(n1, -1),
                               (x_im * sg1).reshape(n1, -1), n1, sign)
    y_re, y_im = y_re.reshape(n1, n2, m), y_im.reshape(n1, n2, m)
    # twc/tws (NC, n1, C, 1) -> (n1, n2), j2 = ci * C + c.
    tc, ts = (torch.from_numpy(f[f"{prefix}_{k}"])[..., 0]
              .permute(1, 0, 2).reshape(n1, n2, 1) for k in ("twc", "tws"))
    z_re, z_im = y_re * tc - y_im * ts, y_re * ts + y_im * tc
    sg2 = torch.tensor([(-1.0) ** j2 for j2 in range(n2)])[:, None, None]
    z_re = z_re.permute(1, 0, 2) * sg2  # (n2, n1, m)
    z_im = z_im.permute(1, 0, 2) * sg2
    w_re, w_im = sub_fft_model(z_re.reshape(n2, -1), z_im.reshape(n2, -1),
                               n2, sign)
    sg3 = torch.tensor([(-1.0) ** (n1 * k2 + n // 2)
                        for k2 in range(n2)])[:, None]
    out_re = (w_re * sg3).reshape(n, m)  # row k2 * n1 + k1
    out_im = (w_im * sg3).reshape(n, m)
    c0 = meta.k2a * n1 + meta.trim0
    return out_re[c0 : c0 + meta.size], out_im[c0 : c0 + meta.size]


def _case(n, crop, *, in_crop: bool, sign: int, m: int, seed: int):
    """The model's pass, the JAX XLA pass and np.fft (float64) on the
    same seeded input; returns (model, jax, numpy) as numpy pairs."""
    tplan = tfft.make_fft_plan(n, shifted=True)
    if in_crop:
        meta = tfc.fused_pass_meta(tplan, None, in_crop=crop)
        rows, kw = crop[1], {"in_crop": crop}
    else:
        meta = tfc.fused_pass_meta(tplan, crop)
        rows, kw = n, {"out_crop": crop}
    f = tfc.fused_pass_kernel_arrays(tplan, meta, sign=sign, prefix="k")
    rng = np.random.default_rng(seed)
    re = rng.normal(size=(rows, m)).astype(np.float32)
    im = rng.normal(size=(rows, m)).astype(np.float32)
    model = pass_model(torch.from_numpy(re), torch.from_numpy(im), f,
                       meta=meta, sign=sign, prefix="k")
    jf = jfft.fft_plan_arrays(jfft.make_fft_plan(n, shifted=True))
    jref = jfft.fft_first_axis(jnp.asarray(re), jnp.asarray(im), jf,
                               sign=sign, **kw)
    x = np.zeros((n, m), np.complex128)
    c0, size = crop
    if in_crop:
        x[c0 : c0 + size] = re + 1j * im
    else:
        x = re + 1j * im.astype(np.complex128)
    fft = np.fft.fft if sign < 0 else (lambda a, axis: n * np.fft.ifft(
        a, axis=axis))
    full = np.fft.fftshift(fft(np.fft.ifftshift(x, axes=0), axis=0), axes=0)
    if not in_crop:
        full = full[c0 : c0 + size]
    return ([t.numpy() for t in model], [np.asarray(t) for t in jref],
            [full.real, full.imag])


def _rel(got, ref) -> float:
    scale = max(np.abs(r).max() for r in ref)
    return max(np.abs(np.asarray(g, np.float64) - r).max()
               for g, r in zip(got, ref)) / scale


#: (n, crop, m): the test grids with the invert's centred image crop
#: (the predict pass reads the same rows in place), an off-centre crop
#: (in-crop pad_lo > 0, out-crop trim0 > 0), the bench grid, the
#: production geometry (n1 = 120, n2 = 128; 10240 rows) at m = 8, and
#: two grids the planner can pick with a long stage: 33614 = 98 x 343
#: and 156250 = 250 x 625 (a 16-column stage on the card).
CASES = [
    (192, (48, 96), 6),
    (768, (192, 384), 6),
    (840, (210, 420), 6),
    (1024, (256, 512), 6),
    (768, (100, 300), 5),
    (4096, (1024, 2048), 8),
    (15360, (2560, 10240), 8),
    (33614, (8404, 16806), 2),
    (156250, (39062, 78126), 1),
]


@pytest.mark.parametrize("sign", [+1, -1])
@pytest.mark.parametrize("in_crop", [False, True], ids=["out", "in"])
@pytest.mark.parametrize("n,crop,m", CASES,
                         ids=[f"{c[0]}_{c[1][0]}" for c in CASES])
def test_schedule_matches_jax_and_numpy(n, crop, m, in_crop, sign):
    model, jref, npref = _case(n, crop, in_crop=in_crop, sign=sign, m=m,
                               seed=n + m)
    assert model[0].shape == np.asarray(jref[0]).shape
    assert _rel(model, jref) <= RTOL
    assert _rel(model, npref) <= RTOL


#: Sub-FFT lengths: every radix alone, the stage lengths of the grids
#: above (12, 16, 24, 28, 30, 32, 64, 98, 120, 128, 250, 343, 625) and
#: 2401 (a 4-column stage on the card).
LENGTHS = [2, 3, 4, 5, 7, 8, 12, 16, 24, 28, 30, 32, 64, 98, 120, 128, 210,
           250, 256, 343, 625, 2401]


@pytest.mark.parametrize("sign", [+1, -1])
@pytest.mark.parametrize("n", LENGTHS)
def test_sub_fft_matches_numpy(n, sign):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 3)) + 1j * rng.normal(size=(n, 3))
    x = x.astype(np.complex64)
    got = sub_fft_model(torch.from_numpy(x.real.copy()),
                        torch.from_numpy(x.imag.copy()), n, sign)
    ref = (np.fft.fft(x.astype(np.complex128), axis=0) if sign < 0
           else n * np.fft.ifft(x.astype(np.complex128), axis=0))
    assert _rel([g.numpy() for g in got], [ref.real, ref.imag]) <= RTOL


def test_radix_split_and_twiddle_table():
    assert tfc.sub_fft_radices(120) == (8, 3, 5)
    assert tfc.sub_fft_radices(128) == (8, 8, 2)
    assert tfc.sub_fft_radices(28) == (4, 7)
    assert tfc.sub_fft_radices(30) == (2, 3, 5)
    assert tfc.sub_fft_radices(343) == (7, 7, 7)
    for bad in (1, 11, 22, 4096):
        with pytest.raises(ValueError):
            tfc.sub_fft_radices(bad)
    # Pass p's twiddle (k, t) sits at ns - 1 + k (R - 1) + t - 1.
    tw = tfc.sub_fft_twiddles(120, -1)
    assert tw.shape == (119, 2) and tw.dtype == np.float32
    ns, want = 1, []
    for r in (8, 3, 5):
        for k in range(ns):
            for t in range(1, r):
                want.append(np.exp(-2j * np.pi * t * k / (ns * r)))
        ns *= r
    want = np.asarray(want)
    np.testing.assert_array_equal(tw[:, 0], want.real.astype(np.float32))
    np.testing.assert_array_equal(tw[:, 1], want.imag.astype(np.float32))


def test_kernel_arrays_hold_only_b2s_tables():
    plan = tfft.make_fft_plan(840, shifted=True)
    meta = tfc.fused_pass_meta(plan, (210, 420))
    arrays = tfc.fused_pass_kernel_arrays(plan, meta, sign=+1, prefix="p")
    dense = tfc.fused_pass_host_arrays(plan, meta, sign=+1, prefix="p")
    assert set(arrays) == {f"p_{k}" for k in tfc.B2_FACTORS} | {"p_sign"}
    for key in ("p_twc", "p_tws"):
        np.testing.assert_array_equal(arrays[key], dense[key])
    assert arrays["p_fft1_tw"].shape == (meta.n1 - 1, 2) == (27, 2)
    assert arrays["p_fft2_tw"].shape == (meta.n2 - 1, 2) == (29, 2)
    staged = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
              for k, v in arrays.items()}
    got = tfc.pass_factors(staged, meta, sign=+1, prefix="p",
                           device=torch.device("cpu"))
    assert set(got) == set(tfc.B2_FACTORS)
    # The dense design's factors are no table of B2's: a dict of them
    # alone lacks B2's.
    with pytest.raises(KeyError):
        tfc.pass_factors({k: v for k, v in staged.items()
                          if k in ("p_twc", "p_tws", "p_sign")}, meta,
                         sign=+1, prefix="p", device=torch.device("cpu"))


@pytest.mark.parametrize("n,cols", [(120, 32), (454, 32), (455, 16),
                                    (625, 16), (908, 16), (909, 8),
                                    (1816, 8), (2401, 4), (3632, 4)])
def test_sub_fft_columns_fit_shared_memory(n, cols):
    assert tfc.sub_fft_columns(n) == cols
    assert 2 * 2 * n * cols * 4 <= tfc.SMEM_BYTES


def test_sub_fft_columns_refuse_the_longest():
    assert tfc.MAX_SUB_FFT == 3632
    with pytest.raises(ValueError, match="3632"):
        tfc.sub_fft_columns(3633)


def test_every_planner_grid_has_a_b2_schedule():
    """Every even 7-smooth grid up to 10^6 rows (the sizes
    ``next_even_grid_size`` returns) splits into two sub-FFTs that B2
    takes, with a column tile each."""
    grids = [n for n in range(4, 1_000_001, 2) if _smooth(n)]
    assert 33614 in grids and 43218 in grids and 156250 in grids
    for n in grids:
        n1, n2 = tfft._near_square_factors(n)
        for sub in (n1, n2):
            tfc.sub_fft_radices(sub)
            tfc.sub_fft_columns(sub)


def _smooth(n: int) -> bool:
    for p in (2, 3, 5, 7):
        while n % p == 0:
            n //= p
    return n == 1


if __name__ == "__main__":
    for n, crop, m in CASES:
        for in_crop in (False, True):
            for sign in (+1, -1):
                model, jref, npref = _case(n, crop, in_crop=in_crop,
                                           sign=sign, m=m, seed=n + m)
                print(f"n={n} crop={crop} m={m} "
                      f"{'in' if in_crop else 'out'} sign={sign:+d}: "
                      f"vs jax {_rel(model, jref):.3e}, "
                      f"vs numpy {_rel(model, npref):.3e}, "
                      f"jax vs numpy {_rel(jref, npref):.3e}")
