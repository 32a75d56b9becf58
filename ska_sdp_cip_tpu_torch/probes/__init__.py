"""
Probes of the fused first-axis DFT pass (kernel B2) on the card: the
counterparts of the JAX package's TPU probe scripts, as Hopper probes
of the same questions.

* :mod:`.fft_tiled` (``scripts/fft_tiled_probe.py``): B2 on input
  re-laid by B6 (``pretile_first_axis``) against B2 on row-major input;
* :mod:`.fft_async_fetch` (P1, ``scripts/fft_split_fetch_probe.py``):
  B2's stages as persistent kernels whose input tiles stream through an
  S-deep ring, filled by ``cp.async`` or by bulk copies;
* :mod:`.fft_ablation` (P2, ``scripts/fft_ablation_probe.py``): B2's
  stage kernels with parts switched off (load, load2, s1, s1tw, s2,
  full);
* :mod:`.smem` (P3, ``scripts/vmem_probe.py``): the largest dynamic
  shared memory a block gets;
* :mod:`.b2_compare` (no counterpart): B2's compiled code, outputs and
  times in two checkouts, and P2's launches of B2's kernels against
  B2's code, for changes to B2's shared code (``python -m
  ska_sdp_cip_tpu_torch.probes.b2_compare A B``).

The others run as ``python -m ska_sdp_cip_tpu_torch.probes.<name> [ngrid]``
(default the production grid, 15360, cropped to 10240 rows), prints one
JSON line, and exposes ``run()``. The FFT probes' ``run`` also takes a
CPU device, where every wrapper takes its plain version and no time is
measured; ``smem.run`` needs the card.
"""
