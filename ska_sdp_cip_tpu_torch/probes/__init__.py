"""
Probes of the fused first-axis DFT pass (kernel B2) on the card: the
counterparts of the JAX package's TPU probe scripts, as Hopper probes
of the same questions.

* :mod:`.fft_tiled` (``scripts/fft_tiled_probe.py``): B2 on input
  re-laid by B6 (``pretile_first_axis``) against B2 on row-major input;
* :mod:`.fft_async_fetch` (P1, ``scripts/fft_split_fetch_probe.py``):
  B2 with stage 1's loads streamed through an S-deep ``cp.async`` ring;
* :mod:`.fft_ablation` (P2, ``scripts/fft_ablation_probe.py``): B2 with
  later stages switched off;
* :mod:`.smem` (P3, ``scripts/vmem_probe.py``): the largest dynamic
  shared memory a block gets.

Each runs as ``python -m ska_sdp_cip_tpu_torch.probes.<name> [ngrid]``
(default the production grid, 15360, cropped to 10240 rows), prints one
JSON line, and exposes ``run()``. The FFT probes' ``run`` also takes a
CPU device, where every wrapper takes its plain version and no time is
measured; ``smem.run`` needs the card.
"""
