"""
Measurement operator: the forward/adjoint pair of imaging as weighted
linear least squares,

    objective(I) = || sqrt(w) (G I - v) ||^2
    gradient(I)  = G* ( w (G I - v) )          (= invert of residual)

with G = degridding (predict) and G* its exact adjoint (invert).

Counterpart: ``ska_sdp_cip_tpu/models/operators.py``. The operator
holds torch tensors on its ``device``; visibilities are carried as
split (re, im) float32 pairs. It stages like the counterpart: the
packed rows (the native engine's, else ``pack_plan_columns``) and
order transform (``plan_order_host``), slot-order data
(``stage_slot_vis``) and weights (``stage_slot_weights``), uploaded
by ``stage_arrays`` (``utils/staging.py``); every solver iteration
then runs in slot space with no gather between predict and invert.

``residual_gradient`` is the root span ``gradient`` over ``predict``,
``residual`` and ``invert`` (``utils/task_metrics.py``), and counts
``useful_visits`` (``ops/gridder.py:useful_slot_visits``), to hold
against the invert's ``slot_visits``, and ``register_hits`` and
``register_adds`` (``ops/gridder.py:register_reuse``): how often B1's
owners keep a cell's sum in registers from one slot to the next.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property
from typing import NamedTuple

import numpy as np
import torch

from ..ops.gridder import (
    _prepare_sorted_vis,
    build_invert,
    build_predict,
    register_reuse,
    resolve_device,
    slot_duplicate_pairs,
    slot_group_sum,
    slot_plan_host_arrays,
    stage_arrays,
    stage_slot_vis,
    stage_slot_weights,
    useful_slot_visits,
)
from ..ops.plan import GridderPlan, make_plan
from ..utils.task_metrics import count, enabled, span


class SlotVis(NamedTuple):
    """
    Visibilities staged in gridder slot order (``stage_slot_vis``
    convention), as tensors on the operator's device. Produced once by
    :meth:`MeasurementOperator.stage`; every solver iteration reuses it.
    """

    re: torch.Tensor
    im: torch.Tensor


def as_split_pair(vis, device) -> tuple:
    """
    Normalize a visibility argument — complex array or (re, im) pair of
    arrays or tensors — to flattened float32 tensors on ``device``; host
    arrays are uploaded by ``stage_arrays``.
    """
    device = resolve_device(device)
    if not isinstance(vis, tuple):
        arr = np.asarray(vis).ravel()
        vis = (arr.real, arr.imag)
    staged = stage_arrays(
        {i: np.asarray(part, np.float32).reshape(-1)
         for i, part in enumerate(vis) if not isinstance(part, torch.Tensor)},
        device,
    )
    return tuple(
        staged[i] if i in staged
        else part.to(device=device, dtype=torch.float32).reshape(-1)
        for i, part in enumerate(vis)
    )


@dataclass
class MeasurementOperator:
    """
    Forward (image -> visibilities) and adjoint (visibilities -> image)
    measurement operators for one visibility set at one imaging
    configuration, on ``device``.
    """

    plan: GridderPlan
    arrays: dict = field(repr=False)
    weights: torch.Tensor = field(repr=False)  # effective weights, (V,)
    device: torch.device
    #: Effective weights gathered into slot order (padding slots 0).
    slot_weights: torch.Tensor = field(repr=False, default=None)
    #: Straddler slot pairs sharing one source sample (may be empty).
    dup_a: torch.Tensor = field(repr=False, default=None)
    dup_b: torch.Tensor = field(repr=False, default=None)

    @classmethod
    def build(
        cls,
        uvw: np.ndarray,
        channel_frequencies: np.ndarray,
        weights: np.ndarray,
        num_pixels: int,
        pixel_size_lm: float,
        *,
        epsilon: float = 1e-4,
        do_wstacking: bool = True,
        sigma: float | str = 2.0,
        device,
    ) -> "MeasurementOperator":
        """Plan and stage a measurement operator for the given geometry."""
        device = resolve_device(device)
        plan = make_plan(
            uvw,
            channel_frequencies,
            num_pixels,
            pixel_size_lm,
            epsilon=epsilon,
            do_wstacking=do_wstacking,
            sigma=sigma,
        )
        return cls.from_plan(plan, weights, device=device)

    @classmethod
    def from_plan(cls, plan: GridderPlan, weights,
                  *, device) -> "MeasurementOperator":
        """Stage an operator for an existing plan (e.g. one shared with
        the counterpart through ``plan_from_fields``)."""
        device = resolve_device(device)
        weights_flat = np.zeros(plan.num_vis, np.float32)
        raveled = np.asarray(weights, np.float32).ravel()
        weights_flat[: len(raveled)] = raveled
        dup_a, dup_b = slot_duplicate_pairs(plan)
        host = {
            "weights": weights_flat,
            "slot_weights": stage_slot_weights(plan, raveled),
            "dup_a": dup_a.astype(np.int64),
            "dup_b": dup_b.astype(np.int64),
        }
        host.update(slot_plan_host_arrays(plan, device))
        arrays = stage_arrays(host, device)
        return cls(
            plan=plan,
            weights=arrays.pop("weights"),
            device=device,
            slot_weights=arrays.pop("slot_weights"),
            dup_a=arrays.pop("dup_a"),
            dup_b=arrays.pop("dup_b"),
            arrays=arrays,
        )

    @cached_property
    def _invert(self):
        return build_invert(self.plan)

    @cached_property
    def _predict(self):
        return build_predict(self.plan)

    @cached_property
    def _predict_slots(self):
        return build_predict(self.plan, slot_output=True)

    @cached_property
    def total_weight(self) -> float:
        return float(torch.sum(self.weights))

    def stage(self, vis) -> SlotVis:
        """
        Stage measured visibilities into gridder slot order (host-side
        gather + flip + w-shift phase) on the operator's device. Do
        this ONCE per dataset; every solver entry point accepts the
        result.
        """
        if isinstance(vis, SlotVis):
            return vis
        if isinstance(vis, tuple):
            re, im = (np.asarray(part).ravel() for part in vis)
        else:
            arr = np.asarray(vis).ravel()
            re, im = arr.real, arr.imag
        slot_re, slot_im = stage_slot_vis(self.plan, re, im)
        staged = stage_arrays({"re": slot_re, "im": slot_im}, self.device)
        return SlotVis(staged["re"], staged["im"])

    def _image(self, image) -> torch.Tensor:
        return torch.as_tensor(image, dtype=torch.float32,
                               device=self.device)

    def forward(self, image) -> tuple:
        """G I: model visibilities (unweighted), split (re, im), data order."""
        return self._predict(self.arrays, self._image(image))

    def adjoint(self, vis_re, vis_im):
        """G* x for already-weighted data-order split visibilities: raw image."""
        re, im = as_split_pair((vis_re, vis_im), self.device)
        re_s, im_s = _prepare_sorted_vis(self.plan, self.arrays, re, im)
        return self._invert(self.arrays, re_s, im_s)

    def dirty_image(self, vis):
        """Normalized dirty image of measured visibilities."""
        slots = self.stage(vis)
        w = self.slot_weights
        return (
            self._invert(self.arrays, slots.re * w, slots.im * w)
            / self.total_weight
        )

    def psf(self):
        """
        Point-spread function: the dirty image of unit visibilities —
        approximately 1 at the phase centre. Unit data visibilities in
        slot order are just the staged w-shift phase factors (flip
        conjugation fixes im = 0) scaled by the slot weights.
        """
        w = self.slot_weights
        return (
            self._invert(
                self.arrays,
                w * self.arrays["phase_cos"],
                w * self.arrays["phase_sin"],
            )
            / self.total_weight
        )

    def model_slots(self, image) -> SlotVis:
        """
        G I in slot space with straddler pairs group-summed: every slot
        carries its source sample's FULL model value, directly
        comparable to staged data.
        """
        acc_re, acc_im = self._predict_slots(self.arrays, self._image(image))
        acc_re, acc_im = slot_group_sum(acc_re, acc_im, self.dup_a,
                                        self.dup_b)
        return SlotVis(acc_re, acc_im)

    def residual_gradient(self, image, vis):
        """
        G* ( w (G I - v) ) / sum(w): the normalized gradient of the
        weighted least-squares objective — one predict-residual-regrid
        round trip on the device (the major cycle's core), entirely in
        slot space.
        """
        if enabled():
            # Worked out once a plan (one host read), outside the span.
            count("useful_visits", useful_slot_visits(self.plan,
                                                      self.arrays))
            hits, adds = register_reuse(self.plan, self.arrays)
            count("register_hits", hits)
            count("register_adds", adds)
        with span("gradient"):
            slots = self.stage(vis)
            with span("predict"):
                model = self.model_slots(image)
            with span("residual"):
                w = self.slot_weights
                res_re = (model.re - slots.re) * w
                res_im = (model.im - slots.im) * w
            with span("invert"):
                return (self._invert(self.arrays, res_re, res_im)
                        / self.total_weight)
