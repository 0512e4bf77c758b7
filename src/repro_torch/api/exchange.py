"""Exchange-strategy registry: how x reaches the units that need it.

The paper's two fan-out regimes (ch.4 measurement decomposition), plus
the pipelined refinement of the second (DESIGN.md §9):

* ``"replicated"`` — *échange total*: every unit receives the whole x
  (all-gather). Simple, and the baseline the selective volumes are
  measured against.
* ``"selective"`` — the static all_to_all schedule carrying only the
  C_Xk block-columns each unit's tiles touch
  (:func:`repro_torch.pmvc.plan_device.build_selective_plan`).
* ``"overlap"`` — the selective schedule plus a plan-time local/halo
  tile split (:func:`repro_torch.pmvc.plan_device.build_overlap_plan`): the
  runtime issues the all_to_all first, contracts the tiles whose x
  block the unit already owns while the transfer is in flight, then
  stream-accumulates the halo contribution — ``T_iter ≈ max(T_comm,
  T_local) + T_halo`` instead of ``T_comm + T_comp``.
* ``"overlap:K"`` (any integer K ≥ 1, resolved on the fly by
  :func:`resolve_exchange`) — the multi-wave refinement (DESIGN.md
  §13): the halo is split into K prioritized waves (ring-nearest
  sources first) with one all_to_all schedule each, so wave k's
  contraction hides wave k+1's transfer. ``"overlap"`` ≡
  ``"overlap:1"``.

An exchange strategy is a callable ``(device_plan: DevicePlan) ->
ExchangePlan``: ``None`` means replicated semantics, a
:class:`SelectivePlan` the blocking selective exchange, an
:class:`OverlapPlan` the pipelined one — every executor understands all
three.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.api.registry import Registry
from repro_torch.pmvc.plan_device import (
    DevicePlan,
    ExchangePlan,
    build_overlap_plan,
    build_selective_plan,
)

__all__ = ["EXCHANGES", "register_exchange", "resolve_exchange"]

EXCHANGES = Registry("exchange")
register_exchange = EXCHANGES.register


@EXCHANGES.register("replicated")
def replicated(plan: DevicePlan) -> ExchangePlan:
    return None


@EXCHANGES.register("selective")
def selective(plan: DevicePlan) -> ExchangePlan:
    return build_selective_plan(plan)


@EXCHANGES.register("overlap")
def overlap(plan: DevicePlan) -> ExchangePlan:
    return build_overlap_plan(plan)


def resolve_exchange(name: str) -> Callable[[DevicePlan], ExchangePlan]:
    """Registry lookup, with ``"overlap:K"`` multi-wave variants
    synthesized on demand (``"overlap:1"`` is the single-wave pipeline,
    identical to ``"overlap"``)."""
    if name in EXCHANGES:
        return EXCHANGES.get(name)
    if name.startswith("overlap:"):
        try:
            waves = int(name.split(":", 1)[1])
        except ValueError:
            raise ValueError(
                f"malformed exchange {name!r}: expected 'overlap:<int K>=1>'"
            ) from None
        if waves < 1:
            raise ValueError(f"exchange {name!r}: wave count must be >= 1")

        def overlap_waves(plan: DevicePlan) -> ExchangePlan:
            return build_overlap_plan(plan, waves=waves)

        return overlap_waves
    return EXCHANGES.get(name)  # raises with the known-names message
