"""Roofline terms of one step, from its counted costs.

    compute term    = FLOPs / (chips × peak_FLOP/s)
    memory term     = bytes / (chips × HBM_bw)
    collective term = collective_bytes / (chips × link_bw)

The JAX package reads FLOPs and bytes from ``compiled.cost_analysis()``
and parses the collectives out of the optimized HLO text. The port keeps
the HLO reader (:func:`parse_collectives`, so it reads the reference's
dry-run artifacts) and counts its own steps with :func:`step_costs`,
which runs the step once eagerly and counts the aten ops rank 0 runs.
The wire model is the reference's: for every all-gather / all-reduce /
reduce-scatter / all-to-all / collective-permute the *output* tensor
bytes, all-reduce → 2× (reduce + broadcast phases), others → 1×.
MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE) per train step; the
ratio MODEL_FLOPS / FLOPs exposes remat/redundancy waste.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.config import ArchConfig, ShapeConfig
from repro_torch.roofline.hw import HBM_BW, ICI_BW, PEAK_FLOPS_BF16

__all__ = [
    "CollectiveStats",
    "parse_collectives",
    "RooflineTerms",
    "roofline_terms",
    "model_flops",
    "step_costs",
]

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

# `%op = bf16[8,128]{1,0} all-gather(...)` or tuple outputs
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_LINE_RE = re.compile(
    r"=\s*(\([^)]*\)|\S+)\s+(all-reduce-start|all-reduce|all-gather-start|all-gather|"
    r"reduce-scatter|all-to-all|collective-permute-start|collective-permute)\("
)

# torch's functional collectives under the reference's names.
_FUNCOL_NAMES = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}
_FUNCOL_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")

# Queries of a tensor's metadata: no work.
_METADATA_OPS = frozenset(
    getattr(torch.ops.aten, name).default
    for name in ("size", "sym_size", "stride", "sym_stride", "storage_offset",
                 "sym_storage_offset", "numel", "sym_numel", "dim", "is_contiguous")
)


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_op: Dict[str, float]
    count_by_op: Dict[str, int]

    @property
    def wire_bytes(self) -> float:
        """Modeled bytes on the wire: all-reduce counts double."""
        total = 0.0
        for op, b in self.bytes_by_op.items():
            total += 2.0 * b if op.startswith("all-reduce") else b
        return total

    @property
    def total_count(self) -> int:
        return sum(self.count_by_op.values())

    def add(self, op: str, nbytes: float) -> None:
        self.bytes_by_op[op] = self.bytes_by_op.get(op, 0.0) + nbytes
        self.count_by_op[op] = self.count_by_op.get(op, 0) + 1


def _shape_bytes(txt: str) -> float:
    total = 0.0
    for dt, dims in _SHAPE_RE.findall(txt):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def parse_collectives(hlo_text: str) -> CollectiveStats:
    """The collectives of an optimized HLO module's text (the JAX
    package's dry-run artifacts)."""
    stats = CollectiveStats({}, {})
    for line in hlo_text.splitlines():
        m = _LINE_RE.search(line)
        if m:
            stats.add(m.group(2).replace("-start", ""), _shape_bytes(m.group(1)))
    return stats


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _inferring_shapes(types) -> bool:
    """Whether the op runs on fake tensors: DTensor's sharding propagation
    runs each new op once on global-shape fakes, which is no work of the
    step's."""
    return (any(issubclass(t, FakeTensor) for t in types)
            or any(isinstance(m, FakeTensorMode) for m in _get_current_dispatch_mode_stack()))


class _CostMode(TorchDispatchMode):
    """Counts the local ops this process runs. An op on DTensors is
    handed back to DTensor (``NotImplemented``), which runs it as
    collectives and ops on its local shards, and those come back here:
    so every count is of local tensors, per device."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives = CollectiveStats({}, {})

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func in _METADATA_OPS or _inferring_shapes(types):
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if func.namespace in _FUNCOL_NAMESPACES:
            out = func(*args, **kwargs)
            name = _FUNCOL_NAMES.get(packet.__name__)
            if name is not None:
                self.collectives.add(name, _nbytes(out))
            return out
        if packet not in flop_registry:
            # A composite op reaching the mode is counted by its parts, as
            # torch.utils.flop_counter does.
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not func.is_view:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def step_costs(fn: Callable, *args, **kwargs) -> Tuple[Dict[str, float], CollectiveStats, Any]:
    """Run ``fn(*args, **kwargs)`` once, eagerly, and count what this
    process ran: returns ``({"flops", "bytes accessed"}, collectives,
    fn's result)``, per device.

    * **flops**: ``torch.utils.flop_counter``'s formulas (products,
      convolutions, attention) over each op's *local* tensors. Counted
      over DTensors, ``FlopCounterMode`` sees the global shapes; here the
      count is taken inside DTensor's dispatch, on the shards it runs.
    * **bytes accessed**: every aten op's input and output bytes, views
      excluded — the HBM traffic of an eager program that fuses nothing,
      an upper bound on what a compiler that fuses would move.
    * **collectives**: the output bytes and count of each functional
      collective (``_c10d_functional``), named as the HLO's
      (``all-reduce``, ``all-gather``, ``reduce-scatter``,
      ``all-to-all``); DTensor's redistributions and the model's own
      collectives both run as these.

    The backward pass is counted when ``fn`` runs one (autograd carries
    the mode into it)."""
    mode = _CostMode()
    with mode:
        out = fn(*args, **kwargs)
    return {"flops": float(mode.flops), "bytes accessed": float(mode.bytes)}, mode.collectives, out


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE); decode uses D = new tokens and
    2·N (forward only)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch  # one new token per slot
    return 2.0 * n * tokens


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    model_flops: float
    chips: int
    peak_flops: float = PEAK_FLOPS_BF16

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Optimistic (perfect overlap): max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flop_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def mfu(self) -> float:
        """MODEL_FLOPS / (chips × peak × step_time) under the optimistic
        overlap model — the roofline fraction."""
        t = self.step_time_s
        if t <= 0:
            return 0.0
        return self.model_flops / (self.chips * self.peak_flops * t)


def roofline_terms(
    *,
    hlo_flops: float,
    hlo_bytes: float,
    collective_bytes: float,
    chips: int,
    cfg: Optional[ArchConfig] = None,
    shape: Optional[ShapeConfig] = None,
    mflops: Optional[float] = None,
    peak_flops: float = PEAK_FLOPS_BF16,
    hbm_bw: float = HBM_BW,
    link_bw: float = ICI_BW,
) -> RooflineTerms:
    """The three terms of a step that does ``hlo_flops`` and moves
    ``hlo_bytes`` and ``collective_bytes`` on ``chips`` chips, at the
    card's rates (:mod:`repro_torch.roofline.hw`) unless given others.
    The names of the first three keep the reference's (``hlo_*``)."""
    if mflops is None:
        mflops = model_flops(cfg, shape) if cfg and shape else 0.0
    return RooflineTerms(
        compute_s=hlo_flops / (chips * peak_flops),
        memory_s=hlo_bytes / (chips * hbm_bw),
        collective_s=collective_bytes / (chips * link_bw),
        hlo_flops=hlo_flops,
        hlo_bytes=hlo_bytes,
        collective_bytes=collective_bytes,
        model_flops=mflops,
        chips=chips,
        peak_flops=peak_flops,
    )
