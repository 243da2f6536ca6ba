"""Cost counter of the dry run: the operations, bytes and collective bytes
of one rank's step, counted op by op on the ``meta`` device.

The counterpart of ``repro.launch.hlocost``.  The reference walks the
post-SPMD HLO text of a compiled module and multiplies every while body by
its trip count, because ``lax.scan`` runs a layer stack as one loop.  The
port has no HLO and no loops to multiply: its layer loops are Python, so
running the step once on ``meta`` tensors under a ``TorchDispatchMode``
sees every op the card would run, each once per execution.  ``analyze(fn,
*args)`` runs ``fn(*args)`` under :class:`Counter` and returns its
:class:`Cost`, with the reference's fields (``flops``, ``bytes``,
``collective``, ``collective_count``, ``collective_bytes``):

* **flops**: 2·M·N·K for ``mm``, ``addmm``, ``bmm``, ``baddbmm`` (what
  ``linear``, ``matmul`` and ``einsum`` lower to) and the convolutions,
  by ``torch.utils.flop_counter``'s formulas; one a result element for the
  element-wise ops; one an input element for the reductions and
  softmaxes; the two LM kernels by their own closed forms
  (``flash_attention.work``, ``ssd_scan.work``), charged once a call by
  their ``meta`` branches (``kernels.charge_meta``).
* **bytes**: operand plus result bytes of every op that moves data.
  Eager torch runs each op alone, so the unfused sum is the card's own
  traffic, where the reference's XLA bytes are a fused module's.  Views,
  ``empty`` and other ops that move nothing cost 0; a tensor costs its
  own elements (a view its slice, not its storage; a broadcast dim
  once), so an in-place write
  into a slice (``copy_`` into a view, ``index_copy_``, ``index_put_``,
  ``index_add_``, ``scatter_``) costs the slice it writes and what it
  reads, not the buffer: the reference's dynamic-update-slice rule.  The
  reference's ``convert_bytes`` (bf16 -> f32 dot-operand copies that only
  its CPU stand-in backend makes) has no counterpart: a cast here
  (``_to_copy``) is a real pass on the card, so it stays in ``bytes``.
* **collectives**: result bytes by kind (``all-reduce``, ``all-gather``,
  the reference's names), recorded by the counting mesh
  (``launch/mesh.py``) through :func:`record_collective`, and added to
  ``bytes`` as the reference adds them.
* **peak_bytes**: the most bytes of tensors the step made that were
  alive at once (meta storages; views share their base's), the
  counterpart of XLA's ``temp_size_in_bytes``.

All numbers are one rank's (one mesh slot a process).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch import kernels

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten
# Ops that move no data (their results are views, fresh storage left
# unwritten, or metadata).
_FREE = {_aten.empty, _aten.empty_like, _aten.empty_strided,
         _aten.new_empty, _aten.new_empty_strided, _aten.detach,
         _aten.alias, _aten.lift_fresh, _aten.lift_fresh_copy}
# Reductions and softmaxes: one operation an input element.
_REDUCE = {_aten.sum, _aten.mean, _aten.amax, _aten.amin, _aten.max,
           _aten.min, _aten.prod, _aten.logsumexp, _aten._softmax,
           _aten._log_softmax, _aten._softmax_backward_data,
           _aten._log_softmax_backward_data, _aten.cumsum, _aten.var,
           _aten.std, _aten.var_mean, _aten.linalg_vector_norm,
           _aten.norm, _aten.argmax, _aten.argmin, _aten.any, _aten.all,
           _aten.topk, _aten.sort, _aten.cumprod}
# In-place writes whose ``self`` is a buffer they write in part: (the
# argument that holds what is written, the index arguments).
_SCATTER = {_aten.index_copy_: ("source", 3), _aten.index_put_: ("values", 2),
            _aten.index_add_: ("source", 3), _aten.scatter_: ("src", 3),
            _aten.scatter_add_: ("src", 3)}

def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes of ``t``'s own elements (a view: its slice; a broadcast
    dim of stride 0 counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return (n if t.numel() else 0) * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    collective: Optional[Dict[str, float]] = None
    collective_count: Optional[Dict[str, float]] = None
    # Charges of the LM kernels' meta branches: {name: calls}.
    kernel_calls: Optional[Dict[str, int]] = None
    peak_bytes: float = 0.0

    def __post_init__(self):
        for name in ("collective", "collective_count", "kernel_calls"):
            if getattr(self, name) is None:
                setattr(self, name, {})

    @property
    def collective_bytes(self) -> float:
        return sum(self.collective.values())


def record_collective(kind: str, nbytes: float) -> None:
    """Charge every open counter one collective of ``kind`` whose result
    is ``nbytes``."""
    if kind not in COLLECTIVES:
        raise ValueError(f"unknown collective kind {kind!r}")
    for counter in kernels.meta_counters:
        counter.charge_collective(kind, nbytes)


def _written_in_part(func, args, kwargs) -> Optional[float]:
    """Bytes of a scatter-like in-place write: what it writes (twice: read
    and written) and its indices, not the buffer it writes into."""
    spec = _SCATTER.get(func._overloadpacket)
    if spec is None:
        return None
    name, pos = spec
    src = kwargs.get(name, args[pos] if len(args) > pos else None)
    idx = [a for a in args[1:pos] if isinstance(a, torch.Tensor)]
    idx += [t for a in args[1:pos] if isinstance(a, (list, tuple))
            for t in a if isinstance(t, torch.Tensor)]
    nb = 2 * tensor_bytes(src) if isinstance(src, torch.Tensor) else 0
    if func._overloadpacket is _aten.index_add_:
        nb += tensor_bytes(src)        # the slice it adds to is read too
    return float(nb + sum(tensor_bytes(t) for t in idx))


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class Counter(TorchDispatchMode):
    """Counts the ops run under it into ``self.cost`` (see the module
    docstring); the LM kernels' meta branches and the counting mesh charge
    it while it is open."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self._live = 0

    def __enter__(self):
        kernels.meta_counters.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        kernels.meta_counters.remove(self)
        return super().__exit__(*exc)

    # -- charges from outside the dispatch ---------------------------------
    def charge_kernel(self, name: str, nbytes: float, flops: float) -> None:
        self.cost.flops += flops
        self.cost.bytes += nbytes
        self.cost.kernel_calls[name] = self.cost.kernel_calls.get(name, 0) + 1

    def charge_collective(self, kind: str, nbytes: float) -> None:
        c = self.cost
        c.collective[kind] = c.collective.get(kind, 0.0) + nbytes
        c.collective_count[kind] = c.collective_count.get(kind, 0) + 1
        c.bytes += nbytes

    # -- live bytes ---------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        nb = t.untyped_storage().nbytes()
        if nb <= 0:
            return
        self._live += nb
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._live)
        weakref.finalize(t, self._free, nb)

    def _free(self, nb: int) -> None:
        self._live -= nb

    # -- the dispatch -------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        outs = _tensors(out)
        view = _is_view(func)
        in_place = any(r.alias_info is not None and r.alias_info.is_write
                       for r in func._schema.returns)
        if not view and not in_place:
            for t in outs:
                self._track(t)
        if view or packet in _FREE:
            return out
        cost = self.cost
        if packet in flop_registry:
            cost.flops += float(flop_registry[packet](*args, **kwargs,
                                                      out_val=out))
        elif torch.Tag.pointwise in func.tags:
            cost.flops += float(sum(t.numel() for t in outs))
        elif packet in _REDUCE and args and isinstance(args[0],
                                                        torch.Tensor):
            cost.flops += float(args[0].numel())
        part = _written_in_part(func, args, kwargs)
        if part is not None:
            cost.bytes += part
        elif packet is _aten.copy_:
            cost.bytes += float(tensor_bytes(args[0]) + tensor_bytes(args[1]))
        else:
            ins = _tensors((args, kwargs))
            cost.bytes += float(sum(tensor_bytes(t) for t in ins)
                                + sum(tensor_bytes(t) for t in outs))
        return out


def analyze(fn, *args, **kwargs) -> Cost:
    """The :class:`Cost` of ``fn(*args, **kwargs)``, run once under a
    :class:`Counter` (on ``meta`` tensors in the dry run; any device
    works, but only ``meta`` executes nothing)."""
    with Counter() as counter:
        fn(*args, **kwargs)
    return counter.cost


def run(fn, *args, **kwargs):
    """(``fn``'s result, its :class:`Cost`)."""
    with Counter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.cost


def tree_bytes(tree: Any) -> int:
    """Bytes of every tensor in a nested structure (dicts, lists)."""
    if isinstance(tree, torch.Tensor):
        return tensor_bytes(tree)
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0
