"""What one traced step costs: the port's counterpart of the JAX package's
``launch/hlo_analysis.py``.

The JAX package compiles a step and re-reads the optimized HLO text,
multiplying each ``while`` body by its trip count.  The port produces no
HLO: it runs eager PyTorch.  So the step itself runs under
:class:`OpAnalysis`, a ``TorchDispatchMode`` that sees every ATen op the
step dispatches, forward, backward and remat recompute alike, on meta
tensors (shapes without storage) or on a real device.  Every Python loop
of the model (the flash-attention block pairs, the Mamba scan's chunks,
the sLSTM's tokens) is counted as often as it runs.  Four things are
counted on the traced device:

* **matmul FLOPs**: 2 x |output| x the contracting dimension for ``mm``,
  ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``addmv`` and ``dot``, which is
  what ``matmul``, ``linear`` and ``einsum`` lower to (``hlo_analysis``'s
  ``_dot_flops``);
* **bytes**: operand plus output bytes of each op that materialises, the
  convention of ``hlo_analysis`` (operands + output of every instruction
  outside ``_SKIP_BYTES_OPS``).  Views, reshapes, ``empty`` and other
  metadata ops cost nothing; a fill writes its output only; ``copy_``
  reads its source and writes its destination; a gather (``index``,
  ``index_select``, ``gather``, ``embedding``) is charged twice its output,
  and an in-place scatter (``index_put_``, ``index_add_``, ``scatter_``,
  ...) twice the elements it writes plus its indices, never the whole
  buffer it writes into (``hlo_analysis``'s gather and scatter rules).
  In eager PyTorch every op is a kernel that reads its operands from and
  writes its output to device memory, so these bytes are the port's own
  traffic, not a fused program's: the dtype casts that XLA fuses away
  (``convert``, which ``hlo_analysis`` skips) are kernels here and are
  charged;
* **transcendental elements**: ``exp``, ``expm1``, ``log``, ``log1p``,
  ``tanh``, ``sigmoid``, ``rsqrt``, ``sqrt``, ``pow``, ``sin``, ``cos``,
  and the exponentials inside ``_softmax``, ``_log_softmax`` and
  ``logsumexp`` (``hlo_analysis``'s list);
* **the peak of live bytes**: each output storage counts from the op that
  makes it until the last tensor on it dies, rounded up to 512 bytes as
  the CUDA caching allocator rounds a request.  Views share their base's
  storage, and tensors autograd saves for the backward stay live while
  they are saved (PyTorch keeps a tensor's Python object while the C++
  side holds it, so its finalizer runs only when the storage is free).
  The step's inputs (:meth:`OpAnalysis.pin`) are live throughout.

On meta tensors each op's shape rule runs in Python (PyTorch's meta
kernels), a few hundred microseconds a call; the model's loops repeat the
same calls, so a call's output layout is computed once for each distinct
op, argument shapes and values, and reused (``OpAnalysis._run``).

Ops with no tensor on the traced device (the optimizer's host scalars)
are not counted.  A kernel wrapper that cannot run on meta tensors gives
their output shape and charges its own work with :func:`charge`; the
block-sparse decode attention (row 17) does, as a dense upper bound,
since on meta the mask is unknown.

Under a device mesh (DTensor arguments) the counts are one device's.
The mode sees each op first with DTensor arguments, the global op; it
declines it (``NotImplemented``), so DTensor dispatches it with the mode
still active, and the mode then counts what DTensor runs on the local
shards: the local op, and the collectives DTensor issues to redistribute
its operands (``_c10d_functional`` ops).  A collective's operand bytes
count under the JAX package's name for it (``all_reduce`` as
"all-reduce", ``all_gather_into_tensor`` "all-gather",
``reduce_scatter_tensor`` "reduce-scatter", ``all_to_all_single``
"all-to-all"), not in ``bytes``; its output is live memory as any op's.
The global ops DTensor runs on fake tensors to propagate shapes are not
counted.  One card has no collectives: there their counts are 0.

    with OpAnalysis(device="meta") as oa:
        oa.pin(params, batch)
        out = step(...)
    oa.result()   # {"flops", "bytes", "transcendentals", ...}
"""

from __future__ import annotations

import contextlib
import functools
import math
import weakref

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_flatten

ALLOC_ROUND = 512           # the caching allocator's request granularity
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_MATMUL = {"mm", "addmm", "bmm", "baddbmm", "mv", "addmv", "dot", "vdot"}
_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "log10",
                   "tanh", "sigmoid", "rsqrt", "sqrt", "pow", "sin", "cos",
                   "_softmax", "_log_softmax"}
_TRANSCENDENTAL_IN = {"logsumexp"}          # one exp per input element
# ops that move no data: views the schema does not mark, allocations
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_unsafe_view", "lift_fresh", "detach",
         "alias", "set_", "resize_", "_reshape_alias"}
_WRITE_ONLY = {"fill", "zero", "full", "zeros", "ones", "full_like",
               "zeros_like", "ones_like", "new_zeros", "new_ones",
               "new_full", "scalar_tensor", "arange"}
_GATHER = {"index", "index_select", "gather", "embedding"}
# DTensor's functional collectives: op name -> the JAX package's name
_COLLECTIVE_OPS = {"all_reduce": "all-reduce",
                   "all_reduce_coalesced": "all-reduce",
                   "all_gather_into_tensor": "all-gather",
                   "all_gather_into_tensor_coalesced": "all-gather",
                   "reduce_scatter_tensor": "reduce-scatter",
                   "reduce_scatter_tensor_coalesced": "reduce-scatter",
                   "all_to_all_single": "all-to-all"}
_FREE_COLLECTIVE = {"wait_tensor", "_wrap_tensor_autograd"}
_SCATTER_INPLACE = {"index_put_", "_index_put_impl_", "index_add_",
                    "index_copy_", "scatter_", "scatter_add_",
                    "scatter_reduce_"}


def _dtensor_type():
    """DTensor's class where ``torch.distributed.tensor`` is loaded, else
    None (no DTensor can exist then)."""
    import sys
    mod = sys.modules.get("torch.distributed.tensor")
    return None if mod is None else mod.DTensor


def local_tensor(t):
    """A DTensor's local shard; any other value as it is."""
    dt = _dtensor_type()
    return t._local_tensor if dt is not None and isinstance(t, dt) else t


def _in_fake_mode() -> bool:
    """True while DTensor propagates shapes on fake tensors."""
    return any(type(m).__name__ == "FakeTensorMode"
               for m in _get_current_dispatch_mode_stack())


def alloc_bytes(nbytes: int) -> int:
    """A request of ``nbytes`` as the caching allocator holds it."""
    return -(-nbytes // ALLOC_ROUND) * ALLOC_ROUND


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _indexed_elems(self_t, indices) -> int:
    """Elements ``self_t[indices]`` addresses (advanced indexing: the
    broadcast index shape times every dimension no tensor indexes)."""
    shapes = [i.shape for i in indices if i is not None]
    n = math.prod(torch.broadcast_shapes(*shapes)) if shapes else 1
    for d, size in enumerate(self_t.shape):
        if d >= len(indices) or indices[d] is None:
            n *= size
    return n


def _scatter_bytes(name, args):
    """An in-place scatter's bytes: twice the elements it writes, in the
    destination's dtype, plus its indices."""
    self_t = args[0]
    item = self_t.element_size()
    if name in ("index_put_", "_index_put_impl_"):
        idx = [i for i in args[1] if i is not None]
        written = _indexed_elems(self_t, args[1])
    elif name in ("index_add_", "index_copy_"):
        idx, written = [args[2]], args[3].numel()
    else:                               # scatter_, scatter_add_, ...
        idx, written = [args[2]], args[2].numel()
    return 2 * written * item + sum(_nbytes(i) for i in idx)


def _tensors(items) -> list:
    """The tensors among ``items`` and inside their lists and tuples (an
    ATen op's arguments nest one level: ``cat``, ``index_put_``)."""
    out = []
    for a in items:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


def _arg_key(a):
    """A hashable description of an op argument that fixes its outputs'
    shapes on meta tensors, or raises TypeError."""
    if isinstance(a, torch.Tensor):
        return (a.shape, a.stride(), a.storage_offset(), a.dtype,
                a.device)
    if isinstance(a, (list, tuple)):
        return tuple(_arg_key(x) for x in a)
    if a is None or isinstance(a, (bool, int, float, str, torch.dtype,
                                   torch.device, torch.layout,
                                   torch.memory_format)):
        return (type(a), a)
    raise TypeError(type(a))


def _memo_key(func, args, kwargs):
    try:
        return (func, _arg_key(args), _arg_key(tuple(sorted(
            kwargs.items()))))
    except TypeError:
        return None


@functools.cache
def _fresh(func) -> bool:
    """True for an op whose every output is a new tensor: no view, no
    argument it writes or aliases."""
    schema = func._schema
    return not func.is_view and all(
        a.alias_info is None for a in schema.arguments) and all(
        r.alias_info is None for r in schema.returns)


def _layout(out):
    """(the sequence type or None for one tensor, [(shape, stride, dtype)
    ...]) of an op's outputs when each is a meta tensor that
    ``empty_strided`` rebuilds exactly, else None (not kept)."""
    many = type(out) if isinstance(out, (tuple, list)) else None
    lays = []
    for t in (out if many else (out,)):
        if not isinstance(t, torch.Tensor) or t.device.type != "meta" or \
                t.storage_offset() or \
                t.untyped_storage().nbytes() != torch.empty_strided(
                    t.shape, t.stride(), dtype=t.dtype,
                    device=t.device).untyped_storage().nbytes():
            return None
        lays.append((t.shape, t.stride(), t.dtype))
    return many, lays


def _contracting(name, args) -> int:
    if name in ("mm", "bmm", "mv", "dot", "vdot"):
        return args[0].shape[-1]
    return args[1].shape[-1]            # addmm, baddbmm, addmv: the left


class OpAnalysis(TorchDispatchMode):
    """Counts FLOPs, bytes, transcendental elements and the peak of live
    bytes of every op dispatched on ``device`` while the mode is active
    (see the module docstring).  ``charged`` holds the work that kernel
    wrappers charged through :func:`charge`, by label."""

    def __init__(self, device="meta"):
        super().__init__()
        self.device = torch.device(device)
        self.flops = 0.0
        self.bytes = 0.0
        self.transcendentals = 0.0
        self.ops = 0
        self.bytes_by_op: dict[str, float] = {}
        self.collectives = {c: 0.0 for c in COLLECTIVES}
        self.collective_calls = 0
        self.charged: dict[str, dict] = {}
        self.argument_bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.peak_op = None
        self.peak_by_op: dict[str, int] = {}
        self._live_by_op: dict[str, int] = {}
        self._storages: dict[int, list] = {}  # key -> [bytes, refs, op]
        self._pinned: set[int] = set()
        self._objects: dict[int, weakref.ref] = {}
        self._memo: dict = {}
        self.label: str | None = None   # set by :func:`labelled`

    # -- live bytes -------------------------------------------------------
    def _on_device(self, t) -> bool:
        return isinstance(t, torch.Tensor) and t.device == self.device

    def pin(self, *trees) -> int:
        """Count the tensors of ``trees`` (nested dicts, lists and tuples)
        as the step's arguments: live throughout, each
        storage once.  Returns the argument bytes."""
        for t in map(local_tensor, tree_flatten(trees)[0]):
            if self._on_device(t):
                st = t.untyped_storage()
                key = st._cdata
                if key in self._pinned:
                    continue
                self._pinned.add(key)
                if key not in self._storages:
                    n = alloc_bytes(st.nbytes())
                    self.argument_bytes += n
                    self._add_live(n, "argument")
        return self.argument_bytes

    def _add_live(self, n: int, op: str) -> None:
        self.live_bytes += n
        self._live_by_op[op] = self._live_by_op.get(op, 0) + n
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes
            self.peak_op = op
            self.peak_by_op = {k: v for k, v in self._live_by_op.items()
                               if v}

    def _track(self, t: torch.Tensor, op: str) -> None:
        ref = self._objects.get(id(t))
        if ref is not None and ref() is t:
            return                      # an in-place op's own output
        st = t.untyped_storage()
        key = st._cdata
        if key in self._pinned:
            return
        entry = self._storages.get(key)
        if entry is None:
            op = self.label or op
            entry = self._storages[key] = [alloc_bytes(st.nbytes()), 0, op]
            self._add_live(entry[0], op)
        entry[1] += 1
        oid = id(t)
        self._objects[oid] = weakref.ref(
            t, lambda _, key=key, oid=oid: self._release(key, oid))

    def _release(self, key: int, oid: int) -> None:
        self._objects.pop(oid, None)
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live_bytes -= entry[0]
            self._live_by_op[entry[2]] -= entry[0]
            del self._storages[key]

    # -- counting ---------------------------------------------------------
    def add(self, label: str, *, flops=0.0, bytes=0.0,
            transcendentals=0.0) -> None:
        """Charge work that no ATen op shows (a kernel wrapper's own)."""
        self.flops += flops
        self.bytes += bytes
        self.transcendentals += transcendentals
        rec = self.charged.setdefault(label, {"calls": 0, "flops": 0.0,
                                              "bytes": 0.0,
                                              "transcendentals": 0.0})
        rec["calls"] += 1
        rec["flops"] += flops
        rec["bytes"] += bytes
        rec["transcendentals"] += transcendentals

    def _count(self, func, name, args, ins, outs) -> None:
        before = self.bytes
        self._count_work(func, name, args, ins, outs)
        if self.bytes != before:
            self.bytes_by_op[name] = self.bytes_by_op.get(name, 0.0) + \
                self.bytes - before

    def _count_work(self, func, name, args, ins, outs) -> None:
        if func.namespace == "_c10d_functional":
            kind = _COLLECTIVE_OPS.get(name)
            if kind is not None:
                self.collectives[kind] += sum(_nbytes(t) for t in ins)
                self.collective_calls += 1
            elif name not in _FREE_COLLECTIVE:
                raise NotImplementedError(f"collective {func} is not "
                                          f"counted")
            return
        base = name.rstrip("_")
        if name in _MATMUL:
            self.flops += 2.0 * outs[0].numel() * _contracting(name, args)
        if base in _TRANSCENDENTAL:
            self.transcendentals += sum(o.numel() for o in outs)
        elif base in _TRANSCENDENTAL_IN:
            self.transcendentals += ins[0].numel()
        if func.is_view or name in _FREE:
            return
        if base in _WRITE_ONLY:
            self.bytes += sum(_nbytes(o) for o in outs)
        elif name == "copy_":
            self.bytes += _nbytes(args[0]) + _nbytes(args[1])
        elif name in _GATHER:
            self.bytes += 2 * sum(_nbytes(o) for o in outs)
        elif name in _SCATTER_INPLACE:
            self.bytes += _scatter_bytes(name, args)
        else:
            self.bytes += sum(_nbytes(t) for t in ins + outs
                              if t.device == self.device)

    def _run(self, func, args, kwargs):
        """``func`` on meta tensors, its shape propagation computed once for
        each distinct call: a call with the same op, argument shapes,
        strides, dtypes and values as an earlier one gets fresh outputs of
        the outputs' recorded layout (``empty_strided``).  Only ops that
        return new tensors (no view, no in-place write) are kept."""
        key = _memo_key(func, args, kwargs)
        layout = self._memo.get(key) if key is not None else None
        if layout is not None:
            many, lays = layout
            outs = [torch.empty_strided(shape, stride, dtype=dtype,
                                        device=self.device)
                    for shape, stride, dtype in lays]
            return many(outs) if many else outs[0]
        out = func(*args, **kwargs)
        if key is not None and _fresh(func):
            # ``_unsafe_view`` and its kind alias an input unannounced
            ins = {t.untyped_storage()._cdata for t in _tensors(args) +
                   _tensors(kwargs.values())}
            if not any(t.untyped_storage()._cdata in ins
                       for t in _tensors((out,))):
                self._memo[key] = _layout(out)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        dt = _dtensor_type()
        if dt is not None and any(issubclass(t, dt) for t in types):
            return NotImplemented       # DTensor runs it; local ops come back
        if _in_fake_mode():
            return func(*args, **kwargs)
        if self.device.type == "meta":
            out = self._run(func, args, kwargs)
        else:
            out = func(*args, **kwargs)
        ins = _tensors(args) + _tensors(kwargs.values())
        outs = _tensors((out,))
        dev = self.device
        if any(t.device == dev for t in ins) or any(t.device == dev
                                                    for t in outs):
            self.ops += 1
            name = func._overloadpacket.__name__
            self._count(func, name, args, ins, outs)
            for t in outs:
                if t.device == dev:
                    self._track(t, name)
        return out

    def result(self) -> dict:
        """``hlo_analysis.analyze_text``'s keys (collective operand bytes
        by kind, 0 off a mesh), the collectives issued, and the
        memory: argument bytes, the peak of live bytes, temp bytes (the
        peak less the arguments), and at the peak the op whose output
        reached it and the live bytes by the op that made them; and the
        bytes by op."""
        out = {"flops": self.flops, "bytes": self.bytes,
               "transcendentals": self.transcendentals,
               **self.collectives,
               "collective_total": sum(self.collectives.values()),
               "collective_calls": self.collective_calls,
               "ops": self.ops, "argument_bytes": self.argument_bytes,
               "peak_bytes": self.peak_bytes,
               "temp_bytes": self.peak_bytes - self.argument_bytes,
               "peak_op": self.peak_op,
               "peak_by_op": dict(sorted(self.peak_by_op.items(),
                                         key=lambda kv: -kv[1])),
               "bytes_by_op": dict(sorted(self.bytes_by_op.items(),
                                          key=lambda kv: -kv[1]))}
        if self.charged:
            out["charged"] = {k: dict(v) for k, v in self.charged.items()}
        return out


def charge(label: str, *, flops=0.0, bytes=0.0, transcendentals=0.0):
    """Charge a kernel's own work to every active :class:`OpAnalysis`
    (none active: nothing happens).  For wrappers that give a meta
    tensor's output shape without launching."""
    for mode in _get_current_dispatch_mode_stack():
        if isinstance(mode, OpAnalysis):
            mode.add(label, flops=flops, bytes=bytes,
                     transcendentals=transcendentals)


@contextlib.contextmanager
def labelled(name: str):
    """Count the live bytes of the storages made inside the block under
    ``name`` in every active :class:`OpAnalysis`'s ``peak_by_op``, in place
    of the op that made them (none active: nothing happens).  The sharded
    decode state's shards are counted so, as ``decode_state``."""
    modes = [m for m in _get_current_dispatch_mode_stack()
             if isinstance(m, OpAnalysis)]
    prev = [m.label for m in modes]
    for m in modes:
        m.label = name
    try:
        yield
    finally:
        for m, p in zip(modes, prev, strict=True):
            m.label = p
