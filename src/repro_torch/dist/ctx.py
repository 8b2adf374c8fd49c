"""Mesh and axis context shared by the models, the wide aggregates and the
dry run: the port of the JAX package's ``dist/ctx.py``, both halves.

The model half.  The JAX package runs one program over a device mesh
(GSPMD); the port's counterpart is ``torch.distributed``'s
``DeviceMesh`` with DTensor parameters and activations: each eager op
propagates its operands' placements and issues the collectives itself.
``activate(mesh)`` makes a mesh current for the model's sharding notes
(``constrain``, ``dp_axes``, ``axis_sizes``, ``attn_head_plan``), which
read it as the JAX package's do.  Off-mesh, and on a plain (non-DTensor)
tensor, every note is the identity, so single-device tests, the serve
engine and the trainer run the same code unchanged.  A mesh here is a
``DeviceMesh`` (``mesh_dim_names``, ``shape``), a :class:`WideMesh`, or
any object exposing ``axis_names`` and ``devices.shape`` (so the rules
can be read with no process group).

The wide half.  The JAX package's sharded paths run under one controller:
one process maps a function over a 1-D ``("wide",)`` device mesh
(``shard_map``) and all-gathers the shards' partials.  The port keeps
that design.  A :class:`WideMesh` is a 1-D tuple of ``torch.device``; one
process launches each shard's kernel on that shard's device and gathers
the partials with ``.to(merge device)`` and ``torch.cat``.  Devices may
repeat, so S shards can sit on one card (or on the CPU, as the tests run
them).  ``set_wide_mesh`` installs the default mesh of every sharded
entry point that is not given ``mesh=``; :func:`resolve_wide` is the one
rule by which each of them reads a mesh request.
"""

from __future__ import annotations

import contextlib
import math

import torch

MODEL_AXIS = "model"
WIDE_AXIS = "wide"

_PURE_DP = False
_ACTIVE_MESH = None     # set by activate()
_WIDE_MESH = None


# ---------------------------------------------------------------------------
# pure-dp switch (configs with pure_dp=True ignore the model axis entirely)
# ---------------------------------------------------------------------------

def set_pure_dp(flag: bool) -> None:
    """Treat every mesh axis (except ``wide``) as data-parallel: the model
    axis is never assigned to weights, activations or head plans."""
    global _PURE_DP
    _PURE_DP = bool(flag)


def pure_dp() -> bool:
    return _PURE_DP


# ---------------------------------------------------------------------------
# current mesh
# ---------------------------------------------------------------------------

def current_mesh():
    """The mesh :func:`activate` made current, or None (off-mesh: every
    helper degrades to a no-op)."""
    return _ACTIVE_MESH


@contextlib.contextmanager
def activate(mesh):
    """Make ``mesh`` current for this context.  There is no resource
    environment to set beside it: DTensor placements travel with the
    tensors."""
    global _ACTIVE_MESH
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    try:
        yield mesh
    finally:
        _ACTIVE_MESH = prev


def axis_names_of(mesh) -> tuple:
    """The axis names of a ``DeviceMesh`` (``mesh_dim_names``), a
    :class:`WideMesh` or a mesh-shaped stand-in (``axis_names``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes_of(mesh) -> dict:
    """{axis name: size} of a mesh -- the one derivation shared by ctx and
    the sharding rules."""
    if isinstance(mesh, WideMesh):
        return {mesh.axis_names[0]: len(mesh.devices)}
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, tuple(mesh.devices.shape)))


def dp_axes_of(mesh, pure_dp: bool) -> tuple:
    """Axes a batch dim shards over on ``mesh``: every axis except
    ``model`` / ``wide`` (all but ``wide`` under pure-dp)."""
    excl = {WIDE_AXIS} if pure_dp else {WIDE_AXIS, MODEL_AXIS}
    return tuple(a for a in axis_names_of(mesh) if a not in excl)


def axis_sizes() -> dict:
    """{axis name: size} of the current mesh ({} off-mesh)."""
    m = current_mesh()
    return {} if m is None else axis_sizes_of(m)


def dp_axes() -> tuple:
    """:func:`dp_axes_of` on the current mesh.  Off-mesh the conventional
    ``("data",)`` is returned -- harmless, because :func:`constrain` is a
    no-op there."""
    m = current_mesh()
    if m is None:
        return ("data",)
    return dp_axes_of(m, _PURE_DP)


def model_axis_size() -> int:
    if _PURE_DP:
        return 1
    return int(axis_sizes().get(MODEL_AXIS, 1))


# ---------------------------------------------------------------------------
# model-side helpers
# ---------------------------------------------------------------------------

def attn_head_plan(hkv: int, g: int, qc: int) -> str:
    """Which flash-attention tile dim carries the model axis.

    ``"hkv"`` / ``"g"`` / ``"qc"`` name the dim to constrain; ``"auto"``
    leaves the placements the projections' head sharding gives; ``"dp"``
    constrains only the batch dim (pure-dp, size-1 model axis, or nothing
    divides)."""
    ms = model_axis_size()
    if ms <= 1:
        return "dp"
    if hkv % ms == 0:
        return "hkv"
    if g % ms == 0:
        return "g"
    if (hkv * g) % ms == 0:
        return "auto"
    if qc % ms == 0:
        return "qc"
    return "dp"


def is_dtensor(x) -> bool:
    """True for a DTensor (imported only when ``torch.distributed`` is
    already loaded: off-mesh code never imports it)."""
    import sys
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def resolve_entries(shape, dims: dict, sizes: dict) -> list:
    """JAX's ``constrain`` resolution: {dim: axis | axes} -> one entry a
    dim (None, an axis, or a tuple of axes).  Axes absent from the mesh,
    axes already claimed by a lower dim, and axes whose total size does
    not divide the dim are dropped."""
    entries: list = [None] * len(shape)
    used: set = set()
    for d in sorted(dims):
        ax = dims[d]
        axes = (ax,) if isinstance(ax, str) else tuple(ax or ())
        axes = tuple(a for a in axes if a in sizes and a not in used)
        n = math.prod(sizes[a] for a in axes)
        if not axes or (n > 1 and shape[d] % n != 0):
            continue
        used.update(axes)
        entries[d] = axes[0] if len(axes) == 1 else axes
    return entries


def placements_for(entries, mesh) -> tuple:
    """DTensor placements, one a dim of ``mesh``, of a spec's ``entries``:
    ``Shard(i)`` on each mesh dim that tensor dim ``i`` names (several axes
    on one dim shard it in mesh-dim order, major to minor, as JAX splits
    ``P(("pod", "data"))``), ``Replicate()`` otherwise -- and on a mesh dim
    of size 1, where a shard is the whole tensor (DTensor would otherwise
    refuse to merge or drop a size-1 dim sharded there)."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = axis_sizes_of(mesh)
    where = {}
    for i, e in enumerate(entries):
        for a in ((e,) if isinstance(e, str) else tuple(e or ())):
            where[a] = i
    return tuple(Shard(where[n]) if n in where and sizes[n] > 1
                 else Replicate() for n in axis_names_of(mesh))


def full(shape, value, like, dims: dict, dtype=torch.float32):
    """``torch.full`` on ``like``'s device, constrained by ``dims``: off
    the mesh (or beside a plain ``like``) a plain tensor; beside a DTensor
    ``like`` a DTensor on its mesh, each device holding only its shard (a
    JAX ``jnp.full`` followed by ``constrain``)."""
    m = current_mesh()
    if m is None or not is_dtensor(like):
        return torch.full(shape, value, dtype=dtype, device=like.device)
    from torch.distributed.tensor import DTensor, Shard
    mesh = like.device_mesh
    entries = resolve_entries(shape, dims, axis_sizes_of(m))
    placements = placements_for(entries, mesh)
    local = list(shape)
    for size, pl in zip(mesh.shape, placements):
        if isinstance(pl, Shard):
            local[pl.dim] //= size
    # the local shard on like's own device (meta in the dry run), where a
    # DTensor factory would allocate on the mesh's device type
    t = torch.full(local, value, dtype=dtype, device=like.to_local().device)
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def local_map(fn, *pairs, like: int = 0):
    """``fn`` on local shards, for an op DTensor has no sharding strategy
    for.  Each of ``pairs`` is ``(x, dims)``: x is placed exactly as
    ``dims`` (:func:`constrain`'s) resolves on the current mesh -- a dim no
    axis names is replicated (``{}`` replicates x whole, an all-gather, as
    GSPMD replicates an operand it cannot partition), a plain tensor is
    taken as replicated first -- and ``fn`` gets the local shards; each
    tensor it returns comes back as a DTensor placed as ``pairs[like]``'s
    input.  So ``{}`` everywhere runs ``fn`` on whole copies; ``{0:
    dp_axes}`` everywhere runs it on each device's own groups (the JAX
    package's ``vmap`` over sharded groups).  Off the mesh, or with no
    DTensor among the inputs, it is ``fn(*xs)``.  Differentiable."""
    xs = [x for x, _ in pairs]
    if current_mesh() is None or not any(is_dtensor(x) for x in xs):
        return fn(*xs)
    from torch.distributed.tensor import DTensor, Replicate, \
        distribute_tensor
    mesh = next(x for x in xs if is_dtensor(x)).device_mesh
    sizes = axis_sizes_of(current_mesh())
    local, wants = [], []
    for x, dims in pairs:
        want = placements_for(resolve_entries(x.shape, dims, sizes), mesh)
        if not is_dtensor(x):
            x = distribute_tensor(x, mesh, (Replicate(),) * mesh.ndim)
        if tuple(x.placements) != want:
            x = x.redistribute(mesh, want)
        local.append(x.to_local())
        wants.append(want)
    out = fn(*local)

    def wrap(t):
        return DTensor.from_local(t, mesh, wants[like], run_check=False)
    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def write_local(fn, target, *args):
    """``fn(target, *values)`` that writes ``target`` IN PLACE (a decode
    cache column).  Each of ``args`` is ``(value, dim_map)``, ``dim_map``
    {target dim: value dim}.  Off the mesh, or on a plain target, it is
    ``fn(target, *values)``.  On a DTensor target each value is placed as
    the target is (sharded where its mapped dim is, replicated otherwise),
    and ``fn`` writes the target's local shard with the values' local
    shards: DTensor has no in-place ``index_put_`` that keeps a sharded
    target's placement.  ``fn`` must index the target with local sizes
    (``target.shape`` inside it is the shard's)."""
    if current_mesh() is None or not is_dtensor(target):
        return fn(target, *(v for v, _ in args))
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = target.device_mesh
    local = []
    for v, dim_map in args:
        want = tuple(Shard(dim_map[pl.dim]) if isinstance(pl, Shard)
                     and pl.dim in dim_map else Replicate()
                     for pl in target.placements)
        if not is_dtensor(v):
            v = distribute_tensor(v, mesh, (Replicate(),) * mesh.ndim)
        if tuple(v.placements) != want:
            v = v.redistribute(mesh, want)
        local.append(v.to_local())
    fn(target.to_local(), *local)
    return target


def _groups(src, dst) -> list:
    """Pair the dims of a reshape from ``src`` to ``dst``: [(src dims,
    dst dims)] of equal products, size-1 dims left out."""
    a = [(i, n) for i, n in enumerate(src) if n != 1]
    b = [(j, n) for j, n in enumerate(dst) if n != 1]
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        ga, gb = [a[i]], [b[j]]
        pa, pb = a[i][1], b[j][1]
        i, j = i + 1, j + 1
        while pa != pb:
            if pa < pb:
                ga.append(a[i])
                pa *= a[i][1]
                i += 1
            else:
                gb.append(b[j])
                pb *= b[j][1]
                j += 1
        out.append(([d for d, _ in ga], [d for d, _ in gb]))
    return out


def _fit_for_view(x, shape):
    """``x`` with every mesh dim whose sharding a reshape to ``shape``
    cannot keep redistributed to ``Replicate()``: a dim stays sharded only
    as the first dim of its group, where the group's first new dim
    divides by the mesh sizes sharding it (GSPMD reshards such an operand
    the same way)."""
    from torch.distributed.tensor import Replicate, Shard
    groups = _groups(tuple(x.shape), tuple(shape))
    first = {g[0][0]: shape[g[1][0]] for g in groups}
    mesh = x.device_mesh
    split = {}
    for size, pl in zip(mesh.shape, x.placements):
        if isinstance(pl, Shard):
            split[pl.dim] = split.get(pl.dim, 1) * size
    want = tuple(
        Replicate() if isinstance(pl, Shard) and (
            pl.dim not in first or first[pl.dim] % split[pl.dim]) else pl
        for pl in x.placements)
    return x if want == tuple(x.placements) else x.redistribute(mesh, want)


def _fit_partials(args, dts) -> tuple:
    """``args`` with the pending sums DTensor cannot carry further
    reduced first (``redistribute`` of that mesh dim to ``Replicate()``,
    an all-reduce): a ``Partial("avg")`` operand (a mean over a sharded
    dim), whose mix with a ``Partial("sum")`` it cannot redistribute, and
    a partial operand beside another operand sharded on the same mesh dim
    (it cannot turn the shard into a partial: gradient sums in the
    backward pass).  ``dts``: the DTensors among ``args``, one at least
    partial."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    sharded = {k for a in dts for k, pl in enumerate(a.placements)
               if isinstance(pl, Shard)} if len(dts) > 1 else set()

    def fit(a):
        if not is_dtensor(a):
            return a
        want = tuple(Replicate() if isinstance(pl, Partial) and (
            pl.reduce_op == "avg" or k in sharded) else pl
            for k, pl in enumerate(a.placements))
        return a if want == tuple(a.placements) else \
            a.redistribute(a.device_mesh, want)
    return tuple(fit(a) for a in args)


def _placement_guard_mode():
    """A ``TorchDispatchMode`` that fits DTensor operands before DTensor
    propagates an op: the operand of every view (``_fit_for_view``) and
    the pending sums it cannot carry (``_fit_partials``) -- in forward
    ops, their gradients' ops and remat recomputes alike (a dispatch mode
    stays active through the backward pass); an in-place ``detach_``,
    which some torch versions dispatch with no DTensor strategy, returns
    its operand.  Other ops run as they are; the check costs a few
    microseconds an op."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    views = {torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default}
    detach_ = torch.ops.aten.detach_.default

    class _PlacementGuard(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            dts = [a for a in args if isinstance(a, DTensor)]
            if not dts:
                return func(*args, **kwargs)
            if func is detach_:
                # autograd detached it above the dispatcher; no data moves
                # (DTensor registers no strategy for the in-place form)
                return args[0]
            if func in views and args[0] is dts[0] and args[0].numel():
                shape = list(args[1])
                if -1 in shape:
                    k = shape.index(-1)
                    shape[k] = 1
                    shape[k] = args[0].numel() // math.prod(shape)
                args = (_fit_for_view(args[0], tuple(shape)),) + \
                    tuple(args[1:])
            elif any(pl.is_partial() for a in dts for pl in a.placements):
                args = _fit_partials(args, dts)
            return func(*args, **kwargs)

    return _PlacementGuard()


@contextlib.contextmanager
def on_mesh(mesh):
    """The context a step on DTensors runs in: ``mesh`` current (unless
    one already is), plain tensors taken as replicated (positions, masks,
    a fresh accumulator: GSPMD takes a constant so), and operands fitted
    where DTensor cannot propagate their placements
    (``_placement_guard_mode``; entered last, so it sees each op before any
    dispatch mode entered earlier)."""
    from torch.distributed.tensor.experimental import implicit_replication
    with contextlib.ExitStack() as stack:
        if current_mesh() is None:
            stack.enter_context(activate(mesh))
        stack.enter_context(implicit_replication())
        stack.enter_context(_placement_guard_mode())
        yield mesh


def constrain(x, dims: dict):
    """The JAX package's ``with_sharding_constraint`` of x with {dim index:
    axis | axes tuple}, dropping axes as :func:`resolve_entries` does.

    Off-mesh, or on a plain tensor, this is the identity.  On a DTensor it
    redistributes x to the placements the entries give (dims the entries
    do not name are replicated, as ``P(...)`` leaves them); a DTensor
    already so placed comes back as it is."""
    m = current_mesh()
    if m is None or not is_dtensor(x):
        return x
    entries = resolve_entries(x.shape, dims, axis_sizes_of(m))
    if all(e is None for e in entries):
        return x
    mesh = x.device_mesh
    want = placements_for(entries, mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


class WideMesh:
    """A 1-D mesh: ``devices`` (a tuple of ``torch.device``, repeats
    allowed; a CUDA device raises where no GPU is present) along one named
    ``axis``.  Shard ``s`` runs on
    ``devices[s]``; ``devices[0]`` is where partials merge.  Two meshes
    are equal when their devices and axis are."""

    def __init__(self, devices, axis: str = WIDE_AXIS):
        from repro_torch.kernels.ops import resolve_device
        self.devices = tuple(resolve_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a WideMesh needs at least one device")
        self.axis_names = (axis,)

    def __eq__(self, other) -> bool:
        return isinstance(other, WideMesh) and \
            (self.devices, self.axis_names) == (other.devices,
                                                other.axis_names)

    def __hash__(self) -> int:
        return hash((self.devices, self.axis_names))

    def __repr__(self) -> str:
        return (f"WideMesh({[str(d) for d in self.devices]}, "
                f"axis={self.axis_names[0]!r})")


def set_wide_mesh(mesh) -> None:
    """Install (or clear, with None) the default mesh of every sharded
    entry point (``core.aggregate.set_default_mesh`` stores here)."""
    global _WIDE_MESH
    _WIDE_MESH = mesh


def wide_mesh():
    """The installed default mesh, or None."""
    return _WIDE_MESH


def install_wide_mesh(n: int | None = None) -> WideMesh:
    """Install a mesh over the first ``n`` visible CUDA devices (all of
    them for None) and return it.  Raises when fewer than ``n`` (or no)
    devices are visible.  A 1-device mesh is safe: the sharded paths then
    take the single-device route."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n is None else int(n)
    if n < 1 or n > have:
        raise RuntimeError(f"install_wide_mesh({n}) needs {max(n, 1)} CUDA "
                           f"devices; {have} are visible")
    mesh = WideMesh([torch.device("cuda", i) for i in range(n)])
    set_wide_mesh(mesh)
    return mesh


def resolve_wide(mesh):
    """Resolve a mesh request to ``(mesh, size, axis)``.

    ``mesh=None`` falls back to the installed :func:`wide_mesh`; no mesh
    anywhere gives ``(None, 1, None)``, the single-device identity every
    sharded path degrades to.  An object without ``axis_names`` passes
    through with size 1 (the sharded paths then take the single-device
    route).  A mesh must be 1-D: the wide paths round-robin rows over one
    axis, and a flattened 2-D mesh would scramble the shard-to-device map
    the arena's per-shard slabs key on."""
    if mesh is None:
        mesh = wide_mesh()
    if mesh is None:
        return None, 1, None
    names = getattr(mesh, "axis_names", None)
    if names is None:
        return mesh, 1, None
    if len(names) != 1:
        raise ValueError(f"wide sharding needs a 1-D mesh; got axes "
                         f"{names!r}")
    return mesh, len(mesh.devices), names[0]
