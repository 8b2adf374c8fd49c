"""Name-pattern parameter sharding rules: the port of the JAX package's
``dist/sharding.py``.

``RULES`` is an ordered list of ``(regex, dims)``.  The regex is searched
against the dotted parameter path (see :func:`path_str`); ``dims`` gives,
for each dim of the UNSTACKED leaf shape, a priority tuple of candidate
mesh axes (or None for always-replicated).  Resolution walks dims left to
right and assigns the first candidate axis that

  (a) exists in the mesh,
  (b) is not already used by an earlier dim of the same spec, and
  (c) divides the dim size exactly;

otherwise the dim stays replicated.  That single first-fit rule encodes
every fallback in one place: a 2-head KV projection drops the model axis,
an 8-expert MoE on a 16-way model axis falls through to tensor-parallel on
the ff dim, and ``pure_dp=True`` removes the model axis from every
candidate list.

The port's parameter tree is a state dict, one entry a layer
(``layers.3.mixer.wq``), so its leaves carry no repeats dim.  Params under
a scanned ``pattern.<i>.`` stack (the JAX package's layout) carry a
leading repeats dim, which is always replicated; the rule is kept, so a
tree of that layout resolves as there.  Params matching no rule -- or
matching with an unexpected rank -- are fully replicated.

A spec is a :class:`Spec`, an immutable tuple of ``None | axis | tuple of
axes`` (``tuple(jax.sharding.PartitionSpec(...))`` compares equal); a
sharding is a :class:`Sharding`, a ``(mesh, spec)`` pair whose
:meth:`Sharding.placements` are the DTensor placements, one a mesh dim.
Explicit ``overrides`` ({regex: spec}) win over the rules and are
validated strictly: a spec axis that does not divide its dim raises a
ValueError naming the param, the dim and the mesh axis sizes.

A tree is a dict (nested dicts and lists give dotted paths), or a
``models.transformer.DecodeState`` (``pos`` and ``layers.<i>.<name>``).
Leaves are anything with a ``shape``.
"""

from __future__ import annotations

import dataclasses
import math
import re

from repro_torch.dist.ctx import (MODEL_AXIS, axis_sizes_of, dp_axes_of,
                                  placements_for)

DATA = ("data",)
MODEL = ("model",)

# (regex searched in the dotted path, per-dim candidate axes for the
# unstacked shape).  Order matters only where patterns overlap.
RULES: list[tuple[str, tuple]] = [
    # attention / mlstm projections (d|di, H, hd): FSDP on dim0, TP heads
    (r"mixer\.(wq|wk|wv)$", (DATA, MODEL, None)),
    (r"mixer\.wo$", (MODEL, None, DATA)),
    (r"mixer\.(bq|bk|bv)$", (MODEL, None)),
    # MLA low-rank factors
    (r"mixer\.w_dq$", (DATA, MODEL)),
    (r"mixer\.w_dkv$", (DATA, None)),
    (r"mixer\.(w_uq|w_uk|w_uv)$", (DATA, MODEL, None)),
    # SSM / xLSTM mixers
    (r"mixer\.(in_proj|up)$", (DATA, MODEL)),
    (r"mixer\.(out_proj|down)$", (MODEL, DATA)),
    (r"mixer\.x_proj$", (MODEL, None)),
    (r"mixer\.dt_proj$", (None, MODEL)),
    (r"mixer\.conv_w$", (None, MODEL)),
    (r"mixer\.(wi|wf)$", (DATA, MODEL)),
    (r"mixer\.w$", (DATA, None, MODEL, None)),    # slstm (d, 4, h, dh)
    (r"mixer\.r$", (None, MODEL, None, None)),    # slstm (4, h, dh, dh)
    # dense FFN (also MoE shared experts via ffn.shared.*)
    (r"ffn(\.shared)?\.(w_gate|w_up|w_in)$", (DATA, MODEL)),
    (r"ffn(\.shared)?\.(w_down|w_out)$", (MODEL, DATA)),
    (r"ffn\.router$", (DATA, None)),
    # MoE expert stacks: expert-parallel over the model axis when the
    # expert count divides it, else tensor-parallel on the ff dim (the
    # first-fit resolver realises the fallback)
    (r"ffn\.(wg|wu)$", (MODEL, DATA, MODEL)),     # (E, d, ff)
    (r"ffn\.wd$", (MODEL, MODEL, DATA)),          # (E, ff, d)
    # embeddings / head / frontend
    (r"^embed$", (DATA, MODEL)),
    (r"^lm_head$", (DATA, MODEL)),
    (r"^frontend_proj$", (DATA, MODEL)),
]

_STACKED = re.compile(r"(^|\.)pattern\.\d+\.")


class Spec(tuple):
    """A partition spec: one entry a tensor dim, each None (replicated),
    a mesh axis name, or a tuple of axis names (the dim splits over them,
    major to minor).  Trailing dims past its length are replicated.
    ``Spec()`` is fully replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e if e is None or isinstance(e, str) else tuple(e)
            for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a mesh: the JAX package's ``NamedSharding``."""
    mesh: object
    spec: Spec

    def placements(self) -> tuple:
        """DTensor placements, one a mesh dim: ``Shard(i)`` on each mesh
        dim that tensor dim ``i`` names, ``Replicate()`` otherwise (and on
        a mesh dim of size 1: ``ctx.placements_for``)."""
        return placements_for(self.spec, self.mesh)

    def shard_shape(self, shape) -> tuple:
        """The shape of one device's shard of a ``shape`` leaf (every
        named axis divides its dim)."""
        sizes = axis_sizes_of(self.mesh)
        out = list(shape)
        for i, e in enumerate(self.spec):
            for a in ((e,) if isinstance(e, str) else tuple(e or ())):
                out[i] //= sizes[a]
        return tuple(out)


# ---------------------------------------------------------------------------
# paths
# ---------------------------------------------------------------------------

def path_str(path) -> str:
    """Dotted string for a key path: dict keys and sequence indices join
    with '.' -- 'layers.0.mixer.wq'."""
    return ".".join(str(k) for k in path)


def _is_state(tree) -> bool:
    return hasattr(tree, "pos") and hasattr(tree, "layers")


def map_with_path(fn, tree, path=()):
    """``fn(dotted path, leaf)`` over every leaf of ``tree`` (dicts, lists,
    tuples, a ``DecodeState``), keeping its structure; a dict's keys in
    sorted order, as ``jax.tree_util`` walks them (so the first leaf to
    raise is the JAX package's)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], path + (k,)) for k in
                sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    if _is_state(tree):
        return type(tree)(map_with_path(fn, tree.pos, path + ("pos",)),
                          map_with_path(fn, tree.layers,
                                        path + ("layers",)))
    return fn(path_str(path), tree)


# ---------------------------------------------------------------------------
# spec resolution
# ---------------------------------------------------------------------------

_axis_sizes = axis_sizes_of


def _resolve(dims, shape, sizes, pure_dp):
    used, out = set(), []
    for cands, n in zip(dims, shape):
        pick = None
        for ax in (cands or ()):
            if pure_dp and ax == MODEL_AXIS:
                continue
            sz = sizes.get(ax)
            if not sz or ax in used or n % sz:
                continue
            pick = ax
            used.add(ax)
            break
        out.append(pick)
    return out


def _check_spec(path: str, shape, spec, sizes) -> None:
    """Strict validation for explicit specs: every named axis must exist
    and divide its dim; raises a ValueError naming the offender."""
    if len(spec) > len(shape):
        raise ValueError(
            f"param {path!r}: spec {spec} has rank {len(spec)} but the "
            f"param has rank {len(shape)} (shape {tuple(shape)})")
    seen: set = set()
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        dup = seen.intersection(axes)
        if dup:
            raise ValueError(
                f"param {path!r}: spec {spec} maps mesh axis "
                f"{sorted(dup)[0]!r} to more than one dim")
        seen.update(axes)
        n = 1
        for a in axes:
            if a not in sizes:
                raise ValueError(
                    f"param {path!r}: spec axis {a!r} is not a mesh axis "
                    f"(mesh has {tuple(sizes)!r})")
            n *= sizes[a]
        if n > 1 and shape[i] % n:
            raise ValueError(
                f"param {path!r}: dim {i} (size {shape[i]}) is not "
                f"divisible by mesh axes {axes!r} (total size {n}); "
                f"adjust the mesh shape or the spec")


def spec_for_param(path: str, shape, mesh, *, pure_dp: bool = False,
                   overrides: dict | None = None) -> Spec:
    """Spec for one parameter, resolved from RULES (see module
    docstring).  ``overrides`` maps path regexes to explicit specs, which
    are validated strictly (non-divisible dims raise)."""
    sizes = _axis_sizes(mesh)
    shape = tuple(shape)
    if overrides:
        for pat, spec in overrides.items():
            if re.search(pat, path):
                _check_spec(path, shape, spec, sizes)
                return Spec(*spec)
    stacked = bool(_STACKED.search(path))
    for pat, dims in RULES:
        if re.search(pat, path):
            if len(shape) != len(dims) + (1 if stacked else 0):
                break           # rank mismatch: leave replicated
            body = shape[1:] if stacked else shape
            entries = _resolve(dims, body, sizes, pure_dp)
            if stacked:
                entries = [None] + entries
            return Spec(*entries)
    return Spec()               # no rule -> fully replicated


def replicated(mesh) -> Sharding:
    return Sharding(mesh, Spec())


def param_shardings(tree, mesh, *, pure_dp: bool = False,
                    overrides: dict | None = None):
    """Sharding tree for a parameter (or optimizer-moment) tree."""
    def leaf(path, l):
        return Sharding(mesh, spec_for_param(
            path, tuple(l.shape), mesh, pure_dp=pure_dp,
            overrides=overrides))
    return map_with_path(leaf, tree)


# ---------------------------------------------------------------------------
# batch / decode-state shardings
# ---------------------------------------------------------------------------

def data_axes(mesh, *, pure_dp: bool = False) -> tuple:
    """Axes a batch dim shards over: all but model/wide (all but wide
    under pure-dp) -- same derivation ``ctx.dp_axes`` applies to the
    current mesh."""
    return dp_axes_of(mesh, pure_dp)


def _batch_spec(path: str, shape, axes, sizes) -> Spec:
    if not shape or not axes:
        return Spec()
    n = math.prod(sizes[a] for a in axes)
    if n > 1 and shape[0] % n:
        raise ValueError(
            f"batch dim 0 of {path!r} (size {shape[0]}) is not divisible "
            f"by the data-parallel mesh axes {axes!r} (total size {n}); "
            f"pick a global batch that is a multiple of {n}")
    lead = axes[0] if len(axes) == 1 else axes
    return Spec(lead, *([None] * (len(shape) - 1)))


def batch_shardings(tree, mesh, *, pure_dp: bool = False):
    """Shard dim 0 of every batch leaf over the data-parallel axes; a
    non-divisible batch raises immediately with the axis sizes spelled
    out (silently replicating a batch is never what anyone wants)."""
    axes = data_axes(mesh, pure_dp=pure_dp)
    sizes = _axis_sizes(mesh)

    def leaf(path, l):
        return Sharding(mesh, _batch_spec(path, tuple(l.shape), axes,
                                          sizes))
    return map_with_path(leaf, tree)


def decode_state_shardings(tree, mesh, *, pure_dp: bool = False):
    """Decode caches: batch dim 0 over the data axes; attention KV-cache
    leaves ('k'/'v') additionally put the model axis on their head dim
    when it divides (dim 1 of the port's per-layer (B, Hkv, S, D) cache;
    dim 2 for batch-major layer stacks, which have rank 5).  MLA caches
    ('ckv'/'kr') have no head dim -- the latent is shared across heads --
    so only their batch dim shards."""
    axes = data_axes(mesh, pure_dp=pure_dp)
    sizes = _axis_sizes(mesh)
    msz = sizes.get(MODEL_AXIS, 0)

    def leaf(path, l):
        shape = tuple(l.shape)
        spec = _batch_spec(path, shape, axes, sizes)
        name = path.rsplit(".", 1)[-1]
        if (not pure_dp and msz > 1 and name in ("k", "v")
                and len(shape) in (4, 5)):
            hd = 1 if len(shape) == 4 else 2
            if shape[hd] % msz == 0:
                entries = list(spec) + [None] * (len(shape) - len(spec))
                entries[hd] = MODEL_AXIS
                spec = Spec(*entries)
        return Sharding(mesh, spec)
    return map_with_path(leaf, tree)


def leaves_with_path(tree) -> list:
    """[(dotted path, leaf)] of ``tree`` in its order."""
    out = []
    map_with_path(lambda p, l: out.append((p, l)), tree)
    return out


def distribute(tree, shardings):
    """Each leaf of ``tree`` (a whole tensor, on the mesh's device type or
    meta) as a DTensor placed by the matching leaf of ``shardings``."""
    from torch.distributed.tensor import distribute_tensor
    flat = dict(leaves_with_path(shardings))

    def leaf(path, t):
        s = flat[path]
        return distribute_tensor(t, s.mesh, s.placements())
    return map_with_path(leaf, tree)


def shard_module(module, mesh, *, pure_dp: bool = False) -> dict:
    """Swap each parameter of ``module`` in place for a DTensor parameter
    of the same name, placed by :func:`param_shardings` on ``mesh``
    (``requires_grad`` kept); returns the shardings by name."""
    import torch
    params = dict(module.named_parameters())
    shardings = param_shardings(params, mesh, pure_dp=pure_dp)
    placed = distribute({k: p.detach() for k, p in params.items()},
                        shardings)
    for name, p in params.items():
        mod_name, _, leaf = name.rpartition(".")
        module.get_submodule(mod_name)._parameters[leaf] = \
            torch.nn.Parameter(placed[name], requires_grad=p.requires_grad)
    return shardings
