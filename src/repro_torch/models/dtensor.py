"""The model's ops on DTensors: each hand-written kernel on its local
shards, and the explicit fall-backs to replicated inputs.

Under a mesh (``launch.train``) the parameters and the batch are
``DTensor``s and most ops propagate their placements through aten.  A
kernel knows nothing of DTensors, so each kernel call site goes through
``local_map``: the inputs are redistributed to a layout in which every
rank's local slice is a whole problem (batch rows over the data axes,
whole heads or channels over ``model``, everything else replicated), the
kernel's wrapper (``flash_attention``, ``rwkv6_scan``, ``ssm_scan``, and
through them ``FlashAttentionFn`` / ``Rwkv6ScanFn`` / ``SsmScanFn``, so
the backward kernels run too) is called on the local tensors, and the
outputs are wrapped back with that layout.  A parameter that every rank
reads whole while its batch rows or channels are split (``u``, ``A``,
Mamba's B and C) gets a ``Partial`` gradient, which the redistribution's
backward reduces.

Where DTensor has no sharding rule for an op, or only a wrong one, the op
runs on replicated inputs (:func:`replicated_call`, :func:`gather_rows`);
ROADMAP.md lists each such place as later performance work.

A :class:`PartitionSpec` (the port's own, entry for entry the
reference's) and :func:`to_placements`, its placements on a mesh, are
here too: the model's ``hidden_pspec`` and the data pipeline's batches
read them, and ``launch.shardings`` builds its spec trees from them.
"""
from __future__ import annotations

import contextlib
import threading
import types
from typing import Callable, Iterator, Optional, Sequence

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   local_map)


class PartitionSpec(tuple):
    """One entry per tensor dim (trailing dims may be left out): None
    (replicated), a mesh axis name, or a tuple of names (the dim split
    over several axes, major to minor).  A tuple of one name is that
    name, and an empty one None, as ``jax.sharding.PartitionSpec``
    normalizes them."""

    def __new__(cls, *parts):
        return super().__new__(cls, (_entry(p) for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def _entry(part):
    if isinstance(part, (tuple, list)):
        part = tuple(part)
        return None if not part else part[0] if len(part) == 1 else part
    return part


P = PartitionSpec


def to_placements(mesh, spec: Sequence, ndim: Optional[int] = None) -> tuple:
    """The DTensor placements of `spec` on `mesh`: ``Shard(d)`` on each
    mesh dim whose name the spec puts on tensor dim d, else
    ``Replicate()``.  A mesh dim of size 1 is ``Replicate()`` whatever
    the spec says: its one rank holds the whole dim either way, and
    DTensor's view rules refuse some shards of a size-1 mesh dim (a
    (1, S, d) batch split over one rank cannot be flattened).

    DTensor splits a dim over several mesh dims in mesh order, so a tuple
    entry must name its axes in the mesh's order; another order is a
    different layout and raises, as does an axis the mesh lacks, one
    named twice, or a spec longer than `ndim`."""
    names = tuple(mesh.mesh_dim_names)
    if ndim is not None and len(spec) > ndim:
        raise ValueError(f"spec {tuple(spec)} has more entries than the "
                         f"tensor's {ndim} dims")
    placements = [Replicate()] * len(names)
    seen = set()
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {tuple(spec)} names axis {a!r}; the "
                                 f"mesh has {names}")
            if a in seen:
                raise ValueError(f"spec {tuple(spec)} names axis {a!r} twice")
            seen.add(a)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(
                f"spec {tuple(spec)} splits dim {d} over {axes}, out of the "
                f"mesh's order {names}: DTensor shards a dim over mesh dims "
                f"in mesh order, so this layout has no placements")
        for i in pos:
            if mesh.size(i) > 1:
                placements[i] = Shard(d)
    return tuple(placements)


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


# open plain_as_replicated blocks, across threads: implicit_replication
# is one switch for the process, and its exit turns it off rather than
# back, so only the outermost block turns it on and off
_implicit = {"lock": threading.Lock(), "depth": 0, "ctx": None}


@contextlib.contextmanager
def plain_as_replicated(x) -> Iterator[None]:
    """Within the block a plain tensor meeting a DTensor counts as
    replicated (positions, masks, zero states), when `x` is a DTensor;
    re-entrant, unlike ``implicit_replication`` alone."""
    if not is_dtensor(x):
        yield
        return
    with _implicit["lock"]:
        if _implicit["depth"] == 0:
            _implicit["ctx"] = implicit_replication()
            _implicit["ctx"].__enter__()
        _implicit["depth"] += 1
    try:
        yield
    finally:
        with _implicit["lock"]:
            _implicit["depth"] -= 1
            if _implicit["depth"] == 0:
                _implicit["ctx"].__exit__(None, None, None)
                _implicit["ctx"] = None


def replicated_like(x, t: torch.Tensor) -> torch.Tensor:
    """t as a replicated DTensor on x's mesh when x is a DTensor (else t):
    for a plain tensor that an op keeps for its backward (RoPE's angles, a
    mask), since the backward runs outside :func:`plain_as_replicated`."""
    if not is_dtensor(x) or is_dtensor(t):
        return t
    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def _roles(lead, tensors: Sequence, split_dim: int) -> tuple:
    """Per mesh dim of `lead`: "batch" where it is Shard(0), "split"
    where every tensor of `tensors` is Shard(split_dim) (whole heads or
    channels a rank), else "rep"."""
    out = []
    for i, p in enumerate(lead.placements):
        if p == Shard(0):
            out.append("batch")
        elif all(is_dtensor(t) and t.placements[i] == Shard(split_dim)
                 for t in tensors):
            out.append("split")
        else:
            out.append("rep")
    return tuple(out)


def _pl(roles, batch, split, rep=None) -> tuple:
    rep = Replicate() if rep is None else rep
    return tuple({"batch": batch, "split": split, "rep": rep}[r]
                 for r in roles)


def _call_local(fn: Callable, mesh, args, in_pl, grad_pl, out_pl):
    """local_map of fn: placements per input (`in_pl`), per input's
    gradient (`grad_pl`) and per output (`out_pl`)."""
    return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=grad_pl, redistribute_inputs=True,
                     device_mesh=mesh)(*args)


def gather_seq(x: torch.Tensor) -> torch.Tensor:
    """x with its sequence gathered: a DTensor split on dim 1 (the
    sequence-parallel residual stream that ``Model._constrain`` leaves)
    replicated on those mesh dims, its other placements kept.  This is
    Megatron-SP's all-gather of the activations at a tensor-parallel
    block's entry: the column-parallel linear after it then splits its
    output features (whole heads or channels a rank), where on a
    sequence-split input DTensor would gather the weight instead."""
    if not is_dtensor(x) or Shard(1) not in x.placements:
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if p == Shard(1) else p for p in x.placements])


def chunk_last(x: torch.Tensor, chunks: int) -> tuple:
    """``x.chunk(chunks, dim=-1)``, each chunk split as x's last dim is.

    A column-parallel product's output (Mamba's ``in_proj``: u and z side
    by side) is split over one mesh dim of size m in m contiguous blocks,
    so rank r holds whole pieces of one or two chunks.  DTensor's rule for
    a chunk of a split dim replicates x; here each rank's piece of size
    ``last / (chunks * m)`` goes by one all-to-all to the rank that holds
    it in its chunk's split, and each chunk comes out ``Shard(last)`` on
    that mesh dim, its other placements x's.  A plain tensor, or a last
    dim split some other way, is chunked as ``x.chunk`` does."""
    if not is_dtensor(x):
        return x.chunk(chunks, dim=-1)
    mesh, last = x.device_mesh, x.dim() - 1
    dims = [i for i, p in enumerate(x.placements) if p == Shard(last)]
    if len(dims) != 1 or x.shape[last] % (chunks * mesh.size(dims[0])):
        return x.chunk(chunks, dim=-1)
    i = dims[0]
    m, j, group = mesh.size(i), mesh.get_local_rank(i), mesh.get_group(i)
    # piece q (chunk q // m, block q % m of that chunk) lies on rank
    # q // chunks and goes to rank q % m; a rank sends its pieces in the
    # order of their destinations and receives its chunks' blocks in
    # chunk order (their sources ascend with the chunk)
    mine = [j * chunks + h for h in range(chunks)]
    order = sorted(range(chunks), key=lambda h: (mine[h] % m, h))
    send = [sum(q % m == d for q in mine) for d in range(m)]
    recv = [sum((c * m + j) // chunks == s for c in range(chunks))
            for s in range(m)]
    pl = tuple(Replicate() if isinstance(p, Partial) else p
               for p in x.placements)

    def local(t):
        pieces = t.unflatten(-1, (chunks, -1)).movedim(-2, 0)
        out = funcol.wait_tensor(funcol.all_to_all_single_autograd(
            pieces[order].contiguous(), recv, send, group))
        return tuple(out.unbind(0))

    return _call_local(local, mesh, (x,), (pl,), (pl,), (pl,) * chunks)


def local_einsum(eq: str, *xs: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, *xs)`` on each rank's local shards, where every
    mesh dim splits one index letter and each operand holding that letter
    splits it there or is replicated (and sliced to that split), the
    others replicated: the output is split on the letter where it keeps
    it, else a partial sum; each gradient is split as its operand is, or
    a partial sum on a replicated operand.  DTensor
    folds batch and split head dims together into its bmm, which some of
    its versions refuse (torch 2.11: "Attempted to flatten multiple
    dimensions").  Plain tensors, or splits of any other kind, go to
    ``torch.einsum`` itself."""
    if not all(is_dtensor(x) for x in xs):
        return torch.einsum(eq, *xs)
    ins, out = eq.replace(" ", "").split("->")
    ins = ins.split(",")
    mesh = xs[0].device_mesh
    in_pl = [[] for _ in xs]
    grad_pl = [[] for _ in xs]
    out_pl = []
    for i in range(mesh.ndim):
        letters = {sub[p.dim] for sub, x in zip(ins, xs)
                   for p in [x.placements[i]] if isinstance(p, Shard)}
        if any(isinstance(x.placements[i], Partial) for x in xs) \
                or len(letters) > 1:
            return torch.einsum(eq, *xs)
        if not letters:
            for j in range(len(xs)):
                in_pl[j].append(Replicate())
                grad_pl[j].append(Replicate())
            out_pl.append(Replicate())
            continue
        (letter,) = letters
        for j, (sub, x) in enumerate(zip(ins, xs)):
            if letter in sub:
                # a replicated operand is sliced to the same split
                want = Shard(sub.index(letter))
                if x.placements[i] not in (want, Replicate()):
                    return torch.einsum(eq, *xs)
                in_pl[j].append(want)
                grad_pl[j].append(want)
            else:
                in_pl[j].append(Replicate())
                grad_pl[j].append(Partial())
        out_pl.append(Shard(out.index(letter)) if letter in out
                      else Partial())
    return _call_local(lambda *ts: torch.einsum(eq, *ts), mesh, xs,
                       tuple(map(tuple, in_pl)), tuple(map(tuple, grad_pl)),
                       (tuple(out_pl),))


def add_bias(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y + b, where y (a product) may hold a partial sum over a mesh dim
    that splits the bias b (a column-parallel product of an input split
    on its contracted dim: whisper's encoder takes its frames split over
    d_model).  y's partial sums are reduced first there: a split bias
    cannot be made a partial sum, which DTensor would need (torch 2.11
    raises)."""
    if is_dtensor(y) and is_dtensor(b) and any(
            isinstance(p, Partial) and isinstance(q, Shard)
            for p, q in zip(y.placements, b.placements)):
        y = y.redistribute(y.device_mesh, [
            Replicate() if isinstance(p, Partial) else p
            for p in y.placements])
    return y + b


def pinned(x: torch.Tensor) -> torch.Tensor:
    """x with each partial sum reduced (an all-reduce), its other
    placements kept, and its cotangent brought to that same placement in
    the backward; x itself on a plain tensor.  DTensor places a cotangent
    as the op's backward rule leaves it, which can be a layout no later
    backward can take:

    * after a row-parallel product whose narrow output feeds ops that
      need it whole (Mamba's ``x_proj``: the scan's B and C, dt's sum over
      channels), a partial cotangent, for which DTensor would gather the
      weight whole and reduce-scatter the full-width input gradient;
    * after the attention's heads are merged where they do not split
      over ``model`` (56 or 40 heads on 16 ranks), a cotangent split on
      the merged dim, which the merge's backward cannot unflatten."""
    if not is_dtensor(x):
        return x
    pl = tuple(Replicate() if isinstance(p, Partial) else p
               for p in x.placements)
    return _call_local(lambda t: t.view_as(t), x.device_mesh, (x,), (pl,),
                       (pl,), (pl,))


def local_nll(logits, labels):
    """-log softmax(logits)[..., label] at each position of DTensor
    `logits` (B, S, V) whose vocab no mesh dim splits (the vocab does not
    divide ``model``: internvl2's 92,553, whisper's 51,865); `labels` (B,
    S) holds indices into V.  Each rank takes its batch rows and, over
    each mesh dim that splits neither batch nor sequence, a block of the
    sequence where it divides (a partial sum is reduce-scattered into it,
    a replicated copy sliced), and runs the plain route's log-softmax and
    gather on that block.  DTensor's rules would build the gather's
    backward (its zeros) at the global (B, S, V) shape on every rank, and
    reduce a partial sum whole.  Returns a (B, S) DTensor placed as the
    block is."""
    mesh, s = logits.device_mesh, logits.shape[1]
    pl, parts = [], 1
    for i, p in enumerate(logits.placements):
        if isinstance(p, Shard) and p.dim == 1:
            parts *= mesh.size(i)
    for i, p in enumerate(logits.placements):
        if isinstance(p, Shard) and p.dim < 2:
            pl.append(p)
        elif mesh.size(i) > 1 and s % (parts * mesh.size(i)) == 0:
            pl.append(Shard(1))
            parts *= mesh.size(i)
        else:
            pl.append(Replicate())
    pl = tuple(pl)

    def local(lg, lab):
        logp = torch.log_softmax(lg.float(), dim=-1)
        return -torch.gather(logp, -1, lab[..., None].long())[..., 0]

    return _call_local(local, mesh, (logits, labels), (pl, pl), (pl, pl),
                       (pl,))


def split_heads(t: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    """(B, S, n_heads * head_dim) -> (B, S, n_heads, head_dim).  A DTensor
    whose flat dim is split over a mesh dim that does not divide the heads
    (2 KV heads on 4 ranks) is first replicated on that mesh dim, so that
    no rank holds part of a head."""
    b, s = t.shape[0], t.shape[1]
    if is_dtensor(t):
        mesh = t.device_mesh
        pl = list(t.placements)
        for i, p in enumerate(pl):
            if p == Shard(2) and n_heads % mesh.size(i):
                pl[i] = Replicate()
        if pl != list(t.placements):
            t = t.redistribute(mesh, pl)
    return t.reshape(b, s, n_heads, head_dim)


def write_position(cache: torch.Tensor, pos: int, new: torch.Tensor) -> None:
    """cache[:, pos] = new[:, 0], in place: a decode step's key or value
    written into a (B, S, ...) cache.  On a DTensor cache whose sequence
    is split (the flash-decode layout), only the rank holding position
    `pos` writes, into its local shard; `new` is first placed as the cache
    is, with its one position replicated."""
    if not is_dtensor(cache):
        cache[:, pos] = new[:, 0].to(cache.dtype)
        return
    mesh = cache.device_mesh
    new = new.redistribute(mesh, [Replicate() if p == Shard(1) else p
                                  for p in cache.placements])
    # this rank's block of the sequence: split over the Shard(1) mesh dims
    # in mesh order, major to minor
    coord, index, parts = mesh.get_coordinate(), 0, 1
    for i, p in enumerate(cache.placements):
        if p == Shard(1):
            index, parts = index * mesh.size(i) + coord[i], parts * mesh.size(i)
    if cache.shape[1] % parts:
        raise ValueError(f"cache {tuple(cache.shape)}: its sequence does not "
                         f"split evenly into {parts} blocks")
    n = cache.shape[1] // parts
    if index * n <= pos < (index + 1) * n:
        cache.to_local()[:, pos - index * n] = \
            new.to_local()[:, 0].to(cache.dtype)


def attention_kernel(fn: Callable, q, k, v):
    """fn(q, k, v) (the ``flash_attention`` wrapper) on each rank's local
    batch rows and whole heads: heads stay split over a mesh dim only
    where q, k and v all split them (GQA's head h reads KV head
    h // n_rep on the same rank then)."""
    roles = _roles(q, (q, k, v), 2)
    pl = _pl(roles, Shard(0), Shard(2))
    return _call_local(fn, q.device_mesh, (q, k, v), (pl, pl, pl),
                       (pl, pl, pl), (pl,))


def rwkv_kernel(fn: Callable, r, k, v, w, u):
    """fn(r, k, v, w, u) (the ``rwkv6_scan`` wrapper) on local batch rows
    and heads; u (H, hd) is read whole by every batch shard."""
    roles = _roles(r, (r, k, v, w), 2)
    x = _pl(roles, Shard(0), Shard(2))
    return _call_local(fn, r.device_mesh, (r, k, v, w, u),
                       (x, x, x, x, _pl(roles, Replicate(), Shard(0))),
                       (x, x, x, x, _pl(roles, Partial(), Shard(0))), (x,))


def ssm_kernel(fn: Callable, u, dt, a, b, c):
    """fn(u, dt, A, B, C) (the ``ssm_scan`` wrapper) on local batch rows
    and channels; A (D, N) is read whole by every batch shard, B and C
    (B, T, N) by every channel shard."""
    roles = _roles(u, (u, dt), 2)
    x = _pl(roles, Shard(0), Shard(2))
    a_in = _pl(roles, Replicate(), Shard(0))
    a_grad = _pl(roles, Partial(), Shard(0))
    bc_in = _pl(roles, Shard(0), Replicate())
    bc_grad = _pl(roles, Shard(0), Partial())
    return _call_local(fn, u.device_mesh, (u, dt, a, b, c),
                       (x, x, a_in, bc_in, bc_in),
                       (x, x, a_grad, bc_grad, bc_grad), (x,))


def channel_kernel(fn: Callable, like, rows, weight):
    """fn(rows, weight) -> (B, T, D) on `like`'s local batch rows and
    channels (like: a (B, T, D) DTensor split as ``ssm_kernel``'s u is);
    rows (B, T, k) is read whole by every channel shard, weight (D,) by
    every batch shard.  Mamba's dt = softplus(dt_raw + dt_bias): placing
    it here keeps it on each rank's channels (DTensor may replicate the
    broadcast add, and then the scan, whose roles follow dt), and runs
    softplus's backward on local tensors (DTensor decomposes it on
    replicated inputs: its global gradient on every rank)."""
    roles = _roles(like, (like,), 2)
    return _call_local(
        fn, like.device_mesh, (rows, weight),
        (_pl(roles, Shard(0), Replicate()), _pl(roles, Replicate(), Shard(0))),
        (_pl(roles, Shard(0), Partial()), _pl(roles, Partial(), Shard(0))),
        (_pl(roles, Shard(0), Shard(2)),))


def gather_rows(table, idx):
    """``table[idx]`` for a DTensor table: DTensor has no rule for an
    index into a split table, so the table is replicated and each rank
    gathers its own batch rows of `idx`."""
    mesh = table.device_mesh
    roles = tuple("batch" if is_dtensor(idx) and p == Shard(0) else "rep"
                  for p in (idx.placements if is_dtensor(idx)
                            else [Replicate()] * mesh.ndim))
    rows = _pl(roles, Shard(0), None)
    return _call_local(lambda t, i: t[i], mesh, (table, idx),
                       (_pl(roles, Replicate(), None), rows),
                       (_pl(roles, Partial(), None), rows), (rows,))


class _SumOverRanks(torch.autograd.Function):
    """The sum over the ranks of `groups` (one after another) of a value
    each rank holds a part of.  Backward: the cotangent itself.  The sum
    is replicated over the groups, so every rank holds the whole
    cotangent, and it is each part's gradient; an all-reduce in the
    backward would give the group's size times that."""

    @staticmethod
    def forward(ctx, x, groups):
        for g in groups:
            x = funcol.wait_tensor(funcol.all_reduce(x, "sum", g))
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def vocab_split_dims(logits) -> tuple:
    """The mesh dims (of size above 1) that split DTensor `logits`' last
    (vocab) dim; () for a plain tensor or a vocab kept whole."""
    if not is_dtensor(logits):
        return ()
    mesh, last = logits.device_mesh, logits.dim() - 1
    return tuple(i for i, p in enumerate(logits.placements)
                 if p == Shard(last) and mesh.size(i) > 1)


def vocab_parallel_nll(logits, labels):
    """-log softmax(logits)[..., label] at each position, from each rank's
    vocab shard of DTensor `logits` (B, S, V), which
    :func:`vocab_split_dims` splits; `labels` (B, S) holds indices into
    V.  No rank holds more than its shard: the max over V is the local
    max all-reduced (MAX) over the vocab dims, the sum of exp(logit -
    max) the local sum all-reduced (SUM), and the label's logit that of
    the rank whose vocab range holds it (0 elsewhere) all-reduced (SUM).
    Returns a (B, S) DTensor placed as the logits' batch and sequence
    are, replicated over the vocab dims; its gradient is the unsharded
    log-softmax's (the max takes none: it cancels)."""
    mesh = logits.device_mesh
    vdims = vocab_split_dims(logits)
    last = logits.dim() - 1
    lg_pl = tuple(Replicate() if isinstance(p, Partial) else p
                  for p in logits.placements)
    out_pl = tuple(p if isinstance(p, Shard) and p.dim < last
                   else Replicate() for p in lg_pl)
    # this rank's block of the vocab: split over the vocab dims in mesh
    # order, as DTensor's Shard chunks it (ceil-sized chunks)
    size, v0 = logits.shape[last], 0
    for i in vdims:
        chunk = -(-size // mesh.size(i))
        start = min(mesh.get_local_rank(i) * chunk, size)
        v0, size = v0 + start, max(min(chunk, size - start), 0)
    groups = [mesh.get_group(i) for i in vdims]

    def local(lg, lab):
        lg = lg.float()
        m = lg.detach().amax(dim=-1)
        for g in groups:
            m = funcol.wait_tensor(funcol.all_reduce(m, "max", g))
        se = _SumOverRanks.apply(torch.exp(lg - m[..., None]).sum(dim=-1),
                                 groups)
        idx = lab.long() - v0
        mine = (idx >= 0) & (idx < size)
        picked = torch.gather(lg, -1, idx.clamp(0, size - 1)[..., None])
        picked = _SumOverRanks.apply(
            torch.where(mine, picked[..., 0], 0.0), groups)
        return m + torch.log(se) - picked

    return _call_local(local, mesh, (logits, labels), (lg_pl, out_pl),
                       (lg_pl, out_pl), (out_pl,))


def replicated_call(fn: Callable, mesh, tensors: Sequence, n_out: int):
    """fn(*local tensors) with every input replicated on every mesh dim
    and each of its `n_out` outputs declared replicated: every rank runs
    the whole op."""
    rep = (Replicate(),) * mesh.ndim
    return _call_local(fn, mesh, tuple(tensors), (rep,) * len(tensors),
                       (rep,) * len(tensors), (rep,) * n_out)


def module_view(mod: torch.nn.Module, tensors: dict):
    """A stand-in for `mod` in which the parameters named in `tensors`
    (dotted names, as ``named_parameters()`` gives them) are those
    tensors, for a function that reads a module's parameters as
    attributes."""
    ns = types.SimpleNamespace(**{k: v for k, v in vars(mod).items()
                                  if not k.startswith("_")})
    vars(ns).update(mod._parameters)
    for k, sub in mod._modules.items():
        setattr(ns, k, None if sub is None else module_view(
            sub, {n[len(k) + 1:]: t for n, t in tensors.items()
                  if n.startswith(k + ".")}))
    vars(ns).update({n: t for n, t in tensors.items() if "." not in n})
    return ns
