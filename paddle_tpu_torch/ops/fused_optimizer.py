"""Fused AdamW/LAMB updates: the hand-written CUDA kernels
(``csrc/fused_optimizer.cu``) and their plain PyTorch versions.

Counterpart of ``paddle_tpu/ops/fused_optimizer.py``.
:func:`fused_adamw_update` / :func:`fused_lamb_update` are drop-in
replacements for ``pure_adamw_update`` / ``pure_lamb_update``
(``parallel/train_step.py``): the same signatures, the same per-leaf
state layout ``{"m", "v", "count"}`` and the same bias corrections, and,
like the port's pure updates, they update params and moments IN PLACE.
``FLAGS_fused_optimizer`` makes ``DistributedTrainStep`` take them.

Leaves are grouped into buckets by (param dtype, moment dtype, decay
coefficient), as JAX groups them. Where the JAX package concatenates a
bucket into one flat buffer for its Pallas pass, the CUDA kernel takes a
device table of the leaves' pointers and updates each leaf where it lies
(one launch per bucket, no concatenation: see the kernel's note). On a
CPU tensor each leaf runs the plain version, the JAX reference's op
sequence (``_adamw_flat_ref`` / ``_lamb_flat_ref``), and the result is
copied into the leaf.

:func:`adamw_flat` / :func:`lamb_moments_flat` keep the JAX signatures
for one flat buffer; :func:`flatten_bucket` / :func:`unflatten_bucket`
are the JAX helpers, for callers that want one.

Every entry takes an optional ``skip``: a 0-dim bool tensor on the
leaves' device (the training sentinel's verdict). When it holds True the
kernel's blocks return before writing (``csrc/fused_optimizer.cu``) and
the plain versions select the old values with ``torch.where``, so params,
moments and the step's count or beta-pow pair stay bit-identical; False,
or no flag, gives the update as before. No host read decides it, so a
captured step keeps its one graph.

:func:`fused_eager_step` is the eager entry of the Paddle optimizers
(``optimizer/optimizer.py``: ``Adam``/``AdamW``/``Lamb.step()`` with
``FLAGS_fused_optimizer=1``): the optimizer's own per-parameter slots
are the kernel's leaves, updated in place, one launch per bucket.
"""
from __future__ import annotations

import ctypes
from typing import List

import torch

from ..monitor.stats import FUSED_OPTIMIZER_STEPS
from ..regularizer import L1Decay, L2Decay
from . import _build

__all__ = ["adamw_flat", "lamb_moments_flat", "fused_adamw_update",
           "fused_lamb_update", "flatten_bucket", "unflatten_bucket",
           "fused_eager_step", "fused_update_from_slots", "SlotTables",
           "ADAMW_LAUNCHES", "LAMB_LAUNCHES"]

# kernel launches since the last reset (the wrappers add one per launch)
ADAMW_LAUNCHES = 0
LAMB_LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# LAMB's r buffer holds at most this many elements, or the bucket's
# largest leaf if that is larger: a bucket is launched in groups of
# leaves that fit, and the buffer is reused from group to group
_R_CAP = 1 << 26
_lib = None


# -- flat buffer helpers ------------------------------------------------------

def flatten_bucket(leaves):
    """Concat raveled leaves into one 1-D buffer (shared dtype)."""
    if len(leaves) == 1:
        return leaves[0].reshape(-1)
    return torch.cat([x.reshape(-1) for x in leaves])


def unflatten_bucket(flat, shapes, dtype=None):
    """Split a flat buffer back into leaves of the given shapes (views of
    ``flat`` when ``dtype`` is None)."""
    out, off = [], 0
    for s in shapes:
        n = 1
        for d in s:
            n *= int(d)
        leaf = flat[off:off + n].reshape(s)
        out.append(leaf if dtype is None else leaf.to(dtype))
        off += n
    return out


# -- plain versions (the JAX references' op sequences) -----------------------

def _adamw_flat_reference(p, g, m, v, lr, bc1, bc2, *, b1, b2, eps, wd, l2,
                          eager_form, skip=None):
    """Plain version: the same op sequence the kernel runs, f32 math,
    results in the storage dtypes. lr, bc1, bc2 are f32 0-dim tensors;
    a True ``skip`` gives back p, m and v as they were."""
    p32, g32, m32, v32 = p.float(), g.float(), m.float(), v.float()
    if l2:
        g32 = g32 + l2 * p32
    m32 = b1 * m32 + (1.0 - b1) * g32
    v32 = b2 * v32 + (1.0 - b2) * (g32 * g32)
    if eager_form:
        step = (torch.sqrt(bc2) / bc1) * m32 / (torch.sqrt(v32) + eps)
    else:
        step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
    p32 = p32 * (1.0 - lr * wd) - lr * step
    out = p32.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)
    if skip is None:
        return out
    return tuple(torch.where(skip, old, new)
                 for old, new in zip((p, m, v), out))


def _lamb_flat_reference(p, g, m, v, bc1, bc2, *, b1, b2, eps, wd,
                         skip=None):
    """Plain version of the LAMB moment pass → (m, v, r f32); a True
    ``skip`` gives back m and v as they were (r is then not used)."""
    p32, g32 = p.float(), g.float()
    m32 = b1 * m.float() + (1.0 - b1) * g32
    v32 = b2 * v.float() + (1.0 - b2) * (g32 * g32)
    r = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps) + wd * p32
    nm, nv = m32.to(m.dtype), v32.to(v.dtype)
    if skip is not None:
        nm, nv = torch.where(skip, m, nm), torch.where(skip, v, nv)
    return nm, nv, r


# -- the kernels ---------------------------------------------------------------

def _load():
    global _lib
    if _lib is None:
        lib = _build.load("fused_optimizer")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        ll = ctypes.c_longlong
        lib.fused_adamw.argtypes = [p, i, ll, p, p] + [f] * 7 + [i] * 6 \
            + [p]
        lib.fused_adamw.restype = i
        lib.fused_lamb.argtypes = [p, i, ll, p, p] + [f] * 6 + [i] * 4 + [p]
        lib.fused_lamb.restype = i
        lib.fused_opt_chunk.argtypes = []
        lib.fused_opt_chunk.restype = ll
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _table(ps, gs, ms, vs, rs, chunk):
    """The kernel's leaf table (8 int64 per leaf) on the device, and the
    bucket's chunk count. Pinned and copied without a sync."""
    rows, c0 = _rows(ps, gs, ms, vs, rs, chunk)
    host = torch.tensor(rows, dtype=torch.int64).pin_memory()
    return host.to(ps[0].device, non_blocking=True), c0


def _check_leaves(ps, gs, ms, vs, what):
    dev = ps[0].device
    pdt, mdt = ps[0].dtype, ms[0].dtype
    for p, g, m, v in zip(ps, gs, ms, vs):
        if p.dtype != pdt or m.dtype != mdt or v.dtype != mdt:
            raise TypeError(f"{what}: a bucket holds one param dtype and one "
                            f"moment dtype, got {p.dtype}/{m.dtype}/{v.dtype}")
        if g.dtype not in (torch.float32, pdt):
            raise TypeError(f"{what}: grads must be f32 or the param dtype, "
                            f"got {g.dtype}")
        if p.dtype not in _DTYPES or m.dtype not in _DTYPES:
            raise TypeError(f"{what} takes f32 or bf16 params and moments, "
                            f"got {p.dtype}/{m.dtype}")
        if not (p.shape == g.shape == m.shape == v.shape):
            raise ValueError(f"{what}: leaf shapes differ: {tuple(p.shape)} "
                             f"{tuple(g.shape)} {tuple(m.shape)} "
                             f"{tuple(v.shape)}")
        for t in (p, g, m, v):
            if t.device != dev:
                raise ValueError(f"{what}: every leaf must lie on one device")
            if not t.is_contiguous():
                raise ValueError(f"{what} needs contiguous leaves")
    gdt = torch.float32 if all(g.dtype == torch.float32 for g in gs) \
        else pdt
    if any(g.dtype != gdt for g in gs):
        raise TypeError(f"{what}: a bucket's grads share one dtype")
    return _DTYPES[pdt], _DTYPES[gdt], _DTYPES[mdt]


def _grid(dev, chunks):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, min(chunks, sms * 8))


def _skip_ptr(skip, dev):
    """The kernel's skip pointer: 0 (null) for no flag, else the address
    of a 0-dim bool on the leaves' device."""
    if skip is None:
        return 0
    if skip.dtype != torch.bool or skip.numel() != 1 or skip.device != dev:
        raise ValueError("skip must be a one-element bool tensor on the "
                         "leaves' device")
    return skip.data_ptr()


def _launch_adamw(ps, gs, ms, vs, sc, *, b1, b2, eps, wd, l2, eager_form,
                  tables=None, key=None, skip=None):
    global ADAMW_LAUNCHES
    dts = _check_leaves(ps, gs, ms, vs, "fused AdamW")
    lib = _load()
    if tables is None:
        table, chunks = _table(ps, gs, ms, vs, None, lib.fused_opt_chunk())
    else:
        table, chunks = tables.table(key, ps, gs, ms, vs,
                                     lib.fused_opt_chunk())
    if chunks == 0:
        return
    dev = ps[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_adamw(
            table.data_ptr(), len(ps), chunks, sc.data_ptr(),
            _skip_ptr(skip, dev), b1, 1.0 - b1,
            b2, 1.0 - b2, eps, wd, l2, int(bool(l2)), int(bool(eager_form)),
            *dts, _grid(dev, chunks), stream)
    _build.check(lib, err, "fused_adamw")
    ADAMW_LAUNCHES += 1


def _launch_lamb(ps, gs, ms, vs, rs, sc, *, b1, b2, eps, wd, skip=None):
    global LAMB_LAUNCHES
    dts = _check_leaves(ps, gs, ms, vs, "fused LAMB")
    for p, r in zip(ps, rs):
        if r.dtype != torch.float32 or r.shape != p.shape \
                or not r.is_contiguous() or r.device != p.device:
            raise ValueError("fused LAMB: r must be contiguous f32 leaves "
                             "shaped like the params, on their device")
    lib = _load()
    table, chunks = _table(ps, gs, ms, vs, rs, lib.fused_opt_chunk())
    if chunks == 0:
        return
    dev = ps[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_lamb(
            table.data_ptr(), len(ps), chunks, sc.data_ptr(),
            _skip_ptr(skip, dev), b1, 1.0 - b1,
            b2, 1.0 - b2, eps, wd, *dts, _grid(dev, chunks), stream)
    _build.check(lib, err, "fused_lamb")
    LAMB_LAUNCHES += 1


def _scalars(lr, bc1, bc2, dev):
    """[lr, bc1, bc2] as one f32 device tensor, made on the device (a
    Python lr becomes a fill, not a host copy)."""
    as_t = lambda x: (x.to(dev, torch.float32).reshape(())
                      if isinstance(x, torch.Tensor)
                      else torch.full((), float(x), dtype=torch.float32,
                                      device=dev))
    return torch.stack([as_t(lr), as_t(bc1), as_t(bc2)])


# -- bucket executors (in place) ----------------------------------------------

def _bucket_adamw(ps, gs, ms, vs, sc, *, b1, b2, eps, wd, l2=0.0,
                  eager_form=False, tables=None, key=None, skip=None):
    """AdamW over one bucket's leaves, in place: one kernel launch on the
    card (its leaf table from ``tables`` under ``key`` when given, else
    made for the call), the plain version leaf by leaf on the CPU."""
    kw = dict(b1=float(b1), b2=float(b2), eps=float(eps), wd=float(wd),
              l2=float(l2), eager_form=bool(eager_form))
    if ps[0].device.type == "cuda":
        _launch_adamw(ps, gs, ms, vs, sc, tables=tables, key=key,
                      skip=skip, **kw)
        return
    for p, g, m, v in zip(ps, gs, ms, vs):
        np_, nm, nv = _adamw_flat_reference(p, g, m, v, sc[0], sc[1], sc[2],
                                            skip=skip, **kw)
        p.copy_(np_)
        m.copy_(nm)
        v.copy_(nv)


def _lamb_groups(ps):
    """Leaf index groups of a bucket whose r fits one buffer: at most
    max(_R_CAP, the largest leaf) elements each."""
    cap = max([_R_CAP] + [p.numel() for p in ps])
    groups: List[List[int]] = [[]]
    used = 0
    for i, p in enumerate(ps):
        if groups[-1] and used + p.numel() > cap:
            groups.append([])
            used = 0
        groups[-1].append(i)
        used += p.numel()
    return groups, cap


def _apply_trust(p, r, lr, skip=None):
    """LAMB's per-leaf step, in place: p -= lr · ‖p‖/‖r‖ · r (the ratio
    is 1 when either norm is 0); a True ``skip`` keeps p (r is then
    whatever the buffer held)."""
    p32 = p.float()
    p_norm = torch.sqrt(torch.sum(torch.square(p32)))
    r_norm = torch.sqrt(torch.sum(torch.square(r)))
    trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                        torch.ones_like(p_norm))
    new = p32 - lr * trust * r
    if skip is not None:
        new = torch.where(skip, p32, new)
    p.copy_(new)


def _bucket_lamb(ps, gs, ms, vs, sc, *, b1, b2, eps, wd, skip=None):
    """LAMB moments over one bucket, in place; yields (leaf indices, their
    r tensors) group by group. On the card every group is one launch into
    one reused f32 buffer, so a group's r is valid only until the next
    group is taken."""
    kw = dict(b1=float(b1), b2=float(b2), eps=float(eps), wd=float(wd))
    if ps[0].device.type != "cuda":
        for i, (p, g, m, v) in enumerate(zip(ps, gs, ms, vs)):
            nm, nv, r = _lamb_flat_reference(p, g, m, v, sc[1], sc[2],
                                             skip=skip, **kw)
            m.copy_(nm)
            v.copy_(nv)
            yield [i], [r]
        return
    groups, cap = _lamb_groups(ps)
    buf = torch.empty(min(cap, sum(p.numel() for p in ps)),
                      dtype=torch.float32, device=ps[0].device)
    for idx in groups:
        rs, off = [], 0
        for i in idx:
            n = ps[i].numel()
            rs.append(buf[off:off + n].view(ps[i].shape))
            off += n
        _launch_lamb([ps[i] for i in idx], [gs[i] for i in idx],
                     [ms[i] for i in idx], [vs[i] for i in idx], rs, sc,
                     skip=skip, **kw)
        yield idx, rs


# -- flat entry points (the JAX signatures) -----------------------------------

def adamw_flat(p, g, m, v, lr, bc1, bc2, *, b1=0.9, b2=0.999, eps=1e-8,
               wd=0.0, l2=0.0, eager_form=False, skip=None):
    """One AdamW pass over a flat 1-D bucket, IN PLACE; returns (p, m, v).
    lr/bc1/bc2 are floats or 0-dim tensors. CUDA tensors launch the
    kernel; CPU tensors run the plain version. A True ``skip`` (0-dim
    bool on p's device) leaves p, m and v unwritten."""
    sc = _scalars(lr, bc1, bc2, p.device)
    _bucket_adamw([p], [g], [m], [v], sc, b1=b1, b2=b2, eps=eps, wd=wd,
                  l2=l2, eager_form=eager_form, skip=skip)
    return p, m, v


def lamb_moments_flat(p, g, m, v, bc1, bc2, *, b1=0.9, b2=0.999, eps=1e-6,
                      wd=0.0, skip=None):
    """The LAMB moment pass over a flat bucket: m and v IN PLACE; returns
    (m, v, r) with r the trust-ratio dividend in f32. A True ``skip``
    leaves m and v unwritten (and r undefined)."""
    sc = _scalars(0.0, bc1, bc2, p.device)
    (_, (r,)), = list(_bucket_lamb([p], [g], [m], [v], sc, b1=b1, b2=b2,
                                   eps=eps, wd=wd, skip=skip))
    return m, v, r


# -- tree-level updates (pure_adamw_update / pure_lamb_update parity) ---------

def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _bucket_indices(flat_p, flat_m, flat_wd):
    """Group leaf indices by (param dtype, moment dtype, decay coeff)."""
    buckets: dict = {}
    for i, (p, m, wd) in enumerate(zip(flat_p, flat_m, flat_wd)):
        buckets.setdefault((p.dtype, m.dtype, float(wd)), []).append(i)
    return buckets


def _flat_state(params, grads, state, weight_decay, decay_mask):
    paths = [path for path, _ in _paths(params)]
    flat_p = [_get(params, q) for q in paths]
    flat_g = [_get(grads, q) for q in paths]
    flat_m = [_get(state["m"], q) for q in paths]
    flat_v = [_get(state["v"], q) for q in paths]
    flat_wd = [weight_decay if decay_mask is None or _get(decay_mask, q)
               else 0.0 for q in paths]
    return paths, flat_p, flat_g, flat_m, flat_v, flat_wd


def _bias_corrections(state, beta1, beta2, skip=None):
    """Advance the count (not where ``skip`` holds True) and return the
    bias corrections at it."""
    if skip is None:
        state["count"] += 1
    else:
        state["count"] += (~skip).to(state["count"].dtype)
    c = state["count"].float()
    return 1.0 - beta1 ** c, 1.0 - beta2 ** c


@torch.no_grad()
def fused_adamw_update(params, grads, state, lr, beta1=0.9, beta2=0.999,
                       eps=1e-8, weight_decay=0.01, l2_coeff=0.0,
                       mv_dtype=None, decay_mask=None, skip=None):
    """pure_adamw_update drop-in, in place: one fused pass per (dtype,
    decay) bucket. ``mv_dtype`` different from the moments' dtype first
    casts them to it (as the JAX fused update does) and stores the cast
    moments in ``state``. A True ``skip`` leaves params, moments and the
    count as they were."""
    bc1, bc2 = _bias_corrections(state, beta1, beta2, skip)
    paths, flat_p, flat_g, flat_m, flat_v, flat_wd = _flat_state(
        params, grads, state, weight_decay, decay_mask)
    if mv_dtype is not None:
        for i, q in enumerate(paths):
            for key, flat in (("m", flat_m), ("v", flat_v)):
                if flat[i].dtype != mv_dtype:
                    flat[i] = flat[i].to(mv_dtype)
                    _put(state[key], q, flat[i])
    sc = _scalars(lr, bc1, bc2, flat_p[0].device)
    for (_, _, wd), idx in _bucket_indices(flat_p, flat_m, flat_wd).items():
        _bucket_adamw([flat_p[i] for i in idx], [flat_g[i] for i in idx],
                      [flat_m[i] for i in idx], [flat_v[i] for i in idx], sc,
                      b1=beta1, b2=beta2, eps=eps, wd=wd, l2=l2_coeff,
                      skip=skip)
    FUSED_OPTIMIZER_STEPS.add()
    return params, state


@torch.no_grad()
def fused_lamb_update(params, grads, state, lr, beta1=0.9, beta2=0.999,
                      eps=1e-6, weight_decay=0.01, decay_mask=None,
                      skip=None, **_):
    """pure_lamb_update drop-in, in place: the fused moment/direction pass
    per bucket, then the per-leaf trust ratio ‖p‖/‖r‖ (1 when either norm
    is 0) applied leaf by leaf. A True ``skip`` leaves params, moments
    and the count as they were."""
    bc1, bc2 = _bias_corrections(state, beta1, beta2, skip)
    _, flat_p, flat_g, flat_m, flat_v, flat_wd = _flat_state(
        params, grads, state, weight_decay, decay_mask)
    sc = _scalars(lr, bc1, bc2, flat_p[0].device)
    for (_, _, wd), idx in _bucket_indices(flat_p, flat_m, flat_wd).items():
        ps = [flat_p[i] for i in idx]
        for group, rs in _bucket_lamb(
                ps, [flat_g[i] for i in idx], [flat_m[i] for i in idx],
                [flat_v[i] for i in idx], sc, b1=beta1, b2=beta2, eps=eps,
                wd=wd, skip=skip):
            for j, r in zip(group, rs):
                _apply_trust(ps[j], r, lr, skip)
    FUSED_OPTIMIZER_STEPS.add()
    return params, state


# -- jit.TrainStep: the update from the optimizer's own slots -----------------

def _rows(ps, gs, ms, vs, rs, chunk):
    """The leaf table's rows (8 int64 per leaf) and the chunk count."""
    rows, c0 = [], 0
    for i, p in enumerate(ps):
        n = p.numel()
        r = rs[i].data_ptr() if rs is not None else 0
        rows += [p.data_ptr(), gs[i].data_ptr(), ms[i].data_ptr(),
                 vs[i].data_ptr(), r, n, c0, 0]
        c0 += -(-n // chunk)
    return rows, c0


class SlotTables:
    """The device leaf tables of one captured ``TrainStep``: one int64
    tensor per bucket, made once and kept alive with the step's graph.

    A table written while its stream is being captured cannot come from
    a host buffer (the captured copy would read it at every replay, long
    after it is gone), and the gradients' addresses are known only
    inside the capture, where autograd allocates them from the graph's
    pool. So the rows a table gets during the capture are kept aside,
    and :meth:`finalize` writes them once the capture has ended: the
    kernel node holds the table's address and reads its rows at every
    replay. Outside a capture (the uncaptured warm-up step) a table is
    made and written at once. The tables must be made there, before the
    capture: one allocated inside it could take the memory of a tensor
    freed earlier in the capture, which every replay writes before the
    kernel reads the table."""

    def __init__(self):
        self._tables: dict = {}
        self._pending: list = []

    def table(self, key, ps, gs, ms, vs, chunk):
        rows, chunks = _rows(ps, gs, ms, vs, None, chunk)
        entry = self._tables.get(key)
        capturing = torch.cuda.is_current_stream_capturing()
        if entry is None or entry[1] != rows:
            if entry is not None and entry[0].numel() == len(rows):
                t = entry[0]
            elif capturing:
                raise RuntimeError(
                    "SlotTables: a bucket's table must be made before the "
                    "capture (run the step once uncaptured first)")
            else:
                t = torch.empty(len(rows), dtype=torch.int64,
                                device=ps[0].device)
            self._tables[key] = (t, rows)
            if capturing:
                self._pending.append((t, rows))
            else:
                t.copy_(torch.tensor(rows, dtype=torch.int64))
        return self._tables[key][0], chunks

    def finalize(self):
        """Write the rows kept aside during the capture (call after it)."""
        for t, rows in self._pending:
            t.copy_(torch.tensor(rows, dtype=torch.int64))
        self._pending = []


@torch.no_grad()
def fused_update_from_slots(opt, param_names, params, grads, slots, lr,
                            hyper, tables=None, skip=None):
    """Fused Adam/AdamW over ``jit.TrainStep``'s named state, in place
    (``paddle_tpu/ops/fused_optimizer.py:421``).

    ``params[k]`` is a Parameter, ``grads[k]`` a torch tensor, ``slots[k]`` the optimizer's own ``[moment1,
    moment2, beta1_pow, beta2_pow]``, ``lr`` a 0-dim f32 device tensor
    and ``hyper[k]`` the parameter's hyperparameter items. Buckets are
    keyed by (param dtype, moment dtype, decay coefficient, eps), so
    AdamW's ``apply_decay_param_fun`` exclusions get their own; the port
    adds the parameter's L2 regularizer coefficient and lr multiplier
    to the key, as its eager step does. The first leaf's beta-pow pair
    gives the bias corrections, and every leaf's pair becomes that pair
    times β after the update, as in JAX. One kernel launch per bucket on
    the card, its leaf table from ``tables`` (:class:`SlotTables`) when
    given; on the CPU each leaf runs the plain version. A True ``skip``
    leaves params and every slot (beta pows included) as they were."""
    k0 = param_names[0]
    b1p, b2p = slots[k0][2], slots[k0][3]
    h0 = dict(hyper[k0])
    b1, b2 = float(h0["b1"]), float(h0["b2"])
    data = {k: params[k]._data for k in param_names}
    buckets: dict = {}
    for k in param_names:
        h, p = dict(hyper[k]), params[k]
        reg = p.regularizer if p.regularizer is not None \
            else opt._weight_decay
        l2 = (float(reg.coeff) if isinstance(reg, L2Decay)
              and not opt._decoupled_wd() else 0.0)
        mult = float(p.optimize_attr.get("learning_rate", 1.0))
        key = (data[k].dtype, slots[k][0].dtype, float(h.get("coeff", 0.0)),
               float(h["eps"]), l2, mult)
        buckets.setdefault(key, []).append(k)
    lr = lr.reshape(()).float()
    bc = torch.stack([1.0 - b1p, 1.0 - b2p])
    for key, keys in buckets.items():
        _, _, wd, eps, l2, mult = key
        sc = torch.cat([(lr if mult == 1.0 else lr * mult).reshape(1), bc])
        _bucket_adamw([data[k] for k in keys],
                      [grads[k].contiguous() for k in keys],
                      [slots[k][0] for k in keys], [slots[k][1] for k in keys],
                      sc, b1=b1, b2=b2, eps=eps, wd=wd, l2=l2,
                      eager_form=True, tables=tables, key=key, skip=skip)
    nb1, nb2 = b1p * b1, b2p * b2
    for k in param_names:
        if skip is None:
            slots[k][2].copy_(nb1)
            slots[k][3].copy_(nb2)
        else:
            slots[k][2].copy_(torch.where(skip, slots[k][2], nb1))
            slots[k][3].copy_(torch.where(skip, slots[k][3], nb2))


# -- eager Optimizer.step (the Paddle surface) --------------------------------

class _FusedEagerState:
    """Per-optimizer bucket layout over the optimizer's own slots.

    Built from the optimizer's per-parameter slots (so a half-trained
    optimizer can switch the flag on mid-run). Buckets are keyed as the
    JAX package keys them: (param dtype, moment dtype, decay coefficient,
    eps, L2 coefficient, lr multiplier). The kernels update the params
    and the moment slots in place, so the moments in
    ``opt._accumulators`` stay current; the step keeps one beta-pow pair
    (the first parameter's, as in JAX), which :meth:`sync_slots` writes
    back into every parameter's slots for ``state_dict()``."""

    def __init__(self, opt, params_grads, kind):
        self.kind = kind                      # "adam" | "lamb"
        self.params = [p for p, _ in params_grads]
        self.sig = _signature(params_grads)
        buckets: dict = {}
        for i, p in enumerate(self.params):
            h = opt._hyper(p)
            reg = (p.regularizer if p.regularizer is not None
                   else opt._weight_decay)
            l2 = (float(reg.coeff) if isinstance(reg, L2Decay)
                  and not opt._decoupled_wd() else 0.0)
            m = opt._get_slots(p)[0]
            key = (p.dtype, m.dtype, float(h.get("coeff", h.get("wd", 0.0))),
                   float(h["eps"]), l2,
                   float(p.optimize_attr.get("learning_rate", 1.0)))
            buckets.setdefault(key, []).append(i)
        self.buckets = list(buckets.items())
        self.b1, self.b2 = float(opt._beta1), float(opt._beta2)
        self.ms, self.vs = [], []
        for _, idx in self.buckets:
            slots = [opt._get_slots(self.params[i]) for i in idx]
            self.ms.append([s[0] for s in slots])
            self.vs.append([s[1] for s in slots])
        s0 = opt._get_slots(self.params[0])
        self.b1p, self.b2p = s0[2].clone(), s0[3].clone()

    def step(self, grads, lr):
        """One fused step; ``b1p``/``b2p`` hold βᵗ when it runs."""
        bc1, bc2 = 1.0 - self.b1p, 1.0 - self.b2p
        for bi, ((_, _, wd, eps, l2, lr_mult), idx) in enumerate(
                self.buckets):
            ps = [self.params[i]._data for i in idx]
            gs = [grads[i] for i in idx]
            blr = lr * lr_mult
            sc = _scalars(blr, bc1, bc2, ps[0].device)
            if self.kind == "adam":
                _bucket_adamw(ps, gs, self.ms[bi], self.vs[bi], sc,
                              b1=self.b1, b2=self.b2, eps=eps, wd=wd, l2=l2,
                              eager_form=True)
                continue
            for group, rs in _bucket_lamb(ps, gs, self.ms[bi], self.vs[bi],
                                          sc, b1=self.b1, b2=self.b2,
                                          eps=eps, wd=wd):
                for j, r in zip(group, rs):
                    _apply_trust(ps[j], r, blr)
        self.b1p.mul_(self.b1)
        self.b2p.mul_(self.b2)

    def sync_slots(self, opt):
        """Write the shared beta-pow pair into every parameter's slots
        (the moments are the slots themselves)."""
        for p in self.params:
            slots = opt._get_slots(p)
            slots[2].copy_(self.b1p)
            slots[3].copy_(self.b2p)


def _signature(params_grads):
    return tuple((id(p), tuple(p.shape), p.dtype) for p, _ in params_grads)


@torch.no_grad()
def fused_eager_step(opt, params_grads, lr) -> bool:
    """The fused step of an eager Adam/AdamW/Lamb ``step()``: params and
    moments updated in place, one kernel launch per bucket on the card.
    Returns False (the caller runs its per-parameter loop) when a
    parameter carries an L1 regularizer, which the kernels do not
    cover."""
    if not params_grads:
        return True
    for p, _ in params_grads:
        reg = p.regularizer if p.regularizer is not None else \
            opt._weight_decay
        if isinstance(reg, L1Decay):
            return False
    kind = "lamb" if type(opt).__name__ == "Lamb" else "adam"
    st = opt._fused_state
    if st is None or st.sig != _signature(params_grads):
        if st is not None and opt._slots_stale:
            st.sync_slots(opt)
        st = _FusedEagerState(opt, params_grads, kind)
        opt._fused_state = st
    st.step([g._data.contiguous() for _, g in params_grads], lr)
    FUSED_OPTIMIZER_STEPS.add()
    opt._slots_stale = True
    return True
