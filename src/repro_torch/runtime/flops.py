"""FLOPs of a train step, counted by the rules of the reference's number.

The reference takes XLA's `cost_analysis()["flops"]` of its whole
compiled step: the loss, its gradient under the freeze plan and the
optimizer's update. XLA's `HloCostAnalysis` counts a dot or a
convolution by its multiply-adds (a convolution's window taps in its
input only), one FLOP per output element of an elementwise op (compare,
select and a convert between types included), and one per reduced input
element of a reduction. Transcendentals (`exp`, `log`, `tanh`, `sqrt`,
`rsqrt`, `erf`, a `pow` other than a square) go to a count of their own,
not to `flops`. Views, copies, broadcasts, concatenations, gathers and
scatters are free.

`StepFlopCounter` applies those rules to the ATen ops a step dispatches
on `meta` tensors, the backward's too: nothing is computed. The matmuls
and convolutions take torch's formulas (`flop_registry`), the
convolutions scaled to their in-bounds taps. A composite op without a
rule of its own (a GELU backward, a softmax) is counted through its ATen
decomposition, which spells it out in elementwise ops and reductions, as
the reference's JAX code does.

XLA's algebraic simplifier also computes an elementwise op whose
operands are all broadcasts of one value (a frozen leaf's zero
gradient, a filled tensor) as one scalar op, and folds a reduction of
such a broadcast into one multiply; the counter follows those
"uniform" tensors through views and ops and counts them the same way.

Running a step on `meta` tensors costs host time: torch's meta kernels
are Python, ~0.5 ms an op, ~3 s for a full-width MobileNetV2 step. A
step repeats most of its ops at the same shapes (a transformer's blocks,
the optimizer's update of leaves of one shape) and every plan and
session repeats them again, so the counter memoizes each functional op
by what decides its output and its count (the op, its arguments'
shapes, strides, types and uniformity, its other arguments) and on a
hit makes the outputs without running the op.

What the count cannot see is XLA's own recomputation: its fusion pass
copies an elementwise producer into every fusion that reads it, and the
cost analysis counts each copy. With every unit active that is 7.7%
(DeiT-tiny) to 17.2% (MobileNetV2) of XLA's count on the reduced models
(ROADMAP C.8). The port's programs
compute each value once, so the port counts it once; the tests hold the
count to XLA's less the recomputed instructions.
"""
from __future__ import annotations

import math
import weakref
from dataclasses import dataclass

import torch
from torch._decomp import decomposition_table
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

_MATMUL = (aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten.convolution,
           aten.convolution_backward)
# one FLOP an output element
_ELEMENTWISE = frozenset((
    aten.add, aten.sub, aten.rsub, aten.mul, aten.div, aten.neg, aten.abs,
    aten.maximum, aten.minimum, aten.clamp, aten.clamp_min, aten.clamp_max,
    aten.where, aten.eq, aten.ne, aten.gt, aten.ge, aten.lt, aten.le,
    aten.logical_and, aten.logical_or, aten.logical_not, aten.logical_xor,
    aten.bitwise_and, aten.bitwise_or, aten.bitwise_not, aten.bitwise_xor,
    aten.__and__, aten.__or__, aten.sign, aten.floor, aten.ceil, aten.round,
    aten.trunc, aten.remainder, aten.fmod, aten.reciprocal, aten.relu,
    aten.hardtanh, aten.square, aten.masked_fill, aten.isnan, aten.isinf,
    aten.floor_divide))
# one FLOP a reduced input element (input elements less output elements)
_REDUCTIONS = frozenset((
    aten.sum, aten.amax, aten.amin, aten.max, aten.min, aten.argmax,
    aten.argmin, aten.prod, aten.any, aten.all))
# transcendentals, views, copies, fills, gathers and scatters
_FREE = frozenset((
    aten.exp, aten.exp2, aten.log, aten.log2, aten.log1p, aten.expm1,
    aten.tanh, aten.sqrt, aten.rsqrt, aten.erf, aten.sin, aten.cos,
    aten.sigmoid, aten.view, aten.reshape, aten._unsafe_view, aten.expand,
    aten.permute, aten.transpose, aten.t, aten.slice, aten.select,
    aten.index, aten.index_select, aten.gather, aten.embedding, aten.cat,
    aten.stack, aten.constant_pad_nd, aten.clone, aten.detach, aten.alias,
    aten.unsqueeze, aten.squeeze, aten.empty, aten.empty_like,
    aten.empty_strided, aten.zeros, aten.zeros_like, aten.ones,
    aten.ones_like, aten.full, aten.full_like, aten.arange, aten.as_strided,
    aten.split, aten.split_with_sizes, aten.unbind, aten.new_zeros,
    aten.new_empty, aten.new_empty_strided, aten.new_full, aten.new_ones,
    aten.copy_, aten.fill_, aten.zero_, aten.lift_fresh, aten.scalar_tensor,
    aten.flip, aten.repeat, aten.diagonal, aten.scatter, aten.scatter_add,
    aten.index_put, aten.index_add, aten.slice_scatter, aten.select_scatter,
    aten.unfold, aten.roll, aten.tril, aten.triu))


_KNOWN = _ELEMENTWISE | _REDUCTIONS | _FREE


def _numel(t) -> int:
    return t.numel() if isinstance(t, torch.Tensor) else 0


@dataclass
class FlopCount:
    """A step's FLOPs: its matmuls and convolutions, and the rest."""
    matmul: int = 0
    elementwise: int = 0

    @property
    def total(self) -> int:
        return self.matmul + self.elementwise


def _taps_in_bounds(size: int, low: int, k: int, stride: int, out: int):
    """Window taps of a strided 1-D window over `out` outputs that land
    in an input of `size` padded by `low` in front."""
    return sum(max(0, min(k, size + low - o * stride)
                   - max(0, low - o * stride)) for o in range(out))


def _in_bounds_conv_formulas():
    """FlopCounterMode formulas that count a convolution's window taps
    as XLA's cost analysis does: only those that land in the input, not
    in the "SAME" padding that `F.pad` put around it (the CNNs pad apart
    from the convolution, models/cnn.py). Torch's own formulas count
    every tap; on the deep units' small maps (a 3x3 window over 2x2 has
    16 of its 36 taps in bounds) that overcounts them, and the count's
    ratios between freeze plans drift from the reference's. Torch's
    formulas are kept otherwise, and scaled by the in-bounds share."""
    padded = {}  # id of a padded map -> (its weakref, H, top, W, left)

    def pad(x, widths, *args, out_val=None, **kwargs):
        if x.dim() == 4 and len(widths) == 4:  # (left, right, top, bottom)
            padded[id(out_val)] = (weakref.ref(out_val), x.shape[2],
                                   widths[2], x.shape[3], widths[0])
        return 0

    def share(x, w, stride, out_hw):
        entry = padded.get(id(x))
        if entry is None or entry[0]() is not x:
            return 1.0
        _, h, top, wd, left = entry
        kh, kw = w.shape[2:]
        return (_taps_in_bounds(h, top, kh, stride[0], out_hw[0])
                * _taps_in_bounds(wd, left, kw, stride[1], out_hw[1])
                / (kh * kw * out_hw[0] * out_hw[1]))

    def conv(x, w, bias, stride, *args, out_val=None, **kwargs):
        full = flop_registry[aten.convolution](x, w, bias, stride, *args,
                                               out_val=out_val, **kwargs)
        return round(full * share(x, w, stride, out_val.shape[2:]))

    def conv_backward(grad_out, x, w, bias_sizes, stride, *args,
                      out_val=None, **kwargs):
        full = flop_registry[aten.convolution_backward](
            grad_out, x, w, bias_sizes, stride, *args, out_val=out_val,
            **kwargs)
        return round(full * share(x, w, stride, grad_out.shape[2:]))

    for f in (pad, conv, conv_backward):
        f._get_raw = True
    return {aten.constant_pad_nd: pad, aten.convolution: conv,
            aten.convolution_backward: conv_backward}


# ops that make a uniform tensor (one value broadcast), and ops whose
# output is uniform where their tensor inputs are
_FILLS = frozenset((
    aten.zeros, aten.zeros_like, aten.ones, aten.ones_like, aten.full,
    aten.full_like, aten.new_zeros, aten.new_ones, aten.new_full,
    aten.scalar_tensor, aten.fill_, aten.zero_))
_MOVES = frozenset((
    aten.view, aten.reshape, aten._unsafe_view, aten.expand, aten.permute,
    aten.transpose, aten.t, aten.slice, aten.select, aten.clone,
    aten.detach, aten.alias, aten.unsqueeze, aten.squeeze, aten.copy_,
    aten.lift_fresh, aten.to, aten._to_copy))


class StepFlopCounter(TorchDispatchMode):
    """Counts the FLOPs of the ATen ops dispatched inside it into
    `self.count` (module docstring). Run it over `meta` tensors."""

    def __init__(self, count: FlopCount = None, formulas=None,
                 uniform: dict = None):
        super().__init__()
        self.count = FlopCount() if count is None else count
        self.formulas = _in_bounds_conv_formulas() if formulas is None \
            else formulas
        # id of a uniform tensor -> its weakref
        self.uniform = {} if uniform is None else uniform

    def _is_uniform(self, t) -> bool:
        if not isinstance(t, torch.Tensor):
            return True  # a Python scalar
        if t.numel() == 1:
            return True
        entry = self.uniform.get(id(t))
        return entry is not None and entry() is t

    def _mark(self, out) -> None:
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.uniform[id(t)] = weakref.ref(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        key = self._memo_key(func, args, kwargs)
        hit = _MEMO.get(key) if key is not None else None
        if hit is not None:
            kind, outs, matmul, elementwise = hit
            made = [None if o is None else self._make(*o) for o in outs]
            self.count.matmul += matmul
            self.count.elementwise += elementwise
            return made[0] if kind is None else kind(made)
        before = (self.count.matmul, self.count.elementwise)
        out = self._dispatch(func, args, kwargs)
        if key is not None:
            kind, leaves = (None, (out,)) if isinstance(out, torch.Tensor) \
                else (type(out), out) if isinstance(out, (tuple, list)) \
                else (None, None)
            if leaves is not None and all(
                    o is None or isinstance(o, torch.Tensor)
                    and o.device.type == "meta" for o in leaves):
                if len(_MEMO) >= _MEMO_SIZE:
                    _MEMO.clear()
                _MEMO[key] = (kind, [
                    o if o is None else (tuple(o.shape), o.stride(),
                                         o.dtype, self._is_uniform(o))
                    for o in leaves], self.count.matmul - before[0],
                    self.count.elementwise - before[1])
        return out

    def _make(self, shape, stride, dtype, uniform):
        t = torch.empty_strided(shape, stride, dtype=dtype, device="meta")
        if uniform:
            self.uniform[id(t)] = weakref.ref(t)
        return t

    def _memo_key(self, func, args, kwargs):
        """What decides a functional op's outputs and count, or None for
        an op that is not memoized: one that writes or returns a view
        (its outputs must alias), a padding or a convolution (their
        counts read which maps were padded), or one with no `meta`
        tensor argument."""
        if not _memoizable(func):
            return None
        parts = [func]
        tensors = False
        for a in (*args, *kwargs.items()):  # a kwarg as (name, value)
            for b in a if isinstance(a, (tuple, list)) else (a,):
                if isinstance(b, (tuple, list)):  # a list in a list or a kwarg
                    parts.append(len(b))
                    if not all(c is None or isinstance(c, _HASHABLE)
                               for c in b):
                        return None
                    parts.extend(b)
                elif isinstance(b, torch.Tensor):
                    if b.device.type != "meta":
                        return None
                    tensors = True
                    parts.append((tuple(b.shape), b.stride(), b.dtype,
                                  self._is_uniform(b)))
                elif b is None or isinstance(b, _HASHABLE):
                    parts.append((type(b), b))
                else:
                    return None
            parts.append(None if isinstance(a, (tuple, list)) else ())
        return tuple(parts) if tensors else None

    def _dispatch(self, func, args, kwargs):
        op = func.overloadpacket
        if op in self.formulas or op in _MATMUL:
            out = func(*args, **kwargs)
            formula = self.formulas.get(op) or flop_registry[op]
            self.count.matmul += int(formula(*args, **kwargs, out_val=out))
            return out
        rule = _RULES.get(op)
        if rule is None and func in decomposition_table \
                and op not in _KNOWN:
            with StepFlopCounter(self.count, self.formulas, self.uniform):
                return decomposition_table[func](*args, **kwargs)
        tensors = [a for a in tree_leaves((args, kwargs))
                   if isinstance(a, torch.Tensor)]
        uniform = op in _FILLS or (
            tensors and all(self._is_uniform(t) for t in tensors)
            and (op in _MOVES or op in _ELEMENTWISE or op in _REDUCTIONS
                 or op in _RULES))
        if op in (aten.fill_, aten.zero_, aten.copy_):
            self.uniform.pop(id(args[0]), None)
        out = func(*args, **kwargs)
        first = tree_leaves(out)[0] if isinstance(out, (tuple, list)) \
            else out
        if uniform:
            # a scalar op broadcast, or a reduction folded to a multiply
            self._mark(out)
            if op not in _MOVES and op not in _FILLS:
                self.count.elementwise += 1
        elif rule is not None:
            self.count.elementwise += rule(args, kwargs, first)
        elif op in _ELEMENTWISE:
            self.count.elementwise += _numel(first)
        elif op in _REDUCTIONS:
            self.count.elementwise += _numel(args[0]) - _numel(first)
        return out


# the memo: an op's key -> (its outputs' tree, each output's shape,
# stride, type and uniformity, the matmul and elementwise FLOPs it added)
_MEMO: dict = {}
_MEMO_SIZE = 1 << 17
_MEMOIZABLE: dict = {}
_HASHABLE = (bool, int, float, str, torch.dtype, torch.device,
             torch.layout, torch.memory_format)


def _memoizable(func) -> bool:
    ok = _MEMOIZABLE.get(func)
    if ok is None:
        schema = func._schema
        ok = _MEMOIZABLE[func] = not (
            schema.is_mutable
            or any(r.alias_info is not None for r in schema.returns)
            or func.overloadpacket in (aten.constant_pad_nd,
                                       aten.convolution,
                                       aten.convolution_backward))
    return ok


def _convert(args, kwargs, out):
    """`to` / `_to_copy`: a convert when the type changes, else a copy."""
    return _numel(out) if out.dtype != args[0].dtype else 0


def _mean(args, kwargs, out):
    """The sum's adds, then one divide an output element."""
    return _numel(args[0])


def _var(args, kwargs, out):
    """A square an input element, the sum's adds and one divide an output
    element. Its centering subtract is left to the caller's own
    `x - mean`, which every normalization here computes and XLA's CSE
    shares with the variance's."""
    return 2 * _numel(args[0])


def _pow(args, kwargs, out):
    """A square is a multiply; any other power a transcendental."""
    return _numel(out) if not isinstance(args[1], torch.Tensor) \
        and args[1] == 2 else 0


def _max_pool(args, kwargs, out):
    """A reduce-window: window size - 1 compares an output element."""
    return (math.prod(args[1]) - 1) * _numel(out)


def _max_pool_backward(args, kwargs, out):
    """A select-and-scatter: the window's compares and one add a source
    element."""
    return math.prod(args[2]) * _numel(args[0])


_RULES = {aten.to: _convert, aten._to_copy: _convert, aten.mean: _mean,
          aten.var: _var, aten.pow: _pow,
          aten.max_pool2d_with_indices: _max_pool,
          aten.max_pool2d_with_indices_backward: _max_pool_backward}


def count_flops(fn, *args, **kwargs) -> FlopCount:
    """The FLOPs of `fn(*args, **kwargs)`, run on `meta` tensors."""
    counter = StepFlopCounter()
    with counter:
        fn(*args, **kwargs)
    return counter.count
