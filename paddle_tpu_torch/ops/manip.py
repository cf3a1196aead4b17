"""Shape ops, gather, one_hot and the embedding lookups: reshape2,
transpose2, unsqueeze2, squeeze2, concat, split, stack, reverse, slice,
expand, gather, lookup_table, embedding_bag, one_hot.

Counterpart of ``paddle_tpu/ops/manip.py`` (``reshape2:69``,
``transpose2:101``, ``concat:113``, ``split:142``, ``slice:156``,
``squeeze2:203``, ``unsqueeze2:214``, ``stack:252``, ``expand:265``,
``gather:284``, ``lookup_table:322``, ``embedding_bag:345``,
``one_hot:370``, ``reverse:410``).  Most gradients are the
synthesized vjp replays: gather's and lookup_table's accumulate repeated
indices (in a varying order where the card adds them with atomics).
``concat_grad`` (a split of the output gradient) and
``embedding_bag_grad`` are written out: the bag's forward may be a CUDA
kernel, which a replay cannot trace.  The
``XShape`` outputs are placeholders for the grad ops, as in the reference:
the lowerings leave them unset.  Reshape and transpose return views where
PyTorch can; a consumer that needs contiguous memory makes it so.
"""

import torch
import torch.nn.functional as F

from .. import flags
from ..core.registry import register_grad_lowering, register_op, wants_grad
from ..kernels.embedding_bag import bag_checks, embedding_bag as bag_kernel
from .common import attr_dtype


def _resolve_shape(x, shape):
    """Fluid reshape: 0 copies the input dim, one -1 is inferred."""
    shape = [int(s) for s in shape]
    for i, s in enumerate(shape):
        if s == 0:
            shape[i] = x.shape[i]
    return shape


def _reshape_infer(op, block):
    """Static shapes of reshape2 (the reference's ``_reshape_infer``): 0
    copies the input dim (-1 for a batch dim), a -1 is resolved only when
    the input shape is fully known; XShape is [0] + the input shape."""
    x = block.var(op.input("X")[0])
    out = block.var(op.output("Out")[0])
    xshape = list(x.shape or [])
    res = [(xshape[i] if i < len(xshape) else -1) if s == 0 else s
           for i, s in enumerate(op.attr("shape") or [])]
    if -1 in res and -1 not in xshape:
        known = 1
        for s in res:
            if s != -1:
                known *= s
        total = 1
        for d in xshape:
            total *= d
        res[res.index(-1)] = total // known
    out.shape = tuple(res)
    if out.dtype is None:
        out.dtype = x.dtype
    xs_names = op.output("XShape")
    if xs_names:
        xs = block.var(xs_names[0])
        xs.shape = tuple([0] + xshape)
        if xs.dtype is None:
            xs.dtype = x.dtype


@register_op("reshape2", inputs=("X", "Shape", "ShapeTensor"),
             outputs=("Out", "XShape"), attrs={"shape": []},
             optional_inputs=("Shape", "ShapeTensor"),
             duplicable_inputs=("ShapeTensor",), infer_shape=_reshape_infer)
def reshape2(ctx, x, shape_t, shape_tensor, shape=()):
    return x.reshape(_resolve_shape(x, shape)), None


def _transpose_infer(op, block):
    x = block.var(op.input("X")[0])
    out = block.var(op.output("Out")[0])
    if x.shape is not None:
        out.shape = tuple(x.shape[a] for a in op.attr("axis"))
    if out.dtype is None:
        out.dtype = x.dtype
    xs_names = op.output("XShape")
    if xs_names:
        xs = block.var(xs_names[0])
        xs.shape = tuple([0] + list(x.shape or []))
        xs.dtype = x.dtype


@register_op("transpose2", inputs=("X",), outputs=("Out", "XShape"),
             attrs={"axis": []}, infer_shape=_transpose_infer)
def transpose2(ctx, x, axis=()):
    return x.permute(*axis), None


@register_op("unsqueeze2", inputs=("X", "AxesTensor"),
             outputs=("Out", "XShape"), attrs={"axes": []},
             optional_inputs=("AxesTensor",))
def unsqueeze2(ctx, x, axes_t, axes=()):
    # as jnp.expand_dims: the axes index the OUTPUT, applied in order
    out_ndim = x.dim() + len(axes)
    for a in sorted(a if a >= 0 else a + out_ndim for a in axes):
        x = x.unsqueeze(a)
    return x, None


def _squeeze_axes(x, axes):
    """The dims squeeze2 drops: those of ``axes`` (negative ones from the
    end) that have size 1, or every size-1 dim without ``axes``."""
    if axes:
        axes = [a if a >= 0 else a + x.dim() for a in axes]
        return tuple(a for a in axes if x.shape[a] == 1)
    return tuple(i for i, d in enumerate(x.shape) if d == 1)


@register_op("squeeze2", inputs=("X",), outputs=("Out", "XShape"),
             attrs={"axes": []})
def squeeze2(ctx, x, axes=()):
    """x without the size-1 dims of ``axes`` (a listed dim of another size
    stays, as ``jnp.squeeze`` over the filtered axes)."""
    dims = _squeeze_axes(x, axes)
    return (x.squeeze(dims) if dims else x), None


@register_op("reverse", inputs=("X",), outputs=("Out",), attrs={"axis": []})
def reverse(ctx, x, axis=()):
    return torch.flip(x, dims=[int(a) for a in axis])


@register_op("stack", inputs=("X",), outputs=("Y",), attrs={"axis": 0},
             duplicable_inputs=("X",))
def stack(ctx, xs, axis=0):
    return torch.stack(xs, dim=axis)


def _split_infer(op, block):
    """Each piece's static shape: the split dim divided by ``num``, or the
    ``sections``' sizes (the reference's ``_split_infer``)."""
    x = block.var(op.input("X")[0])
    outs = [block.var(n) for n in op.output("Out")]
    axis = op.attr("axis") or 0
    num = op.attr("num") or 0
    sections = op.attr("sections") or []
    if x.shape is None:
        return
    ax = axis if axis >= 0 else axis + len(x.shape)
    dim = x.shape[ax]
    if num:
        sizes = [dim // num] * num if dim != -1 else [-1] * num
    else:
        sizes = list(sections)
    for o, s in zip(outs, sizes):
        shp = list(x.shape)
        shp[ax] = s
        o.shape = tuple(shp)
        if o.dtype is None:
            o.dtype = x.dtype


@register_op("split", inputs=("X", "AxisTensor", "SectionsTensorList"),
             outputs=("Out",),
             attrs={"axis": 0, "num": 0, "sections": []},
             optional_inputs=("AxisTensor", "SectionsTensorList"),
             duplicable_inputs=("SectionsTensorList",),
             duplicable_outputs=("Out",), infer_shape=_split_infer)
def split(ctx, x, axis_tensor, sections_list, axis=0, num=0, sections=()):
    """``num`` equal pieces along ``axis`` (the dim must divide), or
    pieces cut at the running sums of ``sections`` (``jnp.split`` at
    those indices: the last piece runs to the end of the dim).  As in the
    reference, the axis and the sections are the attrs: ``AxisTensor``
    and ``SectionsTensorList`` are accepted and not read."""
    axis = int(axis)
    if num:
        d = x.shape[axis]
        if d % int(num):
            raise ValueError("split: dim %d of size %d does not divide into "
                             "%d pieces" % (axis, d, num))
        return list(torch.split(x, d // int(num), dim=axis))
    cuts, total = [], 0
    for s in list(sections)[:-1]:
        total += int(s)
        cuts.append(total)
    return list(torch.tensor_split(x, cuts, dim=axis))


@register_op("concat", inputs=("X", "AxisTensor"), outputs=("Out",),
             attrs={"axis": 0}, duplicable_inputs=("X",),
             optional_inputs=("AxisTensor",))
def concat(ctx, xs, axis_tensor, axis=0):
    return torch.cat(xs, dim=axis)


@register_grad_lowering("concat")
def concat_grad(ctx, xs, axis_tensor, out, dout, axis=0):
    """Each input's slice of the output gradient (views of it)."""
    if dout is None:
        return [torch.zeros_like(x) for x in xs], None
    return list(torch.split(dout, [x.shape[axis] for x in xs],
                            dim=axis)), None


@register_op("slice", inputs=("Input", "StartsTensor", "EndsTensor"),
             outputs=("Out",),
             attrs={"axes": [], "starts": [], "ends": [],
                    "decrease_axis": [], "infer_flags": []},
             optional_inputs=("StartsTensor", "EndsTensor"))
def slice_op(ctx, input, starts_t, ends_t, axes=(), starts=(), ends=(),
             decrease_axis=(), infer_flags=()):
    """input[starts:ends] along ``axes`` (negative bounds count from the
    end, both clamped into the dim), ``decrease_axis`` squeezed.  The
    bounds are attrs; bounds given as tensors are not ported."""
    if starts_t is not None or ends_t is not None:
        raise NotImplementedError(
            "slice with StartsTensor / EndsTensor is not ported yet")
    idx = [slice(None)] * input.dim()
    for ax, st, en in zip(axes, starts, ends):
        d = input.shape[ax]
        st, en = int(st), int(en)
        if st < 0:
            st += d
        if en < 0:
            en += d
        idx[ax] = slice(min(max(st, 0), d), min(en, d))
    out = input[tuple(idx)]
    if decrease_axis:
        out = out.squeeze(tuple(decrease_axis))
        if out.dim() == 0:
            out = out.reshape(1)
    return out


@register_op("expand", inputs=("X", "ExpandTimes"), outputs=("Out",),
             attrs={"expand_times": []}, optional_inputs=("ExpandTimes",))
def expand(ctx, x, expand_times_t, expand_times=()):
    """x tiled ``expand_times[i]`` times along dim i (``jnp.tile``)."""
    reps = [int(t) for t in expand_times]
    return x.repeat(*([1] * (x.dim() - len(reps)) + reps))


@register_op("gather", inputs=("X", "Index"), outputs=("Out",),
             attrs={"overwrite": True}, no_grad_inputs=("Index",))
def gather(ctx, x, index, overwrite=True):
    idx = index.reshape(-1) if index.dim() > 1 else index
    return x.index_select(0, idx.long())


@register_op("lookup_table", inputs=("W", "Ids"), outputs=("Out",),
             attrs={"is_sparse": False, "is_distributed": False,
                    "padding_idx": -1, "remote_prefetch": False,
                    "entry_config": "", "entry": "none", "table_names": [],
                    "epmap": [], "height_sections": [], "trainer_id": 0},
             no_grad_inputs=("Ids",))
def lookup_table(ctx, w, ids, padding_idx=-1, **_):
    # fluid v1 lookup_table takes ids of shape [..., 1]
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    out = F.embedding(ids.long(), w)
    if padding_idx is not None and padding_idx >= 0:
        out = out.masked_fill((ids == padding_idx).unsqueeze(-1), 0.0)
    return out


def _bag_composed(w, ids):
    """The op's route without the kernel, the reference's jnp fallback: a
    masked gather of [B, K, D] summed over K."""
    g = w.index_select(0, ids.reshape(-1).long().clamp(min=0))
    g = g.reshape(tuple(ids.shape) + (w.shape[1],))
    return torch.where((ids >= 0).unsqueeze(-1), g, 0.0).sum(dim=1)


@register_op("embedding_bag", inputs=("W", "Ids"), outputs=("Out",),
             attrs={"mode": "sum"}, no_grad_inputs=("Ids",))
def embedding_bag(ctx, w, ids, mode="sum"):
    """Bagged lookup: Out[b] = sum_k W[Ids[b, k]] over Ids >= 0 (-1 pads
    ragged bags), the multi-hot read of the recommender path
    (``distributed/sparse_table.py`` ``lookup_bag``).  Under
    ``FLAGS_use_pallas_embedding_bag`` with ``bag_checks`` holding it is
    the embedding-bag kernel (its plain version on the CPU), else the
    masked gather + sum."""
    if mode != "sum":
        raise ValueError("embedding_bag supports mode='sum', got %r"
                         % (mode,))
    if flags.flag("FLAGS_use_pallas_embedding_bag") and all(
            ok for _, ok in bag_checks(tuple(w.shape), tuple(ids.shape),
                                       w.dtype)):
        return bag_kernel(w, ids)
    return _bag_composed(w, ids)


@register_grad_lowering("embedding_bag")
def embedding_bag_grad(ctx, w, ids, out, dout, mode="sum"):
    """dW: each bag's output gradient added into the row of each of its
    valid ids (``index_add_``; the card adds with atomics, in a varying
    order).  A pad adds into a spare row past the end, so no step waits
    on the device to count the valid ids."""
    if not wants_grad(ctx, "W"):
        return None, None
    u, d = w.shape
    grad = torch.zeros((u + 1, d), dtype=w.dtype, device=w.device)
    if dout is not None:
        idx = torch.where(ids >= 0, ids.long(), u).reshape(-1)
        src = dout.to(w.dtype).unsqueeze(1).expand(
            ids.shape[0], ids.shape[1], d).reshape(-1, d)
        grad.index_add_(0, idx, src)
    return grad[:u], None


@register_op("one_hot", inputs=("X", "depth_tensor"), outputs=("Out",),
             attrs={"depth": 1, "dtype": 5, "allow_out_of_range": False},
             optional_inputs=("depth_tensor",), grad_maker=None)
def one_hot(ctx, x, depth_t, depth=1, dtype=5, allow_out_of_range=False):
    """Fluid v1's one_hot as the reference lowers it: a trailing dim of 1
    is squeezed ([B, T, 1] -> [B, T, depth]), any other shape gets
    ``depth`` appended ([B, K] -> [B, K, depth]); an id outside
    [0, depth) gives a row of zeros."""
    idx = x
    if idx.dim() >= 2 and idx.shape[-1] == 1:
        idx = idx.squeeze(-1)
    classes = torch.arange(depth, device=idx.device)
    return (idx.long().unsqueeze(-1) == classes).to(attr_dtype(dtype))
