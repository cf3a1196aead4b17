"""Shared helpers of the op lowerings.

Counterpart of ``paddle_tpu/ops/common.py``: dtype attrs, Fluid's
elementwise broadcast, and the dropout op's byte-quantised keep
probability (``realized_prob:67``, ``realized_keep_prob:78``).  The byte
draw itself (the reference's ``bernoulli_bytes:91``) is
``kernels/philox.py`` ``keep_bytes``, from the port's Philox stream."""

from ..framework import convert_np_dtype_to_dtype_, dtype_to_torch

# fluid VarType dtype enum (framework.proto:107-125) <-> dtype name, as in
# paddle_tpu/ops/common.py, so programs using integer dtype codes load
_DTYPE_ENUM = {0: "bool", 1: "int16", 2: "int32", 3: "int64", 4: "float16",
               5: "float32", 6: "float64", 19: "int64", 20: "uint8",
               21: "int8", 22: "bfloat16"}
_DTYPE_TO_ENUM = {"bool": 0, "int16": 1, "int32": 2, "int64": 3,
                  "float16": 4, "float32": 5, "float64": 6, "uint8": 20,
                  "int8": 21, "bfloat16": 22}


def attr_dtype(v, default="float32"):
    """A dtype attr (int enum, name) as a torch dtype."""
    if v is None:
        return dtype_to_torch(default)
    if isinstance(v, int):
        return dtype_to_torch(_DTYPE_ENUM[v])
    return dtype_to_torch(convert_np_dtype_to_dtype_(v))


def dtype_enum(name):
    return _DTYPE_TO_ENUM[name]


def bcast_y(x, y, axis=-1):
    """Fluid elementwise broadcast (elementwise_op.h): y's dims align with
    a contiguous run of x's dims starting at ``axis`` (-1: rightmost);
    trailing unit dims of y are squeezed first."""
    if x.shape == y.shape or y.dim() == 0:
        return y
    yshape = list(y.shape)
    while len(yshape) > 1 and yshape[-1] == 1:
        yshape.pop()
    ax = x.dim() - len(yshape) if axis == -1 else axis
    return y.reshape([1] * ax + yshape + [1] * (x.dim() - ax - len(yshape)))


def byte_threshold(keep_prob):
    """The byte threshold of the dropout op's keep draw: keep iff a byte
    of the stream < round(keep_prob * 256), in 0..256."""
    return min(max(int(round(float(keep_prob) * 256.0)), 0), 256)


def realized_prob(keep_prob):
    """The keep probability the byte draw actually samples with,
    round(keep_prob * 256) / 256 in [0, 1] (the reference's
    ``realized_prob``: the downgrade_in_infer sampling distribution)."""
    return byte_threshold(keep_prob) / 256.0


def realized_keep_prob(keep_prob):
    """The byte draw's keep probability as the upscale DIVISOR, clamped
    to >= 1/256 so an all-dropped draw gives exact zeros, never 0/0 (the
    reference's ``realized_keep_prob``)."""
    return max(byte_threshold(keep_prob), 1) / 256.0
