"""Graph IR of the port: Program / Block / Operator / Variable.

Counterpart of ``paddle_tpu/framework.py``.  The Python objects are the
IR, serialized as the same JSON (``to_dict``/``from_dict``), so a program
saved by either package loads into the other.  Execution interprets a
block op by op in eager PyTorch (``core/executor.py``).

Places: ``CPUPlace()`` runs the plain PyTorch path on the host;
``CUDAPlace(i)`` is card ``i``.  An executor given no place uses the card.
"""

import contextlib
import copy
import itertools
import threading

import numpy as np
import torch

from .utils import unique_name

__all__ = [
    "Program", "Block", "Operator", "Variable", "Parameter", "VarTypes",
    "OpRole", "OP_ROLE_KEY", "OP_ROLE_VAR_KEY", "GRAD_SUFFIX",
    "CPUPlace", "CUDAPlace",
    "default_main_program", "default_startup_program", "program_guard",
    "switch_main_program", "switch_startup_program",
    "convert_np_dtype_to_dtype_", "dtype_to_np",
    "dtype_to_torch", "torch_dtype_name",
]

# -- dtypes: a var's dtype is a numpy dtype name ('float32', ...) ----------

_SUPPORTED_DTYPES = ("bool", "int8", "uint8", "int16", "int32", "int64",
                     "float16", "bfloat16", "float32", "float64")

_TORCH_DTYPES = {
    "bool": torch.bool, "int8": torch.int8, "uint8": torch.uint8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
}
_TORCH_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def convert_np_dtype_to_dtype_(dtype):
    """Normalize a dtype spec (numpy dtype, str, torch dtype) to its name."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return torch_dtype_name(dtype)
    name = dtype if isinstance(dtype, str) else getattr(dtype, "name", None)
    if name is None:
        name = np.dtype(dtype).name
    if "bfloat16" in str(name):
        return "bfloat16"
    if name not in _SUPPORTED_DTYPES:
        raise TypeError("unsupported dtype: %r" % (dtype,))
    return name


def dtype_to_np(dtype):
    """numpy dtype for a dtype name; bfloat16, which numpy lacks, is held
    as float32 on the host."""
    return np.dtype("float32" if dtype == "bfloat16" else dtype)


def dtype_to_torch(dtype):
    return _TORCH_DTYPES[convert_np_dtype_to_dtype_(dtype)]


def torch_dtype_name(dtype):
    return _TORCH_NAMES[dtype]


class VarTypes:
    LOD_TENSOR = "lod_tensor"


class OpRole:
    """Op role annotation (the reference's op_proto_maker.h:26-48).
    Backward and the optimizer passes key off these."""
    Forward = 0
    Backward = 1
    Optimize = 2
    LRSched = 16
    Loss = 256


OP_ROLE_KEY = "op_role"
OP_ROLE_VAR_KEY = "op_role_var"

# a gradient variable is named after its forward variable
GRAD_SUFFIX = "@GRAD"


def _grad_var_name(name):
    return name + GRAD_SUFFIX

# -- places ----------------------------------------------------------------


class Place:
    def __init__(self, device_id=0):
        self.device_id = int(device_id)

    def __repr__(self):
        return "%s(%d)" % (type(self).__name__, self.device_id)

    def __eq__(self, other):
        return type(self) is type(other) and self.device_id == other.device_id

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))


class CPUPlace(Place):
    def __init__(self):
        super().__init__(0)

    def torch_device(self):
        return "cpu"


class CUDAPlace(Place):
    def torch_device(self):
        return "cuda:%d" % self.device_id


# -- Variable --------------------------------------------------------------


class Variable:
    """A node in a Block's symbol table: static metadata only (shape may
    hold -1 for the batch dim); values live in a Scope at run time."""

    def __init__(self, block, name=None, shape=None, dtype=None, lod_level=0,
                 persistable=False, stop_gradient=False,
                 type=VarTypes.LOD_TENSOR, is_data=False,
                 need_check_feed=False, initializer=None, **kwargs):
        self.block = block
        self.name = name if name is not None else unique_name.generate(
            "_generated_var")
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = convert_np_dtype_to_dtype_(dtype) \
            if dtype is not None else None
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.type = type
        self.is_data = is_data
        self.need_check_feed = need_check_feed
        # tensor-parallel axis names of the reference; carried through the
        # IR unchanged, unused by the single-card executor
        self.sharding = kwargs.get("sharding", None)
        self.initializer = initializer

    def __repr__(self):
        return "Variable(name=%s, shape=%s, dtype=%s%s)" % (
            self.name, self.shape, self.dtype,
            ", persistable" if self.persistable else "")

    def to_dict(self):
        return {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype,
            "lod_level": self.lod_level,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "type": self.type,
            "is_data": self.is_data,
            "is_parameter": isinstance(self, Parameter),
            "trainable": getattr(self, "trainable", None),
            "sharding": list(self.sharding) if self.sharding else None,
        }


class Parameter(Variable):
    """A trainable persistable variable."""

    def __init__(self, block, shape, dtype, **kwargs):
        kwargs.setdefault("persistable", True)
        self.trainable = kwargs.pop("trainable", True)
        self.optimize_attr = kwargs.pop("optimize_attr",
                                        {"learning_rate": 1.0})
        self.regularizer = kwargs.pop("regularizer", None)
        self.gradient_clip_attr = kwargs.pop("gradient_clip_attr", None)
        self.do_model_average = kwargs.pop("do_model_average", None)
        super().__init__(block, shape=shape, dtype=dtype, **kwargs)


# -- Operator --------------------------------------------------------------


def _varname(v):
    if isinstance(v, Variable):
        return v.name
    if isinstance(v, str):
        return v
    raise TypeError("expected Variable or str, got %r" % (v,))


def _varnames(v):
    if v is None:
        return []
    if isinstance(v, (list, tuple)):
        return [_varname(x) for x in v]
    return [_varname(v)]


class Operator:
    """One op in a block: slot name -> list of variable names, plus a
    JSON-serializable attr dict."""

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs = {k: _varnames(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: _varnames(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})
        self.attrs.setdefault(OP_ROLE_KEY, _current_role())

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    @property
    def input_arg_names(self):
        return [n for names in self.inputs.values() for n in names]

    @property
    def output_arg_names(self):
        return [n for names in self.outputs.values() for n in names]

    def attr(self, name):
        return self.attrs.get(name)

    def __repr__(self):
        return "{%s: inputs=%s outputs=%s}" % (self.type, self.inputs,
                                               self.outputs)

    def to_dict(self):
        attrs = {}
        for k, v in self.attrs.items():
            if isinstance(v, np.ndarray):
                v = v.tolist()
            elif isinstance(v, np.integer):
                v = int(v)
            elif isinstance(v, np.floating):
                v = float(v)
            attrs[k] = v
        return {"type": self.type, "inputs": self.inputs,
                "outputs": self.outputs, "attrs": attrs}


# -- Block -----------------------------------------------------------------


class Block:
    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = {}
        self.ops = []

    @property
    def parent_block(self):
        return None if self.parent_idx < 0 \
            else self.program.block(self.parent_idx)

    def create_var(self, **kwargs):
        name = kwargs.get("name")
        if name is not None and name in self.vars:
            return self.vars[name]
        var = Variable(self, **kwargs)
        self.vars[var.name] = var
        return var

    def create_parameter(self, **kwargs):
        shape = kwargs.pop("shape")
        dtype = kwargs.pop("dtype")
        param = Parameter(self, shape, dtype, **kwargs)
        # parameters live in the global block's symbol table
        gblock = self.program.global_block()
        gblock.vars[param.name] = param
        if self is not gblock:
            self.vars[param.name] = param
        return param

    def var(self, name):
        v = self._find_var_recursive(name)
        if v is None:
            raise ValueError("variable %r not found in block %d"
                             % (name, self.idx))
        return v

    def has_var(self, name):
        return name in self.vars

    def has_var_recursive(self, name):
        return self._find_var_recursive(name) is not None

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def _find_var_recursive(self, name):
        blk = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = blk.parent_block
        return None

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        return self._insert_op(len(self.ops), type, inputs, outputs, attrs)

    def _insert_op(self, index, type, inputs=None, outputs=None, attrs=None):
        from .core.registry import get_op_def

        op = Operator(self, type, inputs, outputs, attrs)
        opdef = get_op_def(type)  # raises for unknown op types
        opdef.validate(op)
        self.ops.insert(index, op)
        self.program._bump_version()
        opdef.run_infer_shape(op, self)
        return op

    def to_dict(self):
        return {"idx": self.idx, "parent_idx": self.parent_idx,
                "vars": [v.to_dict() for v in self.vars.values()],
                "ops": [op.to_dict() for op in self.ops]}


# -- Program ---------------------------------------------------------------


class Program:
    """A whole model: a list of blocks, block 0 the global one."""

    _uid_counter = itertools.count()

    def __init__(self):
        # process-wide id: executor plan caches key on it, not on id(),
        # which a collected Program's successor may reuse
        self._uid = next(Program._uid_counter)
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = 0
        self._version = 0
        self._is_test = False
        # the bf16 AMP policy (contrib.mixed_precision.decorate sets it):
        # products take bf16 operands and give bf16 results; not carried
        # by clone or to_dict, as in the reference
        self._amp_bf16 = False
        # role stamped on ops appended now (backward / optimizer guards)
        self._op_role = OpRole.Forward

    def _bump_version(self):
        self._version += 1

    @property
    def version(self):
        return self._version

    def global_block(self):
        return self.blocks[0]

    def block(self, idx):
        return self.blocks[idx]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def _create_block(self, parent_idx=None):
        """A new block, a child of the current one (or of ``parent_idx``),
        made current: the sub-block of a control-flow op."""
        parent = self.current_block_idx if parent_idx is None else parent_idx
        blk = Block(self, len(self.blocks), parent)
        self.blocks.append(blk)
        self.current_block_idx = blk.idx
        self._bump_version()
        return blk

    def _rollback(self):
        """Make the current block's parent current again."""
        self.current_block_idx = self.current_block().parent_idx

    def list_vars(self):
        for blk in self.blocks:
            yield from blk.vars.values()

    # -- op role protocol ---------------------------------------------------

    @contextlib.contextmanager
    def _role_guard(self, role):
        """Ops appended inside get ``role`` (the reference's
        ``_backward_role_guard`` / ``_optimized_guard``)."""
        old, self._op_role = self._op_role, role
        try:
            yield
        finally:
            self._op_role = old

    def _lr_schedule_guard(self):
        """Ops appended inside are learning-rate schedule ops
        (``OpRole.LRSched``, the reference's ``_lr_schedule_guard``):
        backward and the optimizer fusion leave them as they are."""
        return self._role_guard(OpRole.LRSched)

    def clone(self, for_test=False):
        """Deep copy; ``for_test`` sets every op's ``is_test`` attr."""
        p = Program.from_dict(self.to_dict())
        for blk, src in zip(p.blocks, self.blocks):
            for name, v in src.vars.items():
                blk.vars[name].initializer = v.initializer
        p._is_test = for_test
        if for_test:
            for blk in p.blocks:
                for op in blk.ops:
                    if "is_test" in op.attrs or op.type == "dropout":
                        op.attrs["is_test"] = True
        p._bump_version()
        return p

    def to_dict(self):
        return {"version": 1, "random_seed": self.random_seed,
                "blocks": [b.to_dict() for b in self.blocks]}

    @staticmethod
    def from_dict(d):
        p = Program()
        p.random_seed = d.get("random_seed", 0)
        p.blocks = []
        for bd in d["blocks"]:
            blk = Block(p, bd["idx"], bd["parent_idx"])
            for vd in bd["vars"]:
                kwargs = dict(name=vd["name"],
                              lod_level=vd.get("lod_level", 0),
                              persistable=vd.get("persistable", False),
                              stop_gradient=vd.get("stop_gradient", False),
                              type=vd.get("type", VarTypes.LOD_TENSOR),
                              is_data=vd.get("is_data", False))
                if vd.get("sharding"):
                    kwargs["sharding"] = tuple(vd["sharding"])
                shape = tuple(vd["shape"]) \
                    if vd.get("shape") is not None else None
                if vd.get("is_parameter"):
                    if vd.get("trainable") is not None:
                        kwargs["trainable"] = vd["trainable"]
                    v = Parameter(blk, shape, vd["dtype"], **kwargs)
                else:
                    v = Variable(blk, shape=shape, dtype=vd["dtype"],
                                 **kwargs)
                blk.vars[v.name] = v
            for od in bd["ops"]:
                blk.ops.append(Operator(blk, od["type"], od["inputs"],
                                        od["outputs"],
                                        copy.deepcopy(od["attrs"])))
            p.blocks.append(blk)
        p._bump_version()
        return p


# -- default programs and guards -------------------------------------------
#
# Threads other than the main one may override the defaults for
# themselves; the main thread's programs stay visible to helper threads
# that never called program_guard.

_main_program = Program()
_startup_program = Program()
_prog_tls = threading.local()


def _is_main_thread():
    return threading.current_thread() is threading.main_thread()


def default_main_program():
    if not _is_main_thread() and getattr(_prog_tls, "main", None) is not None:
        return _prog_tls.main
    return _main_program


def _current_role():
    return default_main_program()._op_role


def default_startup_program():
    if not _is_main_thread() and \
            getattr(_prog_tls, "startup", None) is not None:
        return _prog_tls.startup
    return _startup_program


def switch_main_program(program):
    """Make ``program`` the default main program; returns the old one."""
    global _main_program
    if _is_main_thread():
        old, _main_program = _main_program, program
    else:
        old, _prog_tls.main = getattr(_prog_tls, "main", None), program
    return old


def switch_startup_program(program):
    """Make ``program`` the default startup program; returns the old one."""
    global _startup_program
    if _is_main_thread():
        old, _startup_program = _startup_program, program
    else:
        old, _prog_tls.startup = getattr(_prog_tls, "startup", None), program
    return old


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    old_main = switch_main_program(main_program)
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if startup_program is not None:
            switch_startup_program(old_startup)
