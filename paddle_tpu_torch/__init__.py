"""PyTorch / CUDA port of paddle_tpu for NVIDIA Hopper (H100), with the
Fluid surface: ``import paddle_tpu_torch as fluid``.

The JAX package ``paddle_tpu`` stays the reference; this package imports
``torch`` and numpy only.  Entry points run on the card unless the caller
passes ``CPUPlace()`` (or ``device="cpu"``).  Importing the package
builds no kernel and does not initialise CUDA.  Slices ported so far, in
order:

- greedy decode serving: ``serving.DecodeEngine`` over a paged KV cache,
  its attention step a CUDA kernel (``kernels/csrc/paged_attention.cu``);
- the Program front end and BERT encoder serving: ``framework``,
  ``layers``, ``core`` (op registry, Executor, Scope), ``io``,
  ``inference`` (AnalysisPredictor) and ``serving.ServingEngine``, with
  the flash attention, fused residual-add LayerNorm and LayerNorm
  kernels;
- BERT training: ``backward``, ``optimizer`` (Adam), ``ir`` (the
  optimizer fusion), with the attention backward, fused LayerNorm
  backward and fused Adam kernels;
- BERT at dropout 0.1: the Philox stream, the dropout op and kernel,
  dropout inside the fused LayerNorm kernels, the small-sequence
  attention kernels;
- ResNet-50 serving and training: the conv, pool and batch-norm ops,
  Momentum with L2 decay, the predictor's passes, the conv-block and
  fused momentum kernels;
- DLRM training over host-resident sparse tables
  (``distributed.sparse_table``), the embedding-bag kernel;
- Hopper redesigns of the flash backward, the conv core, the small
  attention, the fused LayerNorm, the conv epilogue and the fused
  momentum kernels;
- the bf16 AMP policy (``contrib.mixed_precision``);
- wire serving on the port's own RPC transport, and the serving
  fleet (telemetry, rollouts, the fleet monitor);
- tracing, fault points and the autoscaler;
- speculative decode and int8 KV;
- KV blocks between prefill and decode replicas;
- Transformer NMT training and beam decode;
- SLO tiers, the serving flags, one autoscaler per role;
- the other optimizers, EMA / ModelAverage / Lookahead, gradient
  clipping, the LR schedules and the initialisers;
- control flow: sub-blocks, While / cond / Switch / IfElse, tensor
  arrays, StaticRNN, GradientMergeOptimizer;
- the recurrent networks (GRU / LSTM layers, cells, dynamic_decode,
  contrib's basic_gru / basic_lstm);
- the Fluid surface and the data path: ``DataLoader`` / ``PyReader``
  (``reader``, a C++ queue and a double buffer on a side stream),
  ``DataFeeder``, the reader decorators and ``batch``, ``datasets``,
  ``lod_tensor``, ``CompiledProgram`` / ``ParallelExecutor`` on one
  card, ``io``'s single-card save and load, the static verifier
  (``core.analysis``), ``metrics``, ``average``, ``evaluator``,
  ``nets`` and the v2 ``one_hot`` / ``embedding``.

A name of the reference's surface the port does not have yet raises
AttributeError naming the ROADMAP item that ports it.
"""

from . import framework
from .framework import (CPUPlace, CUDAPinnedPlace, CUDAPlace, Program,
                        Variable, cpu_places, cuda_places,
                        default_main_program, default_startup_program,
                        in_dygraph_mode, is_compiled_with_cuda,
                        program_guard)
from . import core
from .core import Executor, Scope, global_scope, scope_guard
from .core import telemetry, tracing
from .device import resolve_device, set_f32_numerics
from . import flags
from .flags import get_flags, set_flags
from .compiler import BuildStrategy, CompiledProgram, ExecutionStrategy
from .param_attr import ParamAttr
from . import backward
from .backward import append_backward
from . import layers
from . import nets
from . import input
from .input import embedding, one_hot
from . import initializer
from . import optimizer
from . import regularizer
from . import clip
from . import contrib
from . import distributed
from . import lod_tensor
from .lod_tensor import (LoDTensor, create_lod_tensor,
                         create_random_int_lodtensor)
from . import average
from . import evaluator
from . import metrics
from . import parallel_executor
from .parallel_executor import ParallelExecutor
from .utils import unique_name
from . import io
from .io import (load, load_inference_model, load_program_state, save,
                 save_inference_model, set_program_state)
from . import reader
from .reader import DataLoader, PyReader
from .reader_decorator import batch
from .data_feeder import DataFeeder
from . import datasets
from . import inference
from .inference import AnalysisConfig

__all__ = [
    "framework", "Program", "Variable", "program_guard",
    "default_main_program", "default_startup_program", "CPUPlace",
    "CUDAPlace", "CUDAPinnedPlace", "cpu_places", "cuda_places",
    "in_dygraph_mode", "is_compiled_with_cuda", "core", "Executor",
    "Scope", "global_scope", "scope_guard", "telemetry", "tracing",
    "resolve_device", "set_f32_numerics", "flags", "get_flags",
    "set_flags", "BuildStrategy", "CompiledProgram", "ExecutionStrategy",
    "ParamAttr", "backward", "append_backward", "layers", "nets", "input",
    "embedding", "one_hot", "initializer", "optimizer", "regularizer",
    "clip", "contrib", "distributed", "lod_tensor", "LoDTensor",
    "create_lod_tensor", "create_random_int_lodtensor", "average",
    "evaluator", "metrics", "parallel_executor", "ParallelExecutor",
    "unique_name", "io", "save", "load", "load_program_state",
    "set_program_state", "save_inference_model", "load_inference_model",
    "reader", "DataLoader", "PyReader", "batch", "DataFeeder", "datasets",
    "inference", "AnalysisConfig", "data",
]

__version__ = "0.1.0"


def data(name, shape, dtype="float32", lod_level=0):
    """``fluid.data``: the batch dim is given explicitly (often -1)."""
    return layers.data(name=name, shape=shape, dtype=dtype,
                       lod_level=lod_level, append_batch_size=False)


# names of the reference's surface that wait for a later item
_WAITS = {
    "dygraph": "A9 (dygraph)",
    "transpiler": "A9 (sparse/PS, transpiler/)",
    "DistributeTranspiler": "A9 (sparse/PS, transpiler/)",
    "DistributeTranspilerConfig": "A9 (sparse/PS, transpiler/)",
    "distribute_lookup_table": "A9 (sparse/PS)",
    "DatasetFactory": "A9 (sparse/PS: Dataset, train_from_dataset)",
    "dataset": "A9 (sparse/PS: Dataset, train_from_dataset)",
    "DataFeedDesc": "A9 (sparse/PS: Dataset, train_from_dataset)",
    "profiler": "A9 (tooling)",
    "debugger": "A9 (tooling)",
    "install_check": "A9 (tooling)",
    "parallel": "A9 (parallel/)",
    "incubate": "A9 (contrib and incubate)",
    "gradients": "A7 (gradients() and recompute segments)",
    "WeightNormParamAttr": "A9 (the long tail)",
    "LoDTensorArray": "A9 (the long tail)",
    "name_scope": "A9 (the long tail)",
    "require_version": "A9 (tooling)",
    "load_op_library": "A9 (tooling)",
    "create_paddle_predictor": "A6 (the predictor, the rest)",
    "TPUPlace": None, "tpu_places": None, "is_compiled_with_tpu": None,
}


def __getattr__(name):
    if name in _WAITS:
        item = _WAITS[name]
        if item is None:
            raise AttributeError(
                "paddle_tpu_torch has no %s: the port runs on CUDA cards "
                "(CUDAPlace, cuda_places); the TPU names are the JAX "
                "package's" % name)
        raise AttributeError(
            "paddle_tpu_torch.%s is not ported yet: it comes with ROADMAP "
            "%s" % (name, item))
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
