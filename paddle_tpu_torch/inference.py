"""Inference predictor: AnalysisConfig + AnalysisPredictor.

Counterpart of ``paddle_tpu/inference.py``: load a
``save_inference_model`` directory into a private Scope and run it with
an Executor, through the PaddleTensor or the zero-copy API.  Clones share
the program, the scope and the executor.  The predictor runs on the CUDA
card unless ``disable_gpu()`` is called.  Under ``ir_optim()`` (on by
default, as in the reference) the loaded program goes through the
reference's pass pipeline, ``ir.INFERENCE_PASSES`` in its order: dropout
deletion, the conv + batch-norm fold, fc fusion and the add + activation
fusion rewrite it (a ResNet's convs lose their batch norms, its
residual add + relu pairs and the fc become fused ops); the passes the
port does not carry raise where they would rewrite.
"""

import numpy as np

from . import io as _io
from . import ir
from .core.executor import Executor, scope_guard
from .core.scope import Scope
from .framework import CPUPlace, CUDAPlace

__all__ = ["AnalysisConfig", "PaddleTensor", "ZeroCopyTensor",
           "AnalysisPredictor"]


class AnalysisConfig:
    """The model directory and the device of a predictor (the reference's
    AnalysisConfig for a ``save_inference_model`` directory; its
    two-file form is not ported yet)."""

    def __init__(self, model_dir=None):
        self._model_dir = model_dir
        self._use_gpu = True
        self._device_id = 0
        self._ir_optim = True

    def set_model(self, model_dir):
        self._model_dir = model_dir

    def model_dir(self):
        return self._model_dir

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._use_gpu = True
        self._device_id = int(device_id)

    def disable_gpu(self):
        self._use_gpu = False

    def use_gpu(self):
        return self._use_gpu

    def gpu_device_id(self):
        return self._device_id

    def switch_ir_optim(self, x=True):
        self._ir_optim = bool(x)

    def ir_optim(self):
        return self._ir_optim

    def place(self):
        return CUDAPlace(self._device_id) if self._use_gpu else CPUPlace()


class PaddleTensor:
    """A named ndarray (paddle_api.h PaddleTensor)."""

    def __init__(self, data=None, name=""):
        self.name = name
        self.data = np.asarray(data) if data is not None else None
        self.shape = tuple(self.data.shape) if data is not None else ()
        self.lod = []

    def as_ndarray(self):
        return self.data


class ZeroCopyTensor:
    """Handle on one feed or fetch slot: copy_from_cpu stages the next
    input, copy_to_cpu reads the last output."""

    def __init__(self, predictor, name, is_input):
        self._pred = predictor
        self._name = name
        self._is_input = is_input

    def name(self):
        return self._name

    def copy_from_cpu(self, arr):
        if not self._is_input:
            raise RuntimeError("copy_from_cpu on an output tensor")
        self._pred._staged_feed[self._name] = np.asarray(arr)

    def reshape(self, shape):
        pass  # the shape comes from the staged array

    def copy_to_cpu(self):
        if self._is_input:
            raise RuntimeError("copy_to_cpu on an input tensor")
        if self._pred._last_outputs is None:
            raise RuntimeError("run the predictor before copy_to_cpu")
        return self._pred._last_outputs[self._name]


class AnalysisPredictor:
    def __init__(self, config, _shared=None):
        self._config = config
        if _shared is not None:
            (self._program, self._feed_names, self._fetch_vars, self._scope,
             self._exe) = _shared
        else:
            if config.model_dir() is None:
                raise ValueError("AnalysisConfig: set_model(dir) is required")
            self._exe = Executor(config.place())
            self._scope = Scope()
            with scope_guard(self._scope):
                self._program, self._feed_names, self._fetch_vars = \
                    _io.load_inference_model(config.model_dir(), self._exe)
            if config.ir_optim():
                # feeds and fetch targets stay produced (fetch ops are not
                # in a loaded program, so a fetched var has no reader)
                protected = set(self._feed_names) | {
                    v.name for v in self._fetch_vars}
                for name in ir.INFERENCE_PASSES:
                    ir.apply_pass(name, self._program, self._scope,
                                  protected=protected)
        self._fetch_names = [v.name for v in self._fetch_vars]
        self._staged_feed = {}
        self._last_outputs = None

    @property
    def device(self):
        return self._exe.device

    def run(self, inputs):
        """inputs: list of PaddleTensor in get_input_names() order (or
        named) -> list of PaddleTensor."""
        feed = {t.name or self._feed_names[i]: t.data
                for i, t in enumerate(inputs)}
        outs = self.run_feed(feed)
        return [PaddleTensor(outs[n], name=n) for n in self._fetch_names]

    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return list(self._fetch_names)

    def get_input_tensor(self, name):
        if name not in self._feed_names:
            raise KeyError(name)
        return ZeroCopyTensor(self, name, True)

    def get_output_tensor(self, name):
        if name not in self._fetch_names:
            raise KeyError(name)
        return ZeroCopyTensor(self, name, False)

    def zero_copy_run(self):
        missing = [n for n in self._feed_names if n not in self._staged_feed]
        if missing:
            raise RuntimeError("inputs not staged: %s" % missing)
        self._last_outputs = self.run_feed(dict(self._staged_feed))

    def run_feed(self, feed):
        """{feed name: ndarray} -> {fetch name: ndarray}."""
        vals = self._exe.run(self._program, feed=feed,
                             fetch_list=self._fetch_vars, scope=self._scope)
        return dict(zip(self._fetch_names, vals))

    def warmup(self, feed_specs):
        """One run on zero feeds of ``{name: (shape, dtype)}``, which
        builds the kernels before traffic; returns the Executor's
        ``{"source", "compile_ms", "key"}``."""
        return self._exe.warmup(self._program, feed_specs=feed_specs,
                                fetch_list=self._fetch_vars,
                                scope=self._scope)

    def clone(self):
        return AnalysisPredictor(
            self._config, _shared=(self._program, self._feed_names,
                                   self._fetch_vars, self._scope, self._exe))

    def program(self):
        return self._program

