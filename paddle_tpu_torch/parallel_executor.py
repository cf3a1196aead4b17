"""ParallelExecutor: Fluid's legacy multi-device API (parallel_executor.py:28)
over the port's Executor and a one-card CompiledProgram.

Counterpart of ``paddle_tpu/parallel_executor.py``.  ``use_cuda`` True runs
on the card, False on the CPU.
"""

from .compiler import CompiledProgram
from .core.executor import Executor, global_scope, scope_guard
from .framework import CPUPlace, CUDAPlace, default_main_program

__all__ = ["ParallelExecutor"]


class ParallelExecutor:
    def __init__(self, use_cuda, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None,
                 build_strategy=None, num_trainers=1, trainer_id=0,
                 scope=None):
        if num_trainers != 1:
            raise NotImplementedError(
                "ParallelExecutor over %d trainers waits for the "
                "collectives (ROADMAP A8)" % num_trainers)
        self._place = CUDAPlace(0) if use_cuda else CPUPlace()
        self._main = main_program or default_main_program()
        self._scope = scope or global_scope()
        self._compiled = CompiledProgram(self._main).with_data_parallel(
            loss_name=loss_name, build_strategy=build_strategy,
            exec_strategy=exec_strategy)
        self._exe = Executor(self._place)

    def run(self, fetch_list, feed=None, feed_dict=None, return_numpy=True):
        feed = feed if feed is not None else feed_dict
        with scope_guard(self._scope):
            return self._exe.run(self._compiled, feed=feed,
                                 fetch_list=fetch_list,
                                 return_numpy=return_numpy)

    def drop_local_exe_scopes(self):
        """Nothing to drop: the scope is the caller's."""
