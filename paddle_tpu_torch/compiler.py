"""CompiledProgram on one card.

Counterpart of ``paddle_tpu/compiler.py`` (Fluid's compiler.py:65).  The
reference runs a data-parallel CompiledProgram over a one-axis device mesh;
on one card the port's Executor unwraps the wrapper and runs the inner
program as given (its optimizer fusion and plan cache are the program's).
``places`` naming more than one card raises: data parallel over several
cards comes with the collectives (ROADMAP A8), and never runs on one card
silently.  The reference's ``_with_mesh`` is JAX's own and has no
counterpart.
"""

__all__ = ["CompiledProgram", "BuildStrategy", "ExecutionStrategy"]


class BuildStrategy:
    """Fluid's build knobs (details/build_strategy.h:58-139), kept for the
    API: the port's executor reads none of them."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = \
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.fuse_all_reduce_ops = True
        self.fuse_elewise_add_act_ops = False
        self.fuse_all_optimizer_ops = False
        self.enable_inplace = True
        self.memory_optimize = True
        self.nccl_comm_num = 1
        self.use_hierarchical_allreduce = False
        self.hierarchical_allreduce_inter_nranks = 0
        self.enable_sequential_execution = False
        self.remove_unnecessary_lock = True
        self.sync_batch_norm = False
        self.num_trainers = 1
        self.trainer_id = 0


class ExecutionStrategy:
    def __init__(self):
        self.num_threads = 0
        self.num_iteration_per_drop_scope = 1
        self.use_experimental_executor = False


def _check_one_card(places):
    if places is None:
        return
    seq = places if isinstance(places, (list, tuple)) else [places]
    if len(seq) > 1:
        raise NotImplementedError(
            "with_data_parallel over %d places: data parallel over several "
            "cards comes with the collectives (ROADMAP A8); on one card "
            "pass one place or none" % len(seq))


class CompiledProgram:
    def __init__(self, program_or_graph, build_strategy=None):
        self._program = program_or_graph
        self._build_strategy = build_strategy or BuildStrategy()
        self._loss_name = None

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None):
        _check_one_card(places)
        self._loss_name = loss_name
        if build_strategy is not None:
            self._build_strategy = build_strategy
        return self

    def with_inference_optimize(self, config):
        return self
