"""Parallelism over a multi-process mesh (counterpart of
``veles_tpu/parallel/``): the runtime and its collectives
(:mod:`.distributed`), the placement rules of the ``data``,
``sequence``, ``fsdp``, ``tensor`` and ``expert`` axes with the blocks
and Megatron's operators (:mod:`.sharding`), the GPipe schedule of the
``pipeline`` axis with its planners (:mod:`.pipeline`), and the
long-context attention schemes over the ``sequence`` axis, ring
(:mod:`.ring_attention`) and Ulysses (:mod:`.ulysses`), and the trial
scheduler that farms trials out to subprocesses placed on disjoint cards
(:mod:`.trials`)."""

from .distributed import (initialize_multihost, is_coordinator,
                          process_count)                  # noqa: F401
from .pipeline import (gpipe, gpipe_hetero, microbatch, plan_pipeline,
                       plan_pipeline_hetero, unmicrobatch)  # noqa: F401
from .sharding import batch_sharding, replicated          # noqa: F401
from . import trials                                      # noqa: F401
from .trials import (Trial, TrialResult, TrialScheduler,  # noqa: F401
                     cpu_placement, mesh_slice_placement)


def __getattr__(name):
    # the attention schemes import the nn package, which imports this
    # one: load them on first use
    if name == "ring_attention":
        from .ring_attention import ring_attention
        return ring_attention
    if name == "ulysses_attention":
        from .ulysses import ulysses_attention
        return ulysses_attention
    raise AttributeError(name)
